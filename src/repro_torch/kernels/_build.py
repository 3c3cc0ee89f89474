"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) into one shared
library with a plain C interface, at first use. Each source compiles in its
own nvcc process, all started together, then one nvcc links the objects.
The library lands in ``build/repro_torch/`` at the repository root under a
name that hashes the sources and flags, so a stale build is never loaded.
A failed build raises with nvcc's output; nothing is downloaded.

Each exported launcher returns the ``cudaError_t`` of its launch (0 is
success); ``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
# nvcc's output of the build that produced the library (ptxas -v lines
# included), kept beside it as <library>.log
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ on a machine with the CUDA toolkit")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands concurrently; raise with every output on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, o) for c, o, p in zip(cmds, outs, procs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"$ {' '.join(c)}\n{o}" for c, o in failed))
    return "".join(outs)


def build() -> Path:
    """Compile csrc/*.cu into the hashed shared library (no-op if present)."""
    global build_log
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        build_log = log_path.read_text() if log_path.exists() else ""
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                        for s, o in zip(_sources(), objs)])
        staged = Path(tmp) / out.name
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
                          *map(str, objs)]])
        log_path.write_text(log)
        os.replace(staged, out)     # atomic: a half-written .so is never seen
    build_log = log
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.predicate_filter_launch.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.predicate_filter_launch.restype = i
        lib.spatial_match_launch.argtypes = [p, p, p, i, i, f, p]
        lib.spatial_match_launch.restype = i
        lib.predicate_filter_rows_launch.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.predicate_filter_rows_launch.restype = i
        lib.spatial_match_stacked_launch.argtypes = [p, p, p, p, i, i, i, p]
        lib.spatial_match_stacked_launch.restype = i
        lib.join_compact_launch.argtypes = [p] * 10 + [i, i, i, i, i, p]
        lib.join_compact_launch.restype = i
        lib.flash_attention_launch.argtypes = [p] * 4 + [i] * 7 + [f, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_decode_launch.argtypes = [p] * 7 + [i] * 6 + [f, i, i, p]
        lib.flash_decode_launch.restype = i
        lib.flash_decode_clusters.argtypes = [i, i, i, i, p]
        lib.flash_decode_clusters.restype = i
        lib.flash_decode_block.argtypes = [i, i, i, p, p]
        lib.flash_decode_block.restype = i
        lib.flash_attention_block.argtypes = [i, i, i, i, i, i, i, p, p, p]
        lib.flash_attention_block.restype = i
        lib.deliver_launch.argtypes = [p, p]
        lib.deliver_launch.restype = i
        lib.launch_floor_launch.argtypes = [ctypes.c_longlong, i, i, i, p]
        lib.launch_floor_launch.restype = i
        _lib = lib
    return _lib


def larger(shape: Optional[tuple], new: tuple) -> tuple:
    """The larger of two launch shapes by element count (``shape`` may be
    None): what a wrapper keeps beside its launch count."""
    return (new if shape is None or math.prod(new) > math.prod(shape)
            else shape)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {code}")
