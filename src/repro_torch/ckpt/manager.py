"""Checkpoint manager: atomic, async, keep-N, restore onto a device or a
mesh (the reference's ``ckpt/manager.py`` on torch tensors).

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` a leaf of the tree and a
``manifest.json``, the reference's layout. A leaf's file is named by its
path (dict keys, list indices, NamedTuple fields) joined by dots, which is
unique and stable for a given tree structure. Writes go to ``step_<N>.tmp``
and are published by an atomic rename, so a failure mid-save never corrupts
the latest checkpoint.

What differs from the reference:

- ``save`` copies every leaf to host memory before it returns, even a CPU
  tensor, whose ``numpy()`` would share memory: the port's optimizers
  update the parameters and state in place, and the next step must not
  change a snapshot that the writer thread is still writing.
- numpy has no bfloat16 without JAX's ``ml_dtypes``, so a bf16 leaf is
  stored as its int16 bits with ``"bfloat16"`` in the manifest, and
  restored bit for bit.
- ``restore(step, like, device)`` places the tree on ``device`` (or each
  leaf on its ``like`` leaf's device). ``restore(step, like,
  shardings=tree)`` is the reference's elastic restore onto another mesh:
  each leaf is cut into its ``partition.NamedSharding``'s blocks on their
  positions' devices (``partition.device_put``), a ``ShardedTensor`` whose
  ``gather()`` gives the saved leaf back bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.distributed.partition import device_put

MANIFEST = "manifest.json"


def leaf_names(tree) -> List[str]:
    """The file name of each leaf, in order: its path joined by dots
    (``"root"`` for a bare tensor). Raises if two leaves share a name."""
    names = [".".join(str(k) for k in path).replace("/", "_") or "root"
             for path, _ in tr.leaves_with_path(tree)]
    if len(set(names)) != len(names):
        raise ValueError("two leaves of the tree share a checkpoint name")
    return names


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` in host memory (bf16 as its int16 bits)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: Optional[bool] = None) -> str:
        """Snapshot to host memory synchronously (a copy), write to disk
        (async by default), atomic-rename, prune old steps."""
        names = leaf_names(tree)
        leaves = tr.leaves(tree)
        host = [(name, _to_host(t), str(t.dtype).split(".")[-1])
                for name, t in zip(names, leaves)]
        blocking = not self.async_save if blocking is None else blocking
        self.wait()
        if blocking:
            return self._write(step, host)
        self._thread = threading.Thread(target=self._write_in_thread,
                                        args=(step, host), daemon=True)
        self._thread.start()
        return self._final_path(step)

    def _final_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write_in_thread(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except Exception as e:          # re-raised by wait()
            self._error = e

    def _write(self, step: int, host) -> str:
        final = self._final_path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for name, arr, dtype in host:
            np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest["leaves"].append(
                {"name": name, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._prune()
        return final

    def wait(self) -> None:
        """Join the writer thread; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._final_path(s), ignore_errors=True)

    # ------------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, device=None,
                shardings: Any = None) -> Any:
        """A tree structured like ``like`` from step ``step``: each leaf's
        shape checked against ``like``'s, cast to its dtype and placed on
        ``device`` (or on the ``like`` leaf's device); with ``shardings``
        (a ``NamedSharding`` a leaf), cut into blocks on the mesh."""
        if shardings is not None and device is not None:
            raise ValueError("restore takes a device or shardings, not both")
        self.wait()
        path = self._final_path(step)
        with open(os.path.join(path, MANIFEST)) as f:
            dtypes = {e["name"]: e["dtype"] for e in json.load(f)["leaves"]}
        names, refs = leaf_names(like), tr.leaves(like)
        places = ([None] * len(refs) if shardings is None
                  else tr.leaves(shardings))
        if len(places) != len(refs):
            raise ValueError("shardings and like differ in their leaves")
        out = []
        for name, ref, place in zip(names, refs, places):
            t = torch.from_numpy(np.load(os.path.join(path, name + ".npy")))
            if dtypes[name] == "bfloat16":
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(t.shape)} vs {tuple(ref.shape)}")
            t = t.to(dtype=ref.dtype)
            if place is not None:       # blocks on the mesh, leaf by leaf
                t = device_put(t, place)
            else:
                t = t.to(device if device is not None else ref.device)
            out.append(t)
        return tr.unflatten(like, out)
