"""Run the full dry-run matrix: 10 archs x 4 shapes x {single-pod,
multi-pod}, as the reference's ``launch/dryrun_all.py``.

Each cell runs ``python -m repro_torch.launch.dryrun`` in a fresh
subprocess, on the ``meta`` device (no card needed). Resumable: existing
JSON results are skipped unless --force.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--mesh both|pod|multipod]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ARCHS = [
    "xlstm-125m", "tinyllama-1.1b", "qwen2-1.5b", "zamba2-2.7b",
    "seamless-m4t-medium", "qwen2-7b", "pixtral-12b",
    "phi3.5-moe-42b-a6.6b", "dbrx-132b", "llama3-405b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--mesh", default="both",
                    choices=["both", "pod", "multipod"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    meshes = {"both": [False, True], "pod": [False],
              "multipod": [True]}[args.mesh]
    cells = [(a, s, m) for a in args.archs.split(",")
             for s in args.shapes.split(",") for m in meshes]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path_env = os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                               if p)
    t_start = time.time()
    failures = []
    for i, (arch, shape, multi) in enumerate(cells):
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}.json")
        if os.path.exists(path) and not args.force:
            print(f"[{i+1}/{len(cells)}] skip (exists): {arch} {shape} "
                  f"{mesh_name}")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if multi:
            cmd.append("--multi-pod")
        print(f"[{i+1}/{len(cells)}] {arch} {shape} {mesh_name} ...",
              flush=True)
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout,
                               env={**os.environ, "PYTHONPATH": path_env})
            sys.stdout.write(r.stdout)
            if r.returncode != 0:
                failures.append((arch, shape, mesh_name))
                print(f"  FAILED rc={r.returncode}\n{r.stderr[-3000:]}")
        except subprocess.TimeoutExpired:
            failures.append((arch, shape, mesh_name))
            print("  TIMEOUT")
        print(f"  cell wall: {time.time()-t0:.0f}s "
              f"(total {time.time()-t_start:.0f}s)", flush=True)
    print(f"done; {len(failures)} failures: {failures}")


if __name__ == "__main__":
    main()
