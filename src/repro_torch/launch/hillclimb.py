"""Hillclimb runner: rerun a dry-run cell with config overrides and record
the variant next to its baseline, as the reference's
``launch/hillclimb.py``; on the ``meta`` device (``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch dbrx-132b \\
      --shape decode_32k --variant ws+carry \\
      --set weight_stationary_decode=True decode_loop=carry
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import run_cell

_TYPES = {"True": True, "False": False}


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v in _TYPES:
        return k, _TYPES[v]
    try:
        return k, int(v)
    except ValueError:
        pass
    try:
        return k, float(v)
    except ValueError:
        return k, v


def _fmt(value, spec: str) -> str:
    return "null" if value is None else format(value, spec)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--out", default="experiments/hillclimb")
    args = ap.parse_args()
    overrides = dict(parse_override(kv) for kv in args.set)
    os.makedirs(args.out, exist_ok=True)
    res = run_cell(args.arch, args.shape, args.multi_pod, overrides=overrides)
    name = f"{args.arch}__{args.shape}__{res['mesh']}__{args.variant}.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(res, f, indent=2)
    if res["status"] != "ok":
        print(f"{args.arch} x {args.shape} [{args.variant}]: SKIPPED "
              f"({res['skip_reason']})")
        return
    mem = res["full"]["memory"]
    t = res["totals"]
    # the fields without a counterpart (null, see ``substitute``) are not
    # printed
    shown = {"args": _fmt(mem["argument_bytes"] / 2**30, ".2f") + " GiB",
             "flops/dev": _fmt(t["flops"], ".3e"),
             "flops": _fmt(t["flops_global"], ".3e")}
    for key, value in (("peak", mem["peak_estimate_bytes"]),
                       ("bytes/dev", t["bytes"]),
                       ("coll/dev", t["collective_bytes"])):
        if value is not None:
            shown[key] = _fmt(value, ".3e")
    print(f"{args.arch} x {args.shape} [{args.variant}]: " +
          " ".join(f"{k}={v}" for k, v in shown.items()))


if __name__ == "__main__":
    main()
