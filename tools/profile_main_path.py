#!/usr/bin/env python3
"""Where a main-path tick of the PyTorch port spends its time, on one card.

    python3 tools/profile_main_path.py [--ticks 6] [--path per_channel|fused]

Runs one of ``chip_smoke.py``'s main paths (same engine, channels and
subscription counts): the per-channel ``execute_channel`` tick or the fused
``execute_all`` + ``drain_spilled`` tick, for a few ticks under
``torch.profiler``, and prints the operators
that take the most device time and the most host time, and the device's
busy share of the profiled wall time (the sum of kernel times over the wall
clock; overlapping kernels would count twice, and the port launches on one
stream). The trace goes to ``chiprun_out/<path>_trace.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--path", choices=("per_channel", "fused"),
                    default="per_channel")
    args = ap.parse_args()
    run = (chip_smoke.main_path if args.path == "per_channel"
           else chip_smoke.fused_path)
    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    cfg = dict(chip_smoke.MAIN, ticks=args.ticks, spatial_check_ticks=())
    run(dev, dict(cfg, ticks=2))                           # warm-up run
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mp = run(dev, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel and copy rows only: operator rows repeat their kernels' time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    print(f"profiled {args.ticks} {args.path} ticks: wall {wall * 1e3:.1f} ms "
          f"(timed ticks {mp['tick_ms_mean'] * args.ticks:.1f} ms), "
          f"device busy {device_us / 1e3:.1f} ms = "
          f"{100 * device_us / 1e6 / wall:.1f}% of wall")
    print(f"per tick (ms): ingest {mp['ingest_ms_mean']:.2f}, execute "
          f"{json.dumps(mp['exec_ms_mean'])}")
    print(events.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=60))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, f"{args.path}_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
