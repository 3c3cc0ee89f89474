#!/usr/bin/env python3
"""Where a main-path tick of the PyTorch port spends its time, on one card.

    python3 tools/profile_main_path.py [--ticks 6]
        [--path per_channel|fused|serve|enriched|train]

Runs one of ``chip_smoke.py``'s main paths (same engine, channels and
subscription counts): the per-channel ``execute_channel`` tick or the fused
``execute_all`` + ``drain_spilled`` tick, for a few ticks; its serve
phase (``launch/serve.py::serve``, qwen2-1.5b at full width, at
``chip_smoke.SERVE``'s shape); or one ``LMScorer.score`` call of its
enriched tick (qwen2-1.5b at full width on one join group's 16,384 slots
of 10 record fields); or one train step of its phase 11 (tinyllama-1.1b
at full width and depth, ``chip_smoke.TRAIN``'s batch, 8 microbatches),
under ``torch.profiler``, and prints the operators
that take the most device time and the most host time, and the device's
busy share of the profiled wall time (the sum of kernel times over the wall
clock; overlapping kernels would count twice, and the port launches on one
stream). The trace goes to ``chiprun_out/<path>_trace.json``, except a
train step's, whose hundreds of thousands of events are left out.
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
    ap.add_argument("--path", choices=("per_channel", "fused", "serve",
                                       "enriched", "train"),
                    default="per_channel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_main_path: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    if args.path == "serve":
        run, what = serve_runner(dev), "one serve call"
    elif args.path == "enriched":
        run, what = score_runner(dev), "one LMScorer.score call"
    elif args.path == "train":
        run, what = train_runner(dev), "one train step"
    else:
        path = (chip_smoke.main_path if args.path == "per_channel"
                else chip_smoke.fused_path)
        cfg = dict(chip_smoke.MAIN, ticks=args.ticks, spatial_check_ticks=())
        path(dev, dict(cfg, ticks=2))                       # warm-up run
        what = f"{args.ticks} {args.path} ticks"

        def run() -> str:
            mp = path(dev, cfg)
            return (f"timed ticks {mp['tick_ms_mean'] * args.ticks:.1f} ms; "
                    f"per tick (ms): ingest {mp['ingest_ms_mean']:.2f}, "
                    f"execute {json.dumps(mp['exec_ms_mean'])}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        summary = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel and copy rows only: operator rows repeat their kernels' time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    print(f"profiled {what}: wall {wall * 1e3:.1f} ms, device busy "
          f"{device_us / 1e3:.1f} ms = {100 * device_us / 1e6 / wall:.1f}% "
          f"of wall")
    print(summary)
    print("device time by kernel (ms, share of the device total, launches):")
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} "
              f"{100 * e.self_device_time_total / max(device_us, 1):5.1f}% "
              f"x{e.count:<6d} {e.key[:110]}")
    print(events.table(sort_by="self_device_time_total", row_limit=20,
                       max_name_column_width=60))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15,
                       max_name_column_width=60))
    if args.path != "train":
        out = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out,
                                              f"{args.path}_trace.json"))
    return 0


def serve_runner(dev):
    """One ``serve`` call at ``chip_smoke.SERVE``'s shape on qwen2-1.5b's
    seeded weights, after a warm-up call; returns its timing line."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import ModelApi
    cfg = configs.get_config("qwen2-1.5b")
    params = ModelApi(cfg).init(torch.Generator(dev).manual_seed(0))
    b, p, g = (chip_smoke.SERVE[k] for k in ("batch", "prompt_len", "gen"))
    serve(cfg, b, p, 3, device=dev, params=params)          # warm-up call

    def run() -> str:
        _, t_pre, t_dec = serve(cfg, b, p, g, device=dev, params=params)
        return (f"batch {b}, prompt {p}, {g} tokens: prefill "
                f"{t_pre * 1e3:.2f} ms, decode {t_dec / (g - 1) * 1e3:.3f} "
                f"ms/token")

    return run


def score_runner(dev):
    """One ``LMScorer.score`` call as the enriched tick makes it: qwen2-1.5b
    at full width (seeded weights, budget ``chip_smoke.ENRICH_BUDGET``) over
    one join group's ``max_candidates`` slots, each prompt a synthetic
    tweet's 10 record fields; after a warm-up call. Returns its timing
    line."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import enrich
    from repro_torch.data import synthetic as syn
    cfg = configs.get_config("qwen2-1.5b")
    stage = enrich.LMScorer(cfg=cfg, budget=chip_smoke.ENRICH_BUDGET,
                            seed=chip_smoke.SEED, device=dev)
    slots = chip_smoke.MAIN["max_candidates"]
    fields, _ = syn.tweet_arrays(np.random.default_rng(chip_smoke.SEED),
                                 slots, t0=1)
    toks = torch.as_tensor(fields, device=dev)
    ids = torch.zeros((slots,), dtype=torch.int32, device=dev)
    stage.score(toks, ids, ids)                            # warm-up call

    def run() -> str:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scores = stage.score(toks, ids, ids)
        end.record()
        torch.cuda.synchronize()
        assert scores.shape == (slots,) and bool(torch.isfinite(scores).all())
        return (f"{slots} slots x {toks.shape[1]} tokens: score "
                f"{start.elapsed_time(end):.1f} ms (CUDA events)")

    return run


def train_runner(dev):
    """One train step as phase 11 runs it (``build_train_step`` with the
    config's optimizer and accum, seeded weights, ``TokenStream`` batch 0),
    after a warm-up step; returns its timing line."""
    from repro_torch import configs
    from repro_torch.launch.steps import build_train_step, default_optimizer
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.model import ModelApi
    cfg = configs.get_config(chip_smoke.TRAIN_ARCH)
    api = ModelApi(cfg)
    params = api.init(torch.Generator(dev).manual_seed(chip_smoke.SEED))
    opt = default_optimizer(cfg)
    state = opt.init(params)
    b, s = chip_smoke.TRAIN["batch"], chip_smoke.TRAIN["seq"]
    accum = min(cfg.grad_accum, b)
    step = build_train_step(api, opt, accum=accum)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_batch_fn(cfg, b, s)(0).items()}
    step(params, state, batch)                             # warm-up step

    def run() -> str:
        t = time.perf_counter()
        _, _, metrics = step(params, state, batch)
        loss = float(metrics["loss"])
        return (f"{cfg.name}, batch {b} x {s}, accum {accum}: step "
                f"{(time.perf_counter() - t) * 1e3:.1f} ms, loss {loss:.4f}")

    return run


if __name__ == "__main__":
    sys.exit(main())
