#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA BAD engine (``repro_torch``).

    python3 bad_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on this machine's first card: builds
the cell's engine from its configuration (``bad_bench/configs/``),
pre-loads the ring, warms up on the cell's own traffic
(``bad_bench/cells/``), runs ticks back to back for ``--seconds``, then
judges every tick against the plain reference (``bad_bench/reference/``).
With ``--trace 0`` the last line of standard output is a JSON object with
the cell's end-to-end metrics; with ``--trace 1`` each layer's span ends
in a device synchronisation, a few more ticks run under
``torch.profiler``, and the line holds the cell's per-layer metrics (one
reader a metric, ``bad_bench/metrics/``), the device's busy time and a
breakdown. On standard error a ``ticks:`` line says how the window's time
divided (tick p50, p90, p99 and maximum, the ticks over twice the median
by quarter of the window, the seconds outside ticks); the numbers compared
and their limits are the last lines there and the last key of the line.
A configuration with an ``enrichment`` block is a scored deployment: the
program's ``LMScorer`` ranks each plan-group's candidates under a budget
(``bad_bench/enrichment.py``), its pruned pairs count as the budget's and
not as failures, and a ``scores:`` line says how the sampled scores lay
against the plain scorer's. A reader that declares ``PROGRAM_SPANS``
turns the program's own tracer on for the profiled ticks.
Exits 2 without a CUDA card (or with fewer than the cell asks for) and 3
when the program loaded JAX or the JAX package, printing no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT      # import the harness as bad_bench.*, never bare
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(root: str, workload: str):
    """The cell's ``BENCHMARK.json`` entry, cell file and configuration."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    with open(os.path.join(root, "bad_bench", "cells",
                           f"{workload}.json")) as fh:
        cell = json.load(fh)
    with open(os.path.join(root, "bad_bench", "configs",
                           f"{entry['config']}.json")) as fh:
        cfg = json.load(fh)
    if cell["config"] != entry["config"]:
        raise ValueError(f"{workload}: cell names {cell['config']}, "
                         f"BENCHMARK.json {entry['config']}")
    return bench, entry, cell, cfg


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def end_to_end(run, bench, workload: str) -> dict:
    """The cell's end-to-end metrics, by the host clock."""
    import numpy as np
    w = run.window
    done = [t for t in w if t.error is None]
    secs = run.window_s
    sids = sum(st[3] for t in done for *_, st in t.reports.values()) \
        + sum(st[3] for t in done for st in t.drained.values())
    values = {
        "tweets_per_s": sum(t.tweets for t in done) / secs,
        "notifications_per_s": sids / secs,
        "tick_ms_p90": 1e3 * float(np.percentile([t.wall_s for t in w], 90)),
        "notify_ms_p50": 1e3 * float(np.median([t.notify_s for t in w])),
        "setup_s": run.setup_s,
    }
    out = {}
    for m in bench["end_to_end"]:
        if workload in m.get("workloads", [workload]):
            out[m["name"]] = {"value": values[base_name(m["name"])],
                              "unit": m["unit"]}
    return out


def diagnosis(run) -> dict:
    """The window's ticks at a glance: the p50, p90, p99 and maximum of
    their wall times (ms), how many took over twice the median and in
    which quarter of the window they started, and the seconds of the
    window outside every tick (the harness's own work between ticks)."""
    import numpy as np
    w = run.window
    ms = 1e3 * np.array([t.wall_s for t in w])
    p50, p90, p99 = (float(v) for v in np.percentile(ms, [50, 90, 99]))
    at = np.array([(t.start_s - run.window_t0) / run.window_s
                   for t, m in zip(w, ms) if m > 2 * p50])
    quarters = np.bincount(np.clip((4 * at).astype(int), 0, 3),
                           minlength=4)
    return {"p50_ms": p50, "p90_ms": p90, "p99_ms": p99,
            "max_ms": float(ms.max()), "slow": len(at),
            "slow_by_quarter": [int(q) for q in quarters],
            "outside_s": run.window_s - float(sum(t.wall_s for t in w))}


def diagnosis_line(d: dict, window_s: float) -> str:
    return (f"ticks: p50 {d['p50_ms']:.3f} ms, p90 {d['p90_ms']:.3f} ms, "
            f"p99 {d['p99_ms']:.3f} ms, max {d['max_ms']:.3f} ms; "
            f"{d['slow']} over twice the median (by quarter of the window "
            f"{', '.join(map(str, d['slow_by_quarter']))}); "
            f"{d['outside_s']:.6f} s of the window's {window_s:.6f} s "
            f"outside ticks")


def base_name(name: str) -> str:
    """A metric named ``<metric>.<group>`` is ``<metric>`` measured in a
    group of cells with a bound of its own: read the same way."""
    return name.split(".")[0]


def readers(bench, workload: str) -> list:
    """(metric entry, reader module) of each per-layer metric of the
    cell."""
    return [(m, importlib.import_module(
        f"bad_bench.metrics.{base_name(m['name'])}"))
        for m in bench["per_layer"]
        if workload in m.get("workloads", [workload])]


def per_layer(run, bench, workload: str) -> dict:
    out = {}
    for m, reader in readers(bench, workload):
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def card(dev) -> dict:
    import torch
    limit = None
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "power_limit_w": limit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, entry, cell, cfg = load(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"bad_bench: the cell needs {entry['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return measure(bench, cell, cfg, args, dev)


def measure(bench, cell, cfg, args, dev) -> int:
    """One run on ``dev``; prints the result line. The tests call it on
    the CPU."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from bad_bench import check, profiling, system
    from bad_bench.reference import reference

    torch.set_num_threads(min(4, torch.get_num_threads()))
    # a reader that declares PROGRAM_SPANS reads the program's own spans
    spans = bool(args.trace) and any(
        getattr(r, "PROGRAM_SPANS", False)
        for _, r in readers(bench, args.workload))
    run = system.run(cfg, cell, args.seed, args.seconds, bool(args.trace),
                     dev, T_START, profile_fn=profiling.profile,
                     program_spans=spans)
    found = forbidden_modules()
    if found:
        print(f"bad_bench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    want = reference.expected(cfg, cell, args.seed, len(run.ticks),
                              set(run.sampled), dev)
    scores = (reference.plain_scores(cfg, cell, args.seed, want, dev)
              if cfg.get("enrichment") else None)
    numbers = check.compare(run, want, cfg, dev, scores)
    ok = check.correct(numbers)
    # a budget's pruned pairs (ranked_*, inside dropped_*) are no failure
    failed = sum(1 for t in run.window
                 if t.error is not None or any(
                     st[2] - st[8] or st[5] - st[9]
                     for *_, st in t.reports.values()))
    device = card(dev) if dev.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 0}
    device["memory_peak_bytes"] = run.memory_peak_bytes
    result = {"correct": ok, "attempted": len(run.window), "failed": failed}
    if args.trace:
        result["metrics"] = per_layer(run, bench, args.workload)
        p = run.profile or {}
        device["busy_s"] = p.get("busy_s", 0.0)
        device["window_s"] = p.get("wall_s", 0.0)
        ops = sorted(p.get("by_name", {}).items(), key=lambda kv: -kv[1])
        gaps = sorted(p.get("gaps", {}).items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
    else:
        result["metrics"] = end_to_end(run, bench, args.workload)
    result["device"] = device
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    print(f"window: {len(run.window)} ticks in {run.window_s:.6f} s, "
          f"{sum(t.tweets for t in run.window)} tweets, "
          f"{system.mutations(run.window)} mutations", file=sys.stderr)
    print(diagnosis_line(diagnosis(run), run.window_s), file=sys.stderr)
    print("setup seconds by part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()), file=sys.stderr)
    if scores is not None:
        tol = cfg["enrichment"]["tolerance"]
        e = check.score_errors(run, scores, tol)
        print(f"scores: {e['per_tick']:.0f} slots scored a sampled tick; "
              f"{e['slots']} of the sampled ticks' slots hold a pair, "
              f"against the plain scorer: largest error "
              f"{e['largest_error']:.6g}, largest "
              f"share of its tolerance (atol {tol['atol']}, rtol "
              f"{tol['rtol']}) {e['largest_share']:.6g}", file=sys.stderr)
    for line in check.lines_for_stderr(numbers):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
