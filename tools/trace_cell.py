#!/usr/bin/env python3
"""One benchmark cell with the program's tracer on, split by program span.

    python3 tools/trace_cell.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds 45] [--tracer 1 0] [--out chiprun_out/trace_cell.jsonl]

Runs ``bad_bench``'s traced run of the cell (each benchmark span ends in a
device synchronisation; then a few ticks under ``torch.profiler``) once for
each seed and each ``--tracer`` setting, in that order: with 1,
``repro_torch.core.trace`` is on whenever the benchmark's spans are, so
the window and the profiled ticks carry the engine's own spans; with 0 it
stays off. Each run is judged against the plain reference, as the
benchmark judges it, and gives one JSON line (printed, and appended to
``--out``):

- ``window``: the window's ticks, ``tick_ms_p90`` and ``notify_ms_p90``
  (host clock, as the benchmark computes them), and from the program's
  records a tick: ``host_read_ms`` (time in ``read.*`` spans: the host
  blocked on the device), ``host_reads_per_tick``, ``patch_ms``,
  ``rebuilds_per_tick``, ``remove_ms``, the reads by name and their bytes,
  and every span's inclusive ms;
- ``device``: over the profiled ticks, ``discover_device_ms``,
  ``join_device_ms``, ``deliver_device_ms`` (device time billed to the
  span), the device seconds billed to each span name, the unbilled rest,
  the share billed, and the share of the idle time inside the benchmark's
  ``execute`` spans that a program span below ``dispatch`` / ``sync``
  covers; the idle gaps labelled ``<benchmark span>/<innermost program
  span>/<outermost host operator>``;
- ``metrics``: the benchmark's own per-layer metrics of the same run
  (its readers), from its own ``profiling.profile`` over the trace less
  the ``bad:`` ranges, so that they read as in the benchmark.

A device operation is billed to the innermost ``bad:`` range open at its
launch: the profiler gives a kernel or copy and the host's CUDA call that
launched it one correlation id.

What is new here (``split_events``, ``bill``, ``program_gaps``,
``window_values``) belongs in ``bad_bench/profiling.py`` and readers of
``bad_bench/metrics/``; once the benchmark's traced run turns the tracer
on and reduces its ranges itself, this tool and its tests go.

Exits 2 without a CUDA card. ``main(..., dev=cpu)`` runs on the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import trace  # noqa: E402

# the spans whose device time the split reports, a tick
DEVICE_SPANS = ("discover", "join", "deliver")


# the program's records of a run, one batch each time the benchmark's spans
# turn off: the window's, then the profiled ticks'
RECORDS: List[list] = []


def traced_spans(spans_cls):
    """The benchmark's spans class, with the program's tracer on while its
    spans are."""

    class TracedSpans(spans_cls):
        @property
        def on(self) -> bool:
            return getattr(self, "_on", False)

        @on.setter
        def on(self, value: bool) -> None:
            if value and not self.on:
                trace.collect()
                trace.enable()
            elif not value and self.on:
                trace.disable()
                RECORDS.append(trace.collect())
            self._on = value

    return TracedSpans


class WithoutRanges(torch.profiler.profile):
    """``torch.profiler.profile`` whose ``events()`` leave out the program's
    ``bad:`` ranges, which the benchmark's reduction does not know; the
    whole trace of the last session stays in ``WithoutRanges.events_all``."""

    events_all: list = []

    def events(self):
        events = super().events()
        WithoutRanges.events_all = events
        return [e for e in events if not e.name.startswith("bad:")]


class Ranges:
    """Properly nested host ranges (start, end, name): the innermost one
    open at a time."""

    def __init__(self, ranges):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in ranges]
        self.ends = [r[1] for r in ranges]
        self.names = [r[2] for r in ranges]
        self.parent, stack = [], []
        for i, (a, b, _) in enumerate(ranges):
            while stack and self.ends[stack[-1]] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.cuts = sorted(set(self.starts) | set(self.ends))

    def innermost(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return self.names[i] if i >= 0 else None

    def cuts_in(self, lo: float, hi: float) -> List[float]:
        a = bisect.bisect_right(self.cuts, lo)
        b = bisect.bisect_left(self.cuts, hi)
        return self.cuts[a:b]


def split_events(events):
    """The profiler's events as (device operations, benchmark spans,
    program ranges, host operators): a device operation is (start, end,
    name, launch time or None), the launch being the host's CUDA call
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that shares its
    correlation id; ``bad:`` and ``span:`` events are ranges, and their
    copies on the device's timeline annotations, neither device operations
    nor host operators."""
    from torch.autograd import DeviceType
    dev, spans, ranges, cpu = [], [], [], []
    launches = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        cuda = e.device_type == DeviceType.CUDA
        if e.name.startswith(("span:", "bad:")):
            if not cuda:
                (spans if e.name[0] == "s" else ranges).append(
                    (a, b, e.name.split(":", 1)[1]))
        elif cuda:
            dev.append((a, b, e.name, e.id))
        else:
            cpu.append((a, b, e.name))
            if e.name.startswith("cu"):
                launches[e.id] = a
    ops = [(a, b, name, launches.get(cid)) for a, b, name, cid in dev]
    return ops, spans, ranges, cpu


def bill(ops, ranges: Ranges):
    """Device seconds of each program span name (each operation billed to
    the innermost range open at its launch) and the unbilled rest."""
    billed: Dict[str, float] = {}
    unbilled = 0.0
    for a, b, _, launch in ops:
        owner = None if launch is None else ranges.innermost(launch)
        if owner is None:
            unbilled += (b - a) * 1e-6
        else:
            billed[owner] = billed.get(owner, 0.0) + (b - a) * 1e-6
    return billed, unbilled


def program_gaps(ops, spans, cpu, ranges: Ranges):
    """Idle device time split as ``profiling.idle_gaps`` splits it, each
    share cut again where a program range opens or closes and labelled
    ``<benchmark span>/<innermost program span>/<outermost host
    operator>``. Also returns the idle seconds inside ``execute`` spans
    and those of them a program span below ``dispatch`` / ``sync``
    covers."""
    out: Dict[str, float] = {}
    inside = below = 0.0
    if not ops:
        return out, inside, below
    top, reach = [], None
    for a, b, name in sorted(cpu):
        if reach is None or a >= reach:
            top.append((a, b, name))
            reach = b
    starts = [a for a, _, _ in top]
    spans = sorted(spans)

    def op_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return top[i][2] if i >= 0 and top[i][1] >= t else None

    ends = sorted((a, b) for a, b, _, _ in ops)
    end = ends[0][1]
    for a, b in ends[1:]:
        if a > end:
            covered = 0.0
            for s0, s1, span in spans:
                lo, hi = max(s0, end), min(s1, a)
                if lo >= hi:
                    continue
                covered += hi - lo
                points = [lo] + ranges.cuts_in(lo, hi) + [hi]
                for p, q in zip(points, points[1:]):
                    inner = ranges.innermost((p + q) / 2)
                    label = "/".join(x for x in (span, inner, op_at(p))
                                     if x)[:120]
                    out[label] = out.get(label, 0.0) + (q - p) * 1e-6
                    if span == "execute":
                        inside += (q - p) * 1e-6
                        if inner not in (None, "dispatch", "sync"):
                            below += (q - p) * 1e-6
            if a - end > covered:
                out["between ticks"] = (out.get("between ticks", 0.0)
                                        + (a - end - covered) * 1e-6)
        end = max(end, b)
    return out, inside, below


def profile(fn, dev, ticks: int) -> dict:
    """The benchmark's ``profiling.profile`` (its keys and arithmetic) over
    the trace less the ``bad:`` ranges; plus ``program``: the device time
    billed to each program span and the idle gaps labelled by them."""
    from bad_bench import profiling
    session = torch.profiler.profile
    torch.profiler.profile = WithoutRanges
    try:
        out = profiling.profile(fn, dev, ticks)
    finally:
        torch.profiler.profile = session
    ops, spans, ranges, cpu = split_events(WithoutRanges.events_all)
    index = Ranges(ranges)
    billed, unbilled = bill(ops, index)
    gaps, inside, below = program_gaps(ops, spans, cpu, index)
    out["program"] = dict(billed=billed, unbilled=unbilled, gaps=gaps,
                          execute_idle_s=inside, execute_idle_below_s=below,
                          ranges=len(ranges),
                          unlinked=sum(1 for op in ops if op[3] is None))
    return out


def window_values(records, ticks: int) -> Optional[dict]:
    """The window's per-tick values from the program's records; None
    where the run holds none."""
    if not records or not ticks:
        return None

    def ms(rs):
        return 1e-6 * sum(r.end_ns - r.start_ns for r in rs) / ticks

    reads = [r for r in records if r.name.startswith("read.")]
    patches = [r for r in records if r.name == "patch"]
    removes = [r for r in records if r.name == "remove_subscriptions"]
    names = sorted({r.name for r in records})
    return {
        "host_read_ms": ms(reads),
        "host_reads_per_tick": len(reads) / ticks,
        "patch_ms": ms(patches) if patches else None,
        "rebuilds_per_tick": sum(r.name == "rebuild"
                                 for r in records) / ticks,
        "remove_ms": ms(removes) if removes else None,
        "reads_per_tick": {n: sum(r.name == n for r in reads) / ticks
                           for n in names if n.startswith("read.")},
        "read_bytes_per_tick": sum(r.attrs.get("bytes", 0)
                                   for r in reads) / ticks,
        "span_ms": {n: ms([r for r in records if r.name == n])
                    for n in names},
    }


def device_values(prof: Optional[dict]) -> Optional[dict]:
    """Device time a profiled tick by program span, and the shares the
    split is held to; None without a profile or program ranges."""
    if not prof or not prof["program"]["ranges"]:
        return None
    p, ticks = prof["program"], prof["ticks"]
    billed = sum(p["billed"].values())
    ops_s = sum(prof["by_name"].values())
    out = {f"{n}_device_ms": 1e3 * p["billed"].get(n, 0.0) / ticks
           for n in DEVICE_SPANS}
    out.update(
        billed_ms_by_span={n: 1e3 * s / ticks
                           for n, s in sorted(p["billed"].items())},
        unbilled_ms=1e3 * p["unbilled"] / ticks,
        billed_share=billed / max(billed + p["unbilled"], 1e-12),
        billed_plus_unbilled_over_ops=(billed + p["unbilled"])
        / max(ops_s, 1e-12),
        execute_idle_below_share=p["execute_idle_below_s"]
        / max(p["execute_idle_s"], 1e-12),
        unlinked_ops=p["unlinked"],
        idle_gaps=sorted(([k, v] for k, v in p["gaps"].items()),
                         key=lambda kv: -kv[1])[:12])
    return out


def measure(bench, cell, cfg, workload: str, seed: int, seconds: float,
            traced: bool, dev) -> dict:
    """One traced run of the cell on ``dev``, judged and reduced."""
    from bad_bench import check, run as bench_run, system
    from bad_bench.reference import reference
    RECORDS.clear()
    spans_cls = system.Spans
    if traced:
        system.Spans = traced_spans(spans_cls)
    try:
        run = system.run(cfg, cell, seed, seconds, True, dev, T_START,
                         profile_fn=profile)
    finally:
        system.Spans = spans_cls
        trace.disable()
        trace.collect()
    want = reference.expected(cfg, cell, seed, len(run.ticks),
                              set(run.sampled), dev)
    ok = check.correct(check.compare(run, want, cfg, dev))
    walls = [t.wall_s for t in run.window]
    window = dict(ticks=len(run.window), seconds=run.window_s,
                  tick_ms_p90=1e3 * float(np.percentile(walls, 90)),
                  notify_ms_p90=1e3 * float(np.percentile(
                      [t.notify_s for t in run.window], 90)))
    window["program"] = window_values(RECORDS[0] if RECORDS else [],
                                      len(run.window))
    return dict(workload=workload, seed=seed, tracer=int(traced),
                correct=ok, window=window,
                device=device_values(run.profile),
                metrics=bench_run.per_layer(run, bench, workload),
                idle_share=None if not run.profile else
                1.0 - run.profile["busy_s"] / run.profile["wall_s"])


def span_cost(n: int = 200_000) -> dict:
    """Host ns a span costs: the shared no-op while the tracer is off, a
    recorded span while it is on (no profiler running)."""
    out = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        t = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("cost", channels=3):
                pass
        out["on_ns" if on else "off_ns"] = (time.perf_counter_ns() - t) / n
        trace.disable()
        trace.collect()
    return out


def main(argv=None, dev=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--tracer", type=int, nargs="+", choices=(0, 1),
                    default=[1])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "trace_cell.jsonl"))
    args = ap.parse_args(argv)
    from bad_bench import run as bench_run
    bench, _, cell, cfg = bench_run.load(ROOT, args.workload)
    if dev is None:
        if not torch.cuda.is_available():
            print("trace_cell: no CUDA card", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    lines = [dict(span_cost=span_cost())]
    print(json.dumps(lines[0]), flush=True)
    for seed in args.seeds:
        for traced in args.tracer:
            lines.append(measure(bench, cell, cfg, args.workload, seed,
                                 args.seconds, bool(traced), dev))
            print(json.dumps(lines[-1]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as fh:
        for line in lines:
            fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
