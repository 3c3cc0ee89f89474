"""A few profiled ticks, reduced to what the per-layer metrics read: the
device's busy time, its kernels by name and their launches, the idle gaps
named by the host span that was open, and the inputs of the kernels whose
rooflines are reported.

The port launches on one stream, so busy time is the union of the
device operations' intervals (kernels, copies, sets): the busy-share
arithmetic of ``tools/profile_main_path.py``, with overlaps counted once.

With ``program_spans`` (a cell one of whose readers declares
``PROGRAM_SPANS = True``) the program's tracer (``repro_torch.core.trace``)
is on for the profiled ticks, so its spans are ``bad:<name>`` ranges in the
trace. Each device operation is then billed to the innermost ``bad:``
range open when the host launched it (the launching CUDA call shares the
operation's correlation id), as ``tools/trace_cell.py`` bills them, and the
profile's ``program`` holds, per span name, the device seconds billed to
it, the host seconds of its records and the numbers its records carry.
``bad:`` ranges are never host operators of the idle gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Callable, Dict, List

import torch

from bad_bench import peaks


class KernelInputs:
    """Wrap the wrappers of the kernels with a roofline, for the profiled
    ticks: each call's bytes are worked out after the profile, from the
    call's own inputs (kept alive until then)."""

    def __init__(self):
        from repro_torch.kernels.join_compact import ops as jc_ops
        from repro_torch.kernels.predicate_filter import ops as pf_ops
        self.mods = [(jc_ops, "join_pairs"), (pf_ops, "predicate_filter")]
        self.orig = [getattr(m, n) for m, n in self.mods]
        self.join_calls: List[tuple] = []
        self.filter_calls: List[tuple] = []

    def __enter__(self):
        jc, pf = self.orig

        def join_pairs(tgt, tgt_n, members, brokers, valid, payload, *a):
            self.join_calls.append((tgt, tgt_n, members, brokers, valid,
                                    payload))
            return jc(tgt, tgt_n, members, brokers, valid, payload, *a)

        def predicate_filter(fields, conds):
            self.filter_calls.append((fields.shape[0], fields.shape[1],
                                      len(conds.npreds)))
            return pf(fields, conds)

        setattr(self.mods[0][0], "join_pairs", join_pairs)
        setattr(self.mods[1][0], "predicate_filter", predicate_filter)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.mods, self.orig):
            setattr(m, n, f)
        return False

    def bytes(self) -> Dict[str, int]:
        return {"join_compact": sum(peaks.join_compact_bytes(*c)
                                    for c in self.join_calls),
                "predicate_filter": sum(peaks.predicate_filter_bytes(*c)
                                        for c in self.filter_calls)}


def _union(intervals: List[tuple]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile(fn: Callable, dev, ticks: int,
            program_spans: bool = False) -> dict:
    """Run ``fn`` (the profiled ticks) under ``torch.profiler`` and reduce
    its trace; with ``program_spans``, with the program's tracer on."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    with KernelInputs() as inputs:
        with torch.profiler.profile(activities=acts) as prof:
            with tracer(program_spans) as records:
                t0 = time.perf_counter()
                fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
    dev_ops, spans, ranges, cpu_ops, launched = split_events(prof.events())
    busy_us = _union([(a, b) for a, b, _ in dev_ops])
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for a, b, name in dev_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        counts[name] = counts.get(name, 0) + 1
    kernels = sum(n for name, n in counts.items()
                  if not name.lower().startswith(("memcpy", "memset")))
    gaps = idle_gaps(dev_ops, spans, cpu_ops)
    out = dict(wall_s=wall, busy_s=busy_us * 1e-6, by_name=by_name,
               counts=counts, kernels=kernels, ticks=ticks, gaps=gaps,
               bytes=inputs.bytes() if dev_ops else {})
    if records is not None:
        ops = [(a, b, t) for (a, b, _), t in zip(dev_ops, launched)]
        out["program"] = program(ops, Ranges(ranges), records)
    return out


def split_events(events):
    """The profiler's events as (device operations (start, end, name),
    benchmark spans and program ranges (start, end, name), host operators
    (start, end, name), and each device operation's launch time or None).
    ``span:`` and ``bad:`` events are ranges, and their copies on the
    device's timeline annotations, neither operations nor operators; a
    launch is the host's CUDA call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) that shares the operation's correlation
    id."""
    from torch.autograd import DeviceType
    dev_ops, spans, ranges, cpu_ops = [], [], [], []
    ids, launches = [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(("span:", "bad:")):
            if e.device_type != DeviceType.CUDA:
                (spans if e.name[0] == "s" else ranges).append(
                    (a, b, e.name.split(":", 1)[1]))
        elif e.device_type == DeviceType.CUDA:
            dev_ops.append((a, b, e.name))
            ids.append(e.id)
        else:
            cpu_ops.append((a, b, e.name))
            if e.name.startswith("cu"):
                launches[e.id] = a
    return dev_ops, spans, ranges, cpu_ops, [launches.get(i) for i in ids]


@contextlib.contextmanager
def tracer(on: bool):
    """The program's tracer on inside the block where ``on``: yields the
    list that receives the block's records after it, else None."""
    if not on:
        yield None
        return
    from repro_torch.core import trace
    trace.collect()
    trace.enable()
    records: List = []
    try:
        yield records
    finally:
        trace.disable()
        records.extend(trace.collect())


class Ranges:
    """Properly nested host ranges (start, end, name): the innermost one
    open at a time (``tools/trace_cell.py``'s)."""

    def __init__(self, ranges):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in ranges]
        self.ends = [r[1] for r in ranges]
        self.names = [r[2] for r in ranges]
        self.parent, stack = [], []
        for i, (a, _, _) in enumerate(ranges):
            while stack and self.ends[stack[-1]] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return self.names[i] if i >= 0 else None


def program(ops, ranges: Ranges, records) -> dict:
    """Per program span name: ``device_s``, the device operations (start,
    end, launch time or None) billed to it, each to the innermost range
    open at its launch; ``host_s``, the summed length of its records;
    ``count``, its records; and the sum of each number its records carry
    (``bytes``, ``channels``). ``unbilled_s``: device time no range owns."""
    spans: Dict[str, dict] = {}

    def entry(name):
        return spans.setdefault(name, {"device_s": 0.0, "host_s": 0.0,
                                       "count": 0, "counters": {}})

    unbilled = 0.0
    for a, b, launch in ops:
        owner = None if launch is None else ranges.innermost(launch)
        if owner is None:
            unbilled += (b - a) * 1e-6
        else:
            entry(owner)["device_s"] += (b - a) * 1e-6
    for r in records:
        e = entry(r.name)
        e["host_s"] += (r.end_ns - r.start_ns) * 1e-9
        e["count"] += 1
        for k, v in r.attrs.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                e["counters"][k] = e["counters"].get(k, 0) + v
    return {"spans": spans, "unbilled_s": unbilled}


def idle_gaps(dev_ops, spans, cpu_ops) -> Dict[str, float]:
    """Idle device time between operations, split by what the host was
    doing meanwhile: each benchmark span's share of a gap goes to the span
    and the outermost program operator open where that share begins; the
    rest of the gap to "between ticks"."""
    if not dev_ops:
        return {}
    top, reach = [], None       # outermost host operators, in time order
    for a, b, name in sorted(cpu_ops):
        if reach is None or a >= reach:
            top.append((a, b, name))
            reach = b
    starts = [a for a, _, _ in top]
    spans = sorted(spans)
    out: Dict[str, float] = {}

    def add(key, us):
        out[key] = out.get(key, 0.0) + us * 1e-6

    ends = sorted((a, b) for a, b, _ in dev_ops)
    end = ends[0][1]
    for a, b in ends[1:]:
        if a > end:
            covered = 0.0
            for s0, s1, name in spans:
                lo, hi = max(s0, end), min(s1, a)
                if lo < hi:
                    add(_label(lo, name, top, starts), hi - lo)
                    covered += hi - lo
            if a - end > covered:
                add("between ticks", a - end - covered)
        end = max(end, b)
    return out


def _label(t: float, span: str, top, starts) -> str:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and top[i][1] >= t:
        return f"{span}/{top[i][2]}"[:120]
    return span


# device operation names of each kernel with a roofline
KERNEL_NAMES = {"join_compact": ("join_quads_kernel", "join_pairs_kernel"),
                "predicate_filter": ("predicate_filter_kernel",)}


def kernel_seconds(prof: dict, kernel: str) -> float:
    return sum(s for name, s in prof["by_name"].items()
               if any(k in name for k in KERNEL_NAMES[kernel])
               and "rows" not in name)
