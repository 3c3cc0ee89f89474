"""A few profiled ticks, reduced to what the per-layer metrics read: the
device's busy time, its kernels by name and their launches, the idle gaps
named by the host span that was open, and the inputs of the kernels whose
rooflines are reported.

The port launches on one stream, so busy time is the union of the
device operations' intervals (kernels, copies, sets): the busy-share
arithmetic of ``tools/profile_main_path.py``, with overlaps counted once.
"""
from __future__ import annotations

import bisect
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


def profile(fn: Callable, dev, ticks: int) -> dict:
    """Run ``fn`` (the profiled ticks) under ``torch.profiler`` and reduce
    its trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    with KernelInputs() as inputs:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    events = prof.events()
    dev_ops, spans, cpu_ops = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("span:"):
            # a span's host range; its copy on the device's timeline is
            # an annotation, not an operation
            if e.device_type != DeviceType.CUDA:
                spans.append((a, b, e.name[5:]))
        elif e.device_type == DeviceType.CUDA:
            dev_ops.append((a, b, e.name))
        else:
            cpu_ops.append((a, b, e.name))
    busy_us = _union([(a, b) for a, b, _ in dev_ops])
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for a, b, name in dev_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        counts[name] = counts.get(name, 0) + 1
    kernels = sum(n for name, n in counts.items()
                  if not name.lower().startswith(("memcpy", "memset")))
    gaps = idle_gaps(dev_ops, spans, cpu_ops)
    return dict(wall_s=wall, busy_s=busy_us * 1e-6, by_name=by_name,
                counts=counts, kernels=kernels, ticks=ticks, gaps=gaps,
                bytes=inputs.bytes() if dev_ops else {})


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
