"""Host spans of the engine's own work, on the profiler's clock.

The port's one span system. Off by default: ``span()`` then returns the
shared ``NOOP`` and records nothing. ``enable()`` turns it on for the
process, ``disable()`` off, and ``collect()`` returns the records kept in
memory, in the order the spans opened, and clears them. Nothing is
written or printed.

A record holds the span's name, the execution it belongs to, its id and
its parent's, its start and end (``time.perf_counter_ns``) and its
attributes: counts at the boundary (``bytes`` of a read, ``channels`` of a
plan-group). While ``torch.profiler`` records, each span also opens
``record_function("bad:<name>")``, so the profiler's trace holds the same
ranges on the clock of the device activity; with no profiler running that
step is skipped.

Executions: ``BADEngine.dispatch`` takes a new id (``next_execution``)
and its ``PendingExecution.sync`` carries the same one, however late it
runs. A span opened outside any other takes ``execution=`` when given,
else the id the next dispatch will take: ingest, the control plane and
``drain_spilled`` belong to the tick the next dispatch runs. A span
nested in another carries its parent's.

Names: ``dispatch`` > ``group`` > ``read.watermarks``, ``caches`` >
(``patch`` | ``rebuild``), ``discover``, ``read.stream_totals``, ``join``,
``rank``, ``deliver``; then ``advance``. ``sync`` > ``materialize`` >
``read.reports``, ``accounting``. ``ingest`` > ``read.index_insert``;
``drain`` > ``read.drain``; the control plane's ``subscribe_bulk``,
``remove_subscriptions``, ``subscribe_users``, ``unsubscribe_users``.
Every blocking device->host read of a tick is a ``read.*`` span.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

_on = False
_records: List["Record"] = []
_open: List["_Span"] = []
_ids = 0
_next_execution = 0


class Record(NamedTuple):
    name: str
    execution: int
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    attrs: Dict


class _Noop:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "attrs", "execution", "id", "parent", "start",
                 "mark")

    def __init__(self, name: str, execution: Optional[int], attrs: Dict):
        self.name, self.attrs, self.execution = name, attrs, execution

    def __enter__(self):
        global _ids
        parent = _open[-1] if _open else None
        if parent is not None:
            self.execution = parent.execution
        elif self.execution is None:
            self.execution = _next_execution
        self.parent = None if parent is None else parent.id
        self.id = _ids
        _ids += 1
        _open.append(self)
        self.mark = None
        if _profiler._is_profiler_enabled:
            self.mark = _profiler.record_function(f"bad:{self.name}")
            self.mark.__enter__()
        # read after the range opens and after it closes: the profiler's
        # own work inside both calls is then the nearest to even
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.mark is not None:
            self.mark.__exit__(*exc)
        end = time.perf_counter_ns()
        _open.pop()
        _records.append(Record(self.name, self.execution, self.id,
                               self.parent, self.start, end, self.attrs))
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def span(name: str, execution: Optional[int] = None, **attrs):
    """A context manager around one piece of the engine's work; ``set``
    on it adds attributes learnt inside."""
    if not _on:
        return NOOP
    return _Span(name, execution, attrs)


def next_execution() -> int:
    """The id of the dispatch that starts now."""
    global _next_execution
    execution = _next_execution
    _next_execution += 1
    return execution


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def collect() -> List[Record]:
    """The records kept so far, in the order their spans opened; clears
    them."""
    global _records
    out, _records = _records, []
    out.sort(key=lambda r: r.id)
    return out
