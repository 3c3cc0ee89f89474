"""Pipelined tick runtime: overlap host control-plane work with in-flight
device execution.

The synchronous tick loop serializes host and device: ``execute_all``
materializes every stat as soon as a plan-group's work is enqueued, and only
then lets the next tick's aggregator/churn numpy work start. CUDA kernels
are asynchronous and the engine's work is ordered on one stream, so none of
that waiting is necessary: ``BADEngine.dispatch_all`` enqueues every
plan-group's work and returns device TENSORS immediately; this module
schedules when they are finally read.

``PendingExecution`` is one dispatched tick: an idempotent ``sync()``
materializes its per-channel ``ExecutionReport``s (the first host read of
the outputs) and runs the host half of delivery accounting.
``TickPipeline`` keeps a bounded window of them in flight: ``step`` at
depth N dispatches tick t while ticks t-1..t-(N-1) are still executing, and
only syncs the oldest when the window would exceed N-1 pending entries. The
control-plane work between ``step`` calls (subscription churn, batch
synthesis, ingest) therefore runs on the host while the previous ticks'
joins and delivery run on the card.

Correctness under deferral: device results are stream-ordered and identical
to the synchronous schedule (rings thread from dispatch to dispatch;
watermarks advance and caches are patched at dispatch, after the work that
read them), so the ONLY thing that moves in time is the host SpillQueue.
Deferred captures use the queue's epoch-free RESOLVED lane
(``dispatch_all(resolve_spills=True)``): pair fanout is resolved at sync
against clones of the dispatch-time sID tables, so draining every
``drain_every`` ticks delivers the identical notification multiset as the
synchronous drain-every-tick path, under same-channel churn and sustained
overflow alike. On a CPU engine every operation completes before it
returns; the schedule and its results are the same.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.core import trace


@runtime_checkable
class EngineProtocol(Protocol):
    """The engine control surface the tick drivers (``TickPipeline``,
    ``core/churn.run_ticks``) call, extracted so they type-check against
    one interface. ``dispatch`` / ``dispatch_all`` return a pending handle
    with an idempotent ``sync()``; ``execute`` / ``execute_all`` are their
    synchronous composition; the spill/ring surface drains per channel."""

    def create_channel(self, spec) -> None: ...

    def subscribe_bulk(self, channel: str, params) -> None: ...

    def remove_subscriptions(self, channel: str, sids) -> None: ...

    def ingest(self, batch) -> None: ...

    def execute(self, request) -> Dict: ...

    def dispatch(self, request): ...

    def execute_all(self, flags=None, advance: bool = True,
                    timed: bool = True, deliver: bool = False) -> Dict: ...

    def dispatch_all(self, flags=None, advance: bool = True,
                     timed: bool = False, deliver: bool = False,
                     resolve_spills: bool = False): ...

    def drain_spilled(self, channel=None, max_entries=None) -> Dict: ...

    def flush_rings(self) -> None: ...

    def ring_pending_pairs(self, channel: str) -> int: ...

    def ring_pending_sids(self, channel: str) -> int: ...

    def set_plan(self, channel: str, plan) -> None: ...

    def set_enrichment(self, stage) -> bool: ...

    def default_plan(self): ...


class PendingExecution:
    """One dispatched ``dispatch_all`` call awaiting materialization.

    ``sync()`` is idempotent: the first call reads the outputs back (which
    waits for the work on the engine's stream), runs the host half (report
    assembly, SpillQueue pushes, conserving DeliveryStats), caches the
    reports and lets go of the dispatched outputs the reports do not hold
    (delivery buffers, rings, tables); later calls return the reports.
    ``latency_s`` records the latency from the end of ``dispatch`` to the
    end of the first sync. ``execution`` is the dispatch's id in
    ``core/trace``, which the first sync's ``sync`` span carries."""

    def __init__(self, engine, groups: List, execution: int):
        self._engine = engine
        self._groups = groups
        self._reports: Optional[Dict] = None
        self._t0 = time.perf_counter()
        self.latency_s: Optional[float] = None
        self.execution = execution

    @property
    def done(self) -> bool:
        return self._reports is not None

    def sync(self) -> Dict:
        if self._reports is None:
            reports: Dict = {}
            with trace.span("sync", execution=self.execution):
                for g in self._groups:
                    self._engine._materialize_group(g, reports)
            self.latency_s = time.perf_counter() - self._t0
            self._reports = reports
            self._groups = []
        return self._reports

    @property
    def reports(self) -> Dict:
        return self.sync()


class TickPipeline:
    """Bounded-depth pipeline of engine ticks.

    ``depth`` is the maximum number of ticks simultaneously in flight
    (depth 1 is the synchronous schedule: every ``step`` syncs its own
    dispatch). ``drain_every`` batches ``drain_spilled`` host round trips
    every K ticks (default: K == depth); ``drain_due()`` tells the driver
    when. Conservation holds because deferred captures go through the
    SpillQueue's resolved lane.

    ``step`` returns the (tick_number, reports) pairs that became ready,
    oldest first (possibly none while the window fills). ``flush()`` syncs
    everything still in flight. ``max_in_flight`` is the pipeline depth
    actually reached; ``latencies`` the per-tick dispatch-to-materialize
    seconds."""

    def __init__(self, engine: EngineProtocol, depth: int = 2,
                 drain_every: Optional[int] = None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.engine = engine
        self.depth = depth
        self.drain_every = drain_every or depth
        self._window: deque = deque()   # (tick_number, PendingExecution)
        self._tick = 0
        self.max_in_flight = 0
        self.latencies: List[float] = []

    @property
    def in_flight(self) -> int:
        return len(self._window)

    def step(self, flags=None, deliver: bool = True,
             timed: bool = False) -> List[Tuple[int, Dict]]:
        """Dispatch one tick; sync (only) what the depth bound forces out."""
        pend = self.engine.dispatch_all(flags, timed=timed, deliver=deliver,
                                        resolve_spills=True)
        self._window.append((self._tick, pend))
        self._tick += 1
        # the dispatch just issued overlaps with every older in-flight tick
        self.max_in_flight = max(self.max_in_flight, len(self._window))
        out: List[Tuple[int, Dict]] = []
        while len(self._window) > self.depth - 1:
            out.append(self._pop())
        return out

    def flush(self) -> List[Tuple[int, Dict]]:
        """Sync every in-flight tick, oldest first."""
        out: List[Tuple[int, Dict]] = []
        while self._window:
            out.append(self._pop())
        return out

    def _pop(self) -> Tuple[int, Dict]:
        t, p = self._window.popleft()
        reports = p.sync()
        if p.latency_s is not None:
            self.latencies.append(p.latency_s)
        return t, reports

    def drain_due(self) -> bool:
        """True when the batched-drain cadence has come around: the driver
        should loop ``engine.drain_spilled()`` until the queue empties."""
        return self._tick % self.drain_every == 0
