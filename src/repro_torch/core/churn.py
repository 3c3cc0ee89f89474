"""Sustained-churn driver: O(delta) subscription maintenance under load.

The paper's strategic aggregation (§4.1) assumes subscriptions arrive
continuously; this module drives that regime end to end. ``run_ticks``
interleaves bulk subscription adds and removals (and optional
spatial-cohort churn) with fused ``execute_all(deliver=True)`` ticks, and
reports the sustained control-plane throughput together with the engine's
maintenance counters: at steady state the epoch/delta protocol shows
*patches* advancing while *rebuilds* stay flat (every stacked cache is
patched in place).

The driver owns the live-sID bookkeeping (which subscriptions exist and can
be removed), so the engine under test is exercised purely through its public
control-plane API. Its draws are the reference driver's, so a seeded run
makes the same subscriptions, removals, cohort changes and record batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.engine import MaintenanceStats
from repro_torch.core.plans import ExecutionFlags
from repro_torch.core.runtime import EngineProtocol, TickPipeline
from repro_torch.data.synthetic import tweet_batch


@dataclasses.dataclass
class ChurnReport:
    """One ``run_ticks`` run. ``wall_s`` covers the TIMED ticks only
    (``warmup`` ticks are excluded so first-use costs are not billed to
    steady-state throughput); ``maintenance`` is the engine counter delta
    over the timed ticks."""

    ticks: int
    adds: int
    removes: int
    user_adds: int
    user_removes: int
    wall_s: float
    maintenance: MaintenanceStats
    live_subs: int
    results: int
    delivered_pairs: int
    delivered_sids: int
    spilled: int
    dropped: int
    # host round trips: ``drain_spilled()`` invocations over the timed
    # ticks, and what is still ring-resident / host-queued at the end
    drain_calls: int = 0
    ring_pending: int = 0
    queue_pending: int = 0
    # measured maximum number of ticks simultaneously in flight (1 on the
    # synchronous path; the requested depth once a pipelined run warms up)
    pipeline_depth: int = 1

    @property
    def subs_per_s(self) -> float:
        """Sustained control-plane throughput: subscription mutations
        (adds + removes + cohort churn) per wall second, execution and
        delivery included."""
        ops = self.adds + self.removes + self.user_adds + self.user_removes
        return ops / max(self.wall_s, 1e-9)

    @property
    def ticks_per_s(self) -> float:
        return self.ticks / max(self.wall_s, 1e-9)


class _LivePool:
    """Amortized append + O(k) swap-remove sample over the live sIDs:
    driver bookkeeping must stay o(live) per batch or it would be billed to
    the engine under test."""

    def __init__(self, init: np.ndarray):
        self.n = len(init)
        self.buf = np.empty((max(1024, 2 * self.n),), np.int32)
        self.buf[:self.n] = init

    def add(self, new: np.ndarray) -> None:
        need = self.n + len(new)
        if need > len(self.buf):
            nb = np.empty((max(need, 2 * len(self.buf)),), np.int32)
            nb[:self.n] = self.buf[:self.n]
            self.buf = nb
        self.buf[self.n:need] = new
        self.n = need

    def sample_remove(self, rng: np.random.Generator,
                      n_rm: int) -> np.ndarray:
        """Remove ~n_rm random live sIDs (unique positions; duplicates in
        the draw collapse) and return them."""
        pick = np.unique(rng.integers(0, self.n, n_rm))
        out = self.buf[pick].copy()
        k = len(pick)
        n0 = self.n - k
        mark = np.zeros((k,), bool)
        mark[pick[pick >= n0] - n0] = True
        self.buf[pick[pick < n0]] = self.buf[n0:self.n][~mark]
        self.n = n0
        return out

    def view(self) -> np.ndarray:
        return self.buf[:self.n]


@dataclasses.dataclass
class ChurnWorkload:
    """Per-tick churn mix for one param channel."""

    channel: str
    adds_per_tick: int = 512
    removes_per_tick: int = 512
    param_domain: int = 50
    num_brokers: int = 1
    # spatial cohort churn (requires the engine to hold a spatial channel
    # with an explicit cohort); 0 disables
    user_channel: Optional[str] = None
    user_churn_per_tick: int = 0


class _Tally:
    """The counters a run accumulates over its timed ticks."""

    def __init__(self):
        self.adds = self.removes = self.user_adds = self.user_removes = 0
        self.results = self.dp = self.ds = self.sp = self.dr = 0
        self.drains = 0

    def churn(self, engine, workloads, live, rng, churn_rounds: int,
              timed: bool) -> None:
        """``churn_rounds`` control-plane batches: per workload, bulk-add,
        bulk-remove, and optionally churn its spatial cohort."""
        for _ in range(max(1, churn_rounds)):
            for w in workloads:
                if w.adds_per_tick:
                    params = rng.integers(0, w.param_domain,
                                          w.adds_per_tick).astype(np.int32)
                    brokers = rng.integers(0, w.num_brokers,
                                           w.adds_per_tick).astype(np.int32)
                    new = engine.subscribe_bulk(w.channel, params, brokers)
                    live[w.channel].add(new)
                    if timed:
                        self.adds += len(new)
                n_rm = min(w.removes_per_tick, live[w.channel].n)
                if n_rm:
                    rm = live[w.channel].sample_remove(rng, n_rm)
                    gone = engine.remove_subscriptions(w.channel, rm)
                    if timed:
                        self.removes += gone
                if w.user_channel and w.user_churn_per_tick:
                    nu = engine.user_locations.shape[0]
                    k = w.user_churn_per_tick
                    out = engine.unsubscribe_users(
                        w.user_channel, rng.integers(0, nu, k))
                    inn = engine.subscribe_users(
                        w.user_channel, rng.integers(0, nu, k))
                    if timed:
                        self.user_removes += out
                        self.user_adds += inn

    def account(self, reports: Dict) -> None:
        for rep in reports.values():
            self.results += rep.num_results
            o = rep.overflow
            if o is not None:
                self.dp += o.delivered_pairs
                self.ds += o.delivered_sids
                self.sp += o.spilled_pairs + o.spilled_sids
                self.dr += o.dropped_pairs + o.dropped_sids

    def drain_to_empty(self, engine, on_drain, timed: bool) -> None:
        while engine.spill.pending_pairs() + engine.spill.pending_sids() > 0:
            if timed:
                self.drains += 1
            drained = engine.drain_spilled()
            if on_drain is not None:
                on_drain(drained)
            if timed:
                for d in drained.values():
                    self.dp += d.stats.delivered_pairs
                    self.ds += d.stats.delivered_sids
                    self.dr += d.stats.dropped_pairs + d.stats.dropped_sids

    def report(self, engine, ticks, warmup, wall, snap, live,
               live_sids, depth=1) -> ChurnReport:
        if live_sids is not None:    # hand the surviving population back
            for k, pool in live.items():
                live_sids[k] = pool.view().copy()
        return ChurnReport(
            ticks=max(0, ticks - warmup), adds=self.adds,
            removes=self.removes, user_adds=self.user_adds,
            user_removes=self.user_removes, wall_s=wall,
            maintenance=engine.maintenance.since(snap),
            live_subs=sum(pool.n for pool in live.values()),
            results=self.results, delivered_pairs=self.dp,
            delivered_sids=self.ds, spilled=self.sp, dropped=self.dr,
            drain_calls=self.drains,
            ring_pending=(engine.ring_pending_pairs()
                          + engine.ring_pending_sids()),
            queue_pending=(engine.spill.pending_pairs()
                           + engine.spill.pending_sids()),
            pipeline_depth=depth)


def _live_pools(workloads, live_sids) -> Dict[str, _LivePool]:
    live = {w.channel: _LivePool(np.zeros((0,), np.int32))
            for w in workloads}
    if live_sids:
        live.update({k: _LivePool(np.asarray(v, np.int32))
                     for k, v in live_sids.items()})
    return live


def run_ticks(engine: EngineProtocol,
              workloads: List[ChurnWorkload],
              ticks: int,
              rng: np.random.Generator,
              flags: ExecutionFlags = None,
              deliver: bool = True,
              ingest_per_tick: int = 256,
              make_batch: Callable = None,
              warmup: int = 2,
              live_sids: Optional[Dict[str, np.ndarray]] = None,
              churn_rounds: int = 1,
              use_channel_plans: bool = False,
              on_tick: Callable = None,
              on_drain: Callable = None,
              pipeline_depth: int = 1,
              drain_every: Optional[int] = None) -> ChurnReport:
    """Drive ``ticks`` churn ticks: per workload, bulk-add then bulk-remove
    subscriptions, optionally churn a spatial cohort, ingest a record batch,
    run the fused ``execute_all`` (optionally with fused delivery), and
    drain any spilled notifications.

    ``engine`` is anything satisfying ``runtime.EngineProtocol``; it runs
    on its own device (``BADEngine(device=...)``, ``"cuda"`` by default),
    and the default ``make_batch`` builds each tick's records with
    ``data.synthetic.tweet_batch`` on that device. ``live_sids`` (channel
    -> sID array) seeds the removable population; it is updated in place.
    The first ``warmup`` ticks are untimed; the returned report covers the
    rest.

    ``churn_rounds`` control-plane batches land per executed tick: the
    paper's regime, where subscriptions arrive continuously between channel
    periods. Every batch pays the maintenance cost (the rebuild baseline,
    ``incremental=False``, re-aggregates per BATCH).

    ``use_channel_plans`` executes under each channel's assigned
    ``ChannelPlan`` (``execute_all(None)``) instead of homogeneous
    ``flags``. ``on_tick(tick, reports)`` fires after every executed tick
    (hook a ``RuntimePlanner.step`` here to re-plan mid-run);
    ``on_drain(reports)`` after every ``drain_spilled`` round.

    ``pipeline_depth >= 2`` drives the ticks through ``TickPipeline``
    (core/runtime.py): each tick is dispatched while up to ``depth - 1``
    previous ticks are still executing, the next tick's churn and ingest
    overlap them, and ``drain_spilled`` batches every ``drain_every`` ticks
    (default: == depth). Reports are accounted by their DISPATCH tick
    number, spill capture runs through the SpillQueue's epoch-free resolved
    lane, and the run flushes and drains to empty before returning: the
    delivered notification multiset is the synchronous path's.
    """
    if use_channel_plans:
        flags = None
    else:
        flags = flags or ExecutionFlags.fully_optimized()
    if make_batch is None:
        device = engine.device
        make_batch = lambda r, n, t0: tweet_batch(r, n, t0=t0, device=device)
    if pipeline_depth > 1:
        return _run_ticks_pipelined(
            engine, workloads, ticks, rng, flags, deliver, ingest_per_tick,
            make_batch, warmup, live_sids, churn_rounds, on_tick, on_drain,
            pipeline_depth, drain_every)
    live = _live_pools(workloads, live_sids)
    tally = _Tally()
    t0_clock = 0.0
    snap = engine.maintenance.snapshot()
    now = engine.now
    for tick in range(ticks):
        if tick == warmup:
            snap = engine.maintenance.snapshot()
            t0_clock = time.perf_counter()
        timed = tick >= warmup
        tally.churn(engine, workloads, live, rng, churn_rounds, timed)
        if ingest_per_tick:
            now += 100
            engine.ingest(make_batch(rng, ingest_per_tick, now))
        reports = engine.execute_all(flags, timed=False, deliver=deliver)
        if on_tick is not None:
            on_tick(tick, reports)
        if timed:
            tally.account(reports)
        tally.drain_to_empty(engine, on_drain, timed)
    wall = time.perf_counter() - t0_clock if ticks > warmup else 0.0
    return tally.report(engine, ticks, warmup, wall, snap, live, live_sids)


def _run_ticks_pipelined(engine, workloads, ticks, rng, flags, deliver,
                         ingest_per_tick, make_batch, warmup, live_sids,
                         churn_rounds, on_tick, on_drain,
                         pipeline_depth, drain_every) -> ChurnReport:
    """The ``pipeline_depth >= 2`` body of ``run_ticks``: the same workload
    schedule, ticks driven through ``TickPipeline``. Reports surface up to
    ``depth - 1`` ticks after dispatch and are accounted by DISPATCH tick
    number (so the timed window covers exactly the synchronous path's
    work); the pipeline is flushed at the warmup boundary so warmup latency
    is never billed to the timed window."""
    live = _live_pools(workloads, live_sids)
    tally = _Tally()
    t0_clock = 0.0
    snap = engine.maintenance.snapshot()
    now = engine.now
    pipe = TickPipeline(engine, depth=pipeline_depth,
                        drain_every=drain_every)

    def account(ready) -> None:
        for tick_no, reports in ready:
            if on_tick is not None:
                on_tick(tick_no, reports)
            if tick_no >= warmup:
                tally.account(reports)

    for tick in range(ticks):
        if tick == warmup:
            # quiesce before the timed window: in-flight warmup ticks sync
            # (their spills stay unbilled), the queue empties, and the clock
            # starts on a clean pipeline
            account(pipe.flush())
            tally.drain_to_empty(engine, on_drain, False)
            snap = engine.maintenance.snapshot()
            t0_clock = time.perf_counter()
        timed = tick >= warmup
        tally.churn(engine, workloads, live, rng, churn_rounds, timed)
        if ingest_per_tick:
            now += 100
            engine.ingest(make_batch(rng, ingest_per_tick, now))
        account(pipe.step(flags, deliver=deliver))
        if pipe.drain_due():
            tally.drain_to_empty(engine, on_drain, timed)
    account(pipe.flush())
    tally.drain_to_empty(engine, on_drain, ticks > warmup)
    wall = time.perf_counter() - t0_clock if ticks > warmup else 0.0
    return tally.report(engine, ticks, warmup, wall, snap, live, live_sids,
                        depth=max(pipe.max_in_flight, 1))
