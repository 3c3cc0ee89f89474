"""Sharded BAD engine: N device-local engines behind one control plane.

``ShardedBADEngine`` partitions the subscription population (and spatial
cohorts) over ``num_shards`` device-local ``BADEngine`` instances and
presents the single-engine surface the churn driver, the planner,
``run_ticks`` and ``TickPipeline`` speak (``runtime.EngineProtocol``). The
partitioning model, as in the reference's ``repro/core/sharded.py``:

  channels      replicated: every shard runs every channel's plan, so
                plan-groups, stacked caches and retry rings stay keyed by
                (shard, plan).
  data plane    replicated: each shard ingests every record batch into its
                own dataset and BAD index, so candidate discovery is local
                and row ids agree across shards (and with a 1-shard
                oracle).
  subscriptions partitioned: global sIDs are allocated here and assigned to
                shards by the stable hash ``partition.shard_for_sids``; each
                shard aggregates only its own slice. Explicit-sID
                ``subscribe_bulk`` keeps ids global across shards and
                reshards.
  cohort users  partitioned by ``partition.shard_for_users``; spatial
                channels always run with explicit per-shard cohorts (the
                all-users semantics would deliver S copies), so
                ``create_channel`` snapshots the current population.
  brokers       endpoints owned round-robin by ``partition.broker_owner``;
                with ``route_cross_shard=True`` every tick's delivered
                notify sIDs are regrouped onto their owner shards by
                ``collectives.shuffle_notify`` on the shards' devices.

Devices: ``device="cuda"`` puts the shards on every visible card (shard i
on card ``i % count``), a device or a list of devices on those; one process
drives them all, as the reference's single-controller engine does, and
``_on(i)`` makes shard i's card current around its calls. Several shards
may share a card. Without a card ``"cuda"`` raises; tests pass
``device="cpu"``.

Accounting telescopes globally: each shard's DeliveryStats conserves
delivered + spilled + dropped == produced, and the merged per-channel stats
sum shard-wise, while ring-resident entries stay shard-local. ``reshard``
migrates to a new shard count conservation-exactly: rings flush through
each shard's SpillQueue, the queues drain to empty against the OLD tables
(the drained reports are returned so callers keep the delivered content),
the replicated data plane is copied into every new shard (each owns its own
tensors: ingest updates them in place), and the live population, re-read
from the host registry, is re-partitioned under the new hash with its
original sIDs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import plans
from repro_torch.core import records as R
from repro_torch.core.broker import DeliveryStats
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.engine import BADEngine, DrainReport, MaintenanceStats
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives, partition


@dataclasses.dataclass
class ShardedExecutionReport:
    """One channel's tick merged across shards. Field-compatible with
    ``ExecutionReport`` where downstream readers look (num_results /
    num_notified / scanned / wall_time_s / overflow); ``per_shard`` keeps
    the raw shard reports (payload/notify buffers included when the engine
    runs with ``debug_delivery_buffers``) for content-level parity checks,
    and ``routed`` the owner-shard-grouped notify sIDs (int32 numpy) when
    cross-shard routing is on."""

    channel: str
    num_results: int
    num_notified: int
    scanned: int
    wall_time_s: float
    overflow: Optional[DeliveryStats]
    per_shard: List
    routed: Optional[np.ndarray] = None


class ShardedPendingExecution:
    """Every shard's in-flight tick behind one handle: ``sync()``
    materializes each shard's ``PendingExecution`` under that shard's
    device context, merges the per-channel reports, and (delivering
    engines with cross-shard routing) runs the notify shuffle; idempotent,
    like the single-engine handle it wraps. ``latency_s`` records the
    dispatch-to-materialize latency of the first sync."""

    def __init__(self, owner, pends: List, deliver: bool):
        self._owner = owner
        self._pends = pends
        self._deliver = deliver
        self._reports: Optional[Dict[str, ShardedExecutionReport]] = None
        self._t0 = time.perf_counter()
        self.latency_s: Optional[float] = None

    @property
    def done(self) -> bool:
        return self._reports is not None

    def sync(self) -> Dict[str, ShardedExecutionReport]:
        if self._reports is None:
            per_shard = []
            for i, p in enumerate(self._pends):
                with self._owner._on(i):
                    per_shard.append(p.sync())
            merged = self._owner._merge_reports(per_shard)
            if self._deliver and self._owner.route_cross_shard:
                self._owner._route(merged)
            self.latency_s = time.perf_counter() - self._t0
            self._reports = merged
            self._pends = []
        return self._reports

    @property
    def reports(self) -> Dict[str, ShardedExecutionReport]:
        return self.sync()


class _SpillView:
    """Summed SpillQueue facade over every shard (the read-only surface the
    churn driver polls)."""

    def __init__(self, owner: "ShardedBADEngine"):
        self._owner = owner

    def pending_pairs(self, channel: Optional[str] = None) -> int:
        return sum(e.spill.pending_pairs(channel)
                   for e in self._owner.shards)

    def pending_sids(self, channel: Optional[str] = None) -> int:
        return sum(e.spill.pending_sids(channel)
                   for e in self._owner.shards)


class _ChannelRegistry:
    """Host-side live-subscription table for one channel, dense by global
    sID: the allocator for new ids and the single source of truth for
    re-partitioning (reshard, drop/re-create). O(1) amortized add, O(delta)
    remove, vectorized broker lookup for notification routing."""

    def __init__(self):
        self.params = np.zeros((0,), np.int32)
        self.brokers = np.zeros((0,), np.int32)
        self.live = np.zeros((0,), bool)
        self.next_sid = 0

    def _grow(self, n: int) -> None:
        if n <= self.params.shape[0]:
            return
        cap = max(1024, 1 << int(n - 1).bit_length())
        for name in ("params", "brokers"):
            old = getattr(self, name)
            buf = np.zeros((cap,), np.int32)
            buf[:old.shape[0]] = old
            setattr(self, name, buf)
        lv = np.zeros((cap,), bool)
        lv[:self.live.shape[0]] = self.live
        self.live = lv

    def add(self, params: np.ndarray, brokers: np.ndarray) -> np.ndarray:
        n = params.shape[0]
        sids = self.next_sid + np.arange(n, dtype=np.int32)
        self.next_sid += n
        self._grow(self.next_sid)
        self.params[sids] = params
        self.brokers[sids] = brokers
        self.live[sids] = True
        return sids

    def remove(self, sids: np.ndarray) -> np.ndarray:
        """Mark known live sids dead; returns the ones actually removed."""
        sids = np.unique(np.asarray(sids, np.int64))
        sids = sids[(sids >= 0) & (sids < self.next_sid)].astype(np.int32)
        sids = sids[self.live[sids]]
        self.live[sids] = False
        return sids

    def live_sids(self) -> np.ndarray:
        return np.nonzero(self.live[:self.next_sid])[0].astype(np.int32)


def _resolve_devices(device: Union[DeviceLike, Sequence[DeviceLike]]
                     ) -> List[torch.device]:
    """``"cuda"`` (no index): every visible card; a device: that device; a
    sequence: those devices. Raises for CUDA without a card."""
    if isinstance(device, (str, torch.device)):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [dev]
    devs = [resolve_device(d) for d in device]
    if not devs:
        raise ValueError("ShardedBADEngine needs at least one device")
    return devs


def _copy_state(state, device: torch.device):
    """A copy of a dataclass of tensors (``ActiveDataset``,
    ``BADIndexState``) on ``device`` that shares no storage with it."""
    return type(state)(**{f.name: getattr(state, f.name).to(device,
                                                            copy=True)
                          for f in dataclasses.fields(state)})


class ShardedBADEngine:
    """N-way sharded BAD engine. ``num_shards=1`` is the single-device
    oracle with the identical control surface (the parity harness compares
    against it). Extra keyword arguments configure every per-shard
    ``BADEngine`` identically: per-SHARD capacities (max_deliver_pairs,
    max_notify, ring_capacity, ...) stay per shard, so aggregate delivery
    capacity scales with the shard count."""

    def __init__(self, num_shards: int = 1, route_cross_shard: bool = False,
                 device: Union[DeviceLike, Sequence[DeviceLike]] = "cuda",
                 **engine_kwargs):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.route_cross_shard = route_cross_shard
        self.engine_kwargs = dict(engine_kwargs)
        self._devices = _resolve_devices(device)
        self._debug = False
        self._specs: Dict[str, ChannelSpec] = {}
        self._reg: Dict[str, _ChannelRegistry] = {}
        self._plans: Dict[str, plans.ChannelPlan] = {}
        self._cohorts: Dict[str, set] = {}
        self._user_brokers = np.zeros((1,), np.int32)
        self._enrichment = None
        self.shards: List[BADEngine] = [self._make_engine(i)
                                        for i in range(num_shards)]
        self.spill = _SpillView(self)

    # ------------------------------------------------------------------
    # shard plumbing
    # ------------------------------------------------------------------

    def _on(self, i: int):
        """Device context for shard i: its card is current around the
        shard's calls (every kernel wrapper also launches on its tensors'
        device); a CPU shard needs none."""
        dev = self.shard_device(i)
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def shard_device(self, i: int) -> torch.device:
        return self._devices[i % len(self._devices)]

    @property
    def device(self) -> torch.device:
        """Shard 0's device: where callers build record batches (``ingest``
        copies a batch once to each other device)."""
        return self.shard_device(0)

    def _make_engine(self, i: int) -> BADEngine:
        with self._on(i):
            eng = BADEngine(device=self.shard_device(i), **self.engine_kwargs)
        eng.debug_delivery_buffers = self._debug or self.route_cross_shard
        if self._enrichment is not None:  # reshard-built shards inherit
            eng.set_enrichment(self._enrichment)
        return eng

    @property
    def debug_delivery_buffers(self) -> bool:
        return self._debug or self.route_cross_shard

    @debug_delivery_buffers.setter
    def debug_delivery_buffers(self, value: bool) -> None:
        self._debug = bool(value)
        for e in self.shards:
            e.debug_delivery_buffers = self._debug or self.route_cross_shard

    @property
    def now(self) -> int:
        return self.shards[0].now

    @property
    def user_locations(self):
        return self.shards[0].user_locations

    @property
    def maintenance(self) -> MaintenanceStats:
        """Counters summed over the shards. A plain ``MaintenanceStats``, so
        ``snapshot()`` / ``since()`` (the churn driver's protocol) work
        unchanged; per-shard views come from ``per_shard_maintenance``."""
        merged = MaintenanceStats()
        for e in self.shards:
            merged.rebuilds += e.maintenance.rebuilds
            merged.patches += e.maintenance.patches
        return merged

    def per_shard_maintenance(self) -> List[MaintenanceStats]:
        return [e.maintenance.snapshot() for e in self.shards]

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------

    def create_channel(self, spec: ChannelSpec) -> None:
        if spec.name in self._specs:
            raise ValueError(f"channel {spec.name} exists")
        for i, e in enumerate(self.shards):
            with self._on(i):
                e.create_channel(spec)
        self._specs[spec.name] = spec
        self._reg[spec.name] = _ChannelRegistry()
        if spec.join == "spatial":
            # explicit cohorts always: the all-users semantics would notify
            # every user once PER SHARD. Snapshot the population now; later
            # membership flows through subscribe/unsubscribe_users.
            nu = int(self.shards[0].user_locations.shape[0])
            self._cohorts[spec.name] = set()
            self.subscribe_users(spec.name, np.arange(nu, dtype=np.int32))

    def drop_channel(self, name: str) -> None:
        for i, e in enumerate(self.shards):
            with self._on(i):
                e.drop_channel(name)
        del self._specs[name]
        del self._reg[name]
        self._plans.pop(name, None)
        self._cohorts.pop(name, None)

    def default_plan(self) -> plans.ChannelPlan:
        return self.shards[0].default_plan()

    def channel_plan(self, name: str) -> plans.ChannelPlan:
        return self.shards[0].channel_plan(name)

    def plan_assignment(self) -> Dict[str, plans.ChannelPlan]:
        return self.shards[0].plan_assignment()

    def set_plan(self, name: str, plan: plans.ChannelPlan) -> bool:
        changed = False
        for i, e in enumerate(self.shards):
            with self._on(i):
                changed = e.set_plan(name, plan) or changed
        if changed:
            self._plans[name] = plan
        return changed

    def set_enrichment(self, stage) -> bool:
        """Attach/detach one ``EnrichmentStage`` on every shard. Every shard
        scores its OWN candidate slots and applies the budget per shard,
        like every other per-shard delivery capacity, so the hook adds no
        cross-shard step and the merged ``ranked_*`` stats sum shard-wise.
        Survives ``reshard`` (rebuilt shards re-attach)."""
        changed = False
        for i, e in enumerate(self.shards):
            with self._on(i):
                changed = e.set_enrichment(stage) or changed
        self._enrichment = stage
        return changed

    def subscribe(self, channel: str, param: int, broker: str = "BrokerA",
                  sid: Optional[int] = None) -> int:
        if sid is not None:
            raise ValueError("explicit sids are allocated by the sharded "
                             "engine; use subscribe_bulk slices instead")
        bid = self.shards[0].brokers.names[broker]
        return int(self.subscribe_bulk(
            channel, np.asarray([param], np.int32),
            np.asarray([bid], np.int32))[0])

    def subscribe_bulk(self, channel: str, params: np.ndarray,
                       brokers: np.ndarray) -> np.ndarray:
        """Allocate global sIDs, register them in the host registry, and
        hand each shard its hash-owned slice (untouched shards see no call,
        so their epochs and caches stay put). Returns the global sIDs."""
        params = np.asarray(params, dtype=np.int32).ravel()
        brokers = np.asarray(brokers, dtype=np.int32).ravel()
        if params.shape != brokers.shape:
            raise ValueError("params and brokers must have the same length")
        spec = self._specs[channel]
        # validate before ANY shard or registry mutation (the contract of
        # BADEngine.subscribe_bulk: a bad batch leaves nothing half-applied)
        if params.size and (int(params.min()) < 0
                            or int(params.max()) >= spec.param_domain):
            raise ValueError(
                f"params out of [0, {spec.param_domain}) for {channel}")
        nb = self.shards[0].brokers.num_brokers
        if brokers.size and (int(brokers.min()) < 0
                             or int(brokers.max()) >= nb):
            raise ValueError(f"broker ids out of [0, {nb}) for {channel}")
        sids = self._reg[channel].add(params, brokers)
        owner = partition.shard_for_sids(sids, self.num_shards)
        for i, e in enumerate(self.shards):
            mine = owner == i
            if not mine.any():
                continue
            with self._on(i):
                e.subscribe_bulk(channel, params[mine], brokers[mine],
                                 sids=sids[mine])
        return sids

    def remove_subscriptions(self, channel: str, sids: np.ndarray) -> int:
        gone = self._reg[channel].remove(np.asarray(sids))
        owner = partition.shard_for_sids(gone, self.num_shards)
        removed = 0
        for i, e in enumerate(self.shards):
            mine = owner == i
            if not mine.any():
                continue
            with self._on(i):
                removed += e.remove_subscriptions(channel, gone[mine])
        return removed

    def unsubscribe(self, channel: str, param: int, broker: str,
                    sid: int) -> bool:
        return self.remove_subscriptions(
            channel, np.asarray([sid], np.int32)) == 1

    def live_sids(self, channel: str) -> np.ndarray:
        """The registry's live population (sorted global sIDs)."""
        return self._reg[channel].live_sids()

    def shard_live_sids(self, channel: str) -> List[np.ndarray]:
        """Each shard's aggregator-held live sIDs (the shard-side truth the
        partition tests reconcile against the registry)."""
        return [np.sort(e.channels[channel].aggregator.live_sids())
                for e in self.shards]

    def set_user_locations(self, locations: np.ndarray,
                           brokers: Optional[np.ndarray] = None) -> None:
        locations = np.asarray(locations, np.float32)
        if brokers is None:
            brokers = np.zeros((locations.shape[0],), np.int32)
        self._user_brokers = np.asarray(brokers, np.int32)
        for i, e in enumerate(self.shards):
            with self._on(i):
                e.set_user_locations(locations, brokers)

    def subscribe_users(self, channel: str, user_ids: np.ndarray) -> int:
        uids = np.asarray(user_ids, dtype=np.int32).ravel()
        nu = int(self.shards[0].user_locations.shape[0])
        if uids.size and (int(uids.min()) < 0 or int(uids.max()) >= nu):
            raise ValueError(f"user ids out of [0, {nu})")
        owner = partition.shard_for_users(uids, self.num_shards)
        attached = 0
        for i, e in enumerate(self.shards):
            with self._on(i):
                # EVERY shard gets the call (possibly empty) so the first
                # one converts all shards to explicit-cohort semantics
                attached += e.subscribe_users(channel, uids[owner == i])
        self._cohorts.setdefault(channel, set()).update(
            int(u) for u in uids)
        return attached

    def unsubscribe_users(self, channel: str, user_ids: np.ndarray) -> int:
        uids = np.asarray(user_ids, dtype=np.int32).ravel()
        owner = partition.shard_for_users(uids, self.num_shards)
        detached = 0
        for i, e in enumerate(self.shards):
            mine = owner == i
            if not mine.any():
                continue
            with self._on(i):
                detached += e.unsubscribe_users(channel, uids[mine])
        cohort = self._cohorts.get(channel)
        if cohort is not None:
            cohort.difference_update(int(u) for u in uids)
        return detached

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------

    def ingest(self, batch: R.RecordBatch) -> np.ndarray:
        """Every shard ingests the batch into its own dataset and index.
        The batch is copied once to each distinct shard device it is not
        on (not once per shard); returns shard 0's row ids."""
        on_dev: Dict[torch.device, R.RecordBatch] = {}
        rows = None
        for i, e in enumerate(self.shards):
            b = on_dev.get(e.device)
            if b is None:
                b = batch if batch.fields.device == e.device else \
                    R.RecordBatch(batch.fields.to(e.device),
                                  batch.location.to(e.device),
                                  batch.host_fields)
                on_dev[e.device] = b
            with self._on(i):
                got = e.ingest(b)
            if i == 0:
                rows = got
        return rows

    def execute_all(self, flags: Optional[plans.ExecutionFlags] = None,
                    advance: bool = True, timed: bool = True,
                    deliver: bool = False
                    ) -> Dict[str, ShardedExecutionReport]:
        """One tick on every shard: each shard's fused ``execute_all`` over
        its local subscriptions (plan-groups, rings and caches per shard),
        merged per channel. With ``route_cross_shard`` the delivered notify
        sIDs are then regrouped onto their broker-owner shards.

        Synchronous facade over ``dispatch_all(...).sync()``: every shard
        dispatches before any shard's results are read (shards on one card
        still serialize on the host reads inside each ``dispatch``)."""
        return self.execute(plans.ExecutionRequest(
            flags=flags, advance=advance, timed=timed, deliver=deliver))

    def execute(self, request: plans.ExecutionRequest
                ) -> Dict[str, ShardedExecutionReport]:
        """Run one ``ExecutionRequest`` on every shard: ``dispatch`` then
        ``sync()``, the single execution surface of ``BADEngine``."""
        return self.dispatch(request).sync()

    def dispatch_all(self, flags: Optional[plans.ExecutionFlags] = None,
                     advance: bool = True, timed: bool = False,
                     deliver: bool = False,
                     resolve_spills: bool = False
                     ) -> ShardedPendingExecution:
        """``dispatch`` under the keyword surface of ``execute_all``."""
        return self.dispatch(plans.ExecutionRequest(
            flags=flags, advance=advance, timed=timed, deliver=deliver,
            resolve_spills=resolve_spills))

    def dispatch(self, request: plans.ExecutionRequest
                 ) -> ShardedPendingExecution:
        """Dispatch every shard's plan-group work without reading its
        outputs; the returned handle's ``sync()`` materializes and merges
        the per-channel reports (and runs the cross-shard notify route)."""
        pends = []
        for i, e in enumerate(self.shards):
            with self._on(i):
                pends.append(e.dispatch(request))
        return ShardedPendingExecution(self, pends, request.deliver)

    def _merge_reports(self, per_shard: List[Dict]
                       ) -> Dict[str, ShardedExecutionReport]:
        merged: Dict[str, ShardedExecutionReport] = {}
        for name in self._specs:
            reps = [r[name] for r in per_shard if name in r]
            if not reps:
                continue
            overflow = None
            if any(r.overflow is not None for r in reps):
                overflow = DeliveryStats(0, 0, 0, 0, 0, 0)
                for r in reps:
                    if r.overflow is not None:
                        overflow = overflow.merged(r.overflow)
            merged[name] = ShardedExecutionReport(
                channel=name,
                num_results=sum(r.num_results for r in reps),
                num_notified=sum(r.num_notified for r in reps),
                scanned=sum(r.scanned for r in reps),
                wall_time_s=sum(r.wall_time_s for r in reps),
                overflow=overflow,
                per_shard=reps)
        return merged

    def _route(self, merged: Dict[str, ShardedExecutionReport]) -> None:
        """The notify shuffle of every delivered channel: the reports' host
        notify buffers, stacked (S, max_notify) and fixed-width (-1 padded
        past the delivered prefix, so the shapes are tick-stable), are
        uploaded once to shard 0's device, each live sID's owner shard is
        looked up there in the registry's broker table (owners from
        ``partition.broker_owner`` on the host, one entry a registered sID
        or user), and ``shuffle_notify`` regroups them on the shards'
        devices. ``routed`` is the (S, S*max_notify) int32 result on the
        host."""
        home = self.shard_device(0)
        devices = [self.shard_device(i) for i in range(self.num_shards)]
        for name, rep in merged.items():
            if any(r.notify is None for r in rep.per_shard):
                continue
            sids = torch.from_numpy(np.stack(
                [np.asarray(r.notify, np.int32) for r in rep.per_shard]))
            sids = sids.to(home)
            if self._specs[name].join == "spatial":
                table = self._user_brokers
            else:
                reg = self._reg[name]
                table = reg.brokers[:reg.next_sid]
            owner_of = torch.from_numpy(
                partition.broker_owner(table, self.num_shards)).to(home)
            live = sids >= 0
            if owner_of.numel():
                owners = torch.where(
                    live, owner_of[torch.where(live, sids, 0).long()], -1)
            else:
                owners = torch.full_like(sids, -1)
            rep.routed = collectives.shuffle_notify(
                devices, sids, owners.to(torch.int32)).cpu().numpy()

    # ------------------------------------------------------------------
    # overflow surface
    # ------------------------------------------------------------------

    def ring_pending_pairs(self) -> int:
        return sum(e.ring_pending_pairs() for e in self.shards)

    def ring_pending_sids(self) -> int:
        return sum(e.ring_pending_sids() for e in self.shards)

    def flush_rings(self) -> None:
        for i, e in enumerate(self.shards):
            with self._on(i):
                e.flush_rings()

    def drain_spilled(self) -> Dict[str, DrainReport]:
        """One drain round on every shard. Keys are suffixed with the shard
        (``chan@s0``) when there are several, so no shard's DrainReport
        shadows another's; readers that fold over ``.values()`` (the churn
        driver) are unaffected."""
        out: Dict[str, DrainReport] = {}
        for i, e in enumerate(self.shards):
            with self._on(i):
                for name, rep in e.drain_spilled().items():
                    key = name if self.num_shards == 1 else f"{name}@s{i}"
                    out[key] = rep
        return out

    # ------------------------------------------------------------------
    # resharding
    # ------------------------------------------------------------------

    def reshard(self, num_shards: int) -> Dict[str, DrainReport]:
        """Migrate to ``num_shards`` mid-stream, conservation-exactly.

        Every shard's retry ring flushes through its SpillQueue and the
        queues drain to empty against the OLD engines (correct epochs and
        tables: nothing is re-presented against a re-partitioned layout);
        the accumulated DrainReports are returned so callers keep the
        delivered content and counts. Then fresh engines are built at the
        new count: the replicated data plane (dataset, BAD index,
        watermarks, clock, user locations) is copied from shard 0 into each
        new shard, which owns its copy (ingest updates it in place), and
        the live subscription population re-partitions from the host
        registry under the new hash with its ORIGINAL global sIDs."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        drained: Dict[str, DrainReport] = {}
        for i, e in enumerate(self.shards):
            with self._on(i):
                e.flush_rings()
                rounds = 0
                while e.spill.pending_pairs() + e.spill.pending_sids() > 0:
                    for name, rep in e.drain_spilled().items():
                        drained[f"{name}@s{i}#r{rounds}"] = rep
                    rounds += 1
        src = self.shards[0]
        locations, user_brokers = src._user_host
        exec_marks = {name: (src.channels[name].last_exec_ts,
                             src.channels[name].last_exec_size)
                      for name in self._specs}
        self.num_shards = num_shards
        self.shards = [self._make_engine(i) for i in range(num_shards)]
        self.spill = _SpillView(self)
        for i, e in enumerate(self.shards):
            with self._on(i):
                e.now = src.now
                e.set_user_locations(locations, user_brokers)
                for spec in self._specs.values():
                    e.create_channel(spec)
                # channels first: every create_channel re-shapes the BAD
                # index, so the copied rows must land on the final
                # C-channel layout (identical creation order -> identical
                # row assignment)
                e.dataset = _copy_state(src.dataset, e.device)
                e.index_state = _copy_state(src.index_state, e.device)
                e.size_host = src.size_host     # host mirror follows
                for name in self._specs:
                    ts, size = exec_marks[name]
                    e.channels[name].last_exec_ts = ts
                    e.channels[name].last_exec_size = size
        for name, reg in self._reg.items():
            sids = reg.live_sids()
            owner = partition.shard_for_sids(sids, num_shards)
            for i, e in enumerate(self.shards):
                mine = sids[owner == i]
                if not mine.size:
                    continue
                with self._on(i):
                    e.subscribe_bulk(name, reg.params[mine],
                                     reg.brokers[mine], sids=mine)
        for name, cohort in self._cohorts.items():
            uids = np.fromiter(sorted(cohort), np.int32, count=len(cohort))
            owner = partition.shard_for_users(uids, num_shards)
            for i, e in enumerate(self.shards):
                with self._on(i):
                    e.subscribe_users(name, uids[owner == i])
        for name, plan in self._plans.items():
            for i, e in enumerate(self.shards):
                with self._on(i):
                    e.set_plan(name, plan)
        return drained
