"""BADEngine: the host-side orchestrator tying the data plane together.

Responsibilities (paper Fig. 1): data feed ingestion -> ActiveDataset append +
conditionsList evaluation + BAD-index maintenance; channel execution under a
chosen ``ExecutionFlags`` / ``ChannelPlan``; broker accounting; subscription
control plane (Algorithm 1 grouping + UserParameters upkeep).

Two execution surfaces, as in the reference engine:

- ``execute_channel`` runs one channel on any backend. On the compact
  backends it runs the C == 1 compacted stream, with the stream capacity
  grown to the live total's power of two when it would overflow.
- ``execute_all`` / ``execute`` run EVERY channel in one fused call per
  plan-group: channels sharing a ``ChannelPlan`` (``set_plan`` or the engine
  default) share stacked candidate discovery, the stacked param and spatial
  joins (or the compacted stream join) and ``deliver_all``. With
  ``deliver=True``, pairs and sIDs that miss a delivery buffer land first in
  the plan-group's device-resident ``RetryRing`` and are re-delivered inside
  the next fused call; only overflow past the ring cascades, with its
  channel identity, into the bounded host-side ``SpillQueue``, which
  ``drain_spilled()`` re-delivers exactly once on later ticks. Ring pairs
  whose channel churned go epoch-stale and drop (counted). Per stage,
  delivered + spilled + dropped == produced == fresh + retried.

``execute`` is ``dispatch(request).sync()``: ``dispatch`` / ``dispatch_all``
enqueue every plan-group's work on the engine's CUDA stream and return a
``runtime.PendingExecution`` whose ``sync()`` is the first host read of the
outputs, ONE device->host copy per join group (``_host_arrays``). A
plan-group's dispatch has two host sync points, both documented on
``dispatch``: the ``bad_index`` shape bucket and the compact backends' live
total. The reports' ``result`` tensors stay on the engine's device.
``ExecutionRequest(resolve_spills=True)`` captures overflowed pairs into the
SpillQueue's epoch-free resolved lane against the dispatch-time sID tables,
which ``core/runtime.TickPipeline`` needs when it defers a sync past churn.

``use_pallas=True`` (the ``"pallas"`` family) routes predicate evaluation
through the ``predicate_filter`` CUDA kernel (ingest, and the fused
discovery's stacked rows form), spatial joins through ``spatial_match``
(stacked in the fused join) and the compacted param join's pair expansion
through ``join_compact`` (``"compact_pallas"``); ``"oracle"`` runs the plain
PyTorch versions. On a CPU engine the kernels' wrappers run their plain
versions (see ``repro_torch/kernels``).

The fused path's stacked caches (group slots, flat slots, per-channel
spatial cohorts) follow the reference's epoch/delta protocol: an epoch move
patches the touched rows in place (``index_copy_`` / ``index_put_`` of the
rows the aggregator or cohort reports, one host->device copy per patched
channel), and a delta gap, a whole-table delta, exceeded padded capacity, a
changed group cap, a user-version bump, cohort creation or
``incremental=False`` rebuilds. ``maintenance.patches`` and ``rebuilds``
count as the reference's do.

An enrichment stage (``core/enrich.py``, ``set_enrichment``) scores each
join group's candidate slots between the join and ``deliver_all`` on fused
runs with delivery and drops the lowest-scored pairs past its per-channel
budget (counted in ``DeliveryStats.ranked_*``); its ``identity`` is stamped
into every executed plan, so rings and stream buckets key on the scorer.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bad_index as bidx
from repro_torch.core import enrich
from repro_torch.core import plans
from repro_torch.core import records as R
from repro_torch.core import subscriptions as subs
from repro_torch.core import trace
from repro_torch.core.broker import (BrokerRegistry, DeliveryStats,
                                     FusedDelivery, RetryRing, RingCounters,
                                     clear_dead_lines, deliver_all,
                                     empty_ring, fanout_sids, pack_payloads,
                                     resolve_pair_sids)
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.predicates import (EQ, CompiledConditions,
                                         compile_conditions,
                                         evaluate_conditions)
from repro_torch.core.user_params import UserParameters
from repro_torch.device import DeviceLike, resolve_device

I32 = torch.int32


@dataclasses.dataclass
class MaintenanceStats:
    """Counters for the epoch/delta maintenance machinery.

    ``rebuilds`` counts full stacked-cache rebuilds and ``patches`` in-place
    delta patch applications (one per patched channel), as in the
    reference. Steady-state churn shows ``patches`` advancing while
    ``rebuilds`` stays flat."""

    rebuilds: int = 0
    patches: int = 0

    def snapshot(self) -> "MaintenanceStats":
        return dataclasses.replace(self)

    def since(self, prior: "MaintenanceStats") -> "MaintenanceStats":
        return MaintenanceStats(self.rebuilds - prior.rebuilds,
                                self.patches - prior.patches)


class UserCohort:
    """Stable-slot set of global user ids subscribed to ONE spatial channel.

    Slot index == row in that channel's stacked user set (and the pair
    target index its results carry), so cohort churn patches device rows in
    place exactly like the Aggregator's group slots; freed slots are reused
    (last freed, first reused), never leaked into padded capacity."""

    def __init__(self):
        self._uids: List[int] = []          # per slot; -1 when free
        self._slot: Dict[int, int] = {}     # live uid -> slot
        self._free: List[int] = []

    @property
    def num_slots(self) -> int:
        return len(self._uids)

    @property
    def num_users(self) -> int:
        return len(self._slot)

    def add(self, uids: np.ndarray) -> set:
        """Attach users; returns the slots touched (already-present ids are
        no-ops)."""
        touched = set()
        for u in np.asarray(uids, dtype=np.int32).ravel().tolist():
            if u in self._slot:
                continue
            if self._free:
                s = self._free.pop()
                self._uids[s] = u
            else:
                s = len(self._uids)
                self._uids.append(u)
            self._slot[u] = s
            touched.add(s)
        return touched

    def remove(self, uids: np.ndarray) -> set:
        touched = set()
        for u in np.asarray(uids, dtype=np.int32).ravel().tolist():
            s = self._slot.pop(u, None)
            if s is not None:
                self._uids[s] = -1
                self._free.append(s)
                touched.add(s)
        return touched

    def slot_uids(self) -> np.ndarray:
        """(num_slots,) int32 uid per slot, -1 holes."""
        return np.asarray(self._uids, dtype=np.int32).reshape(-1)


@dataclasses.dataclass
class ChannelState:
    spec: ChannelSpec
    index: int                      # row in the stacked conditionsList / BADIndexState
    aggregator: subs.Aggregator
    user_params: UserParameters
    # the channel's assigned physical plan; None runs the engine default.
    # ``execute_all(flags=None)`` partitions channels into plan-groups by it
    plan: Optional[plans.ChannelPlan] = None
    last_exec_ts: int = 0
    last_exec_size: int = 0
    executions: int = 0
    # ``epoch`` is a total order over this channel's subscription state:
    # bumped on EVERY control-plane change; it keys spill staleness and the
    # epoch-tracked stacked caches. ``delta_log`` holds the (epoch,
    # GroupDelta) records a cache at epoch e applies to catch up; any gap
    # (log overflow, out-of-band mutation) rebuilds that cache instead.
    epoch: int = 0
    delta_log: Deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=64))
    # spatial channels: explicit subscriber cohort (None = every user), with
    # its own epoch and delta log of touched slots
    cohort: Optional[UserCohort] = None
    user_epoch: int = 0
    user_delta_log: Deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=64))
    # device TargetArrays + host group/flat views, cached per channel and
    # dropped whenever the subscription set changes
    _targets_flat: Optional[plans.TargetArrays] = None
    _targets_grouped: Optional[plans.TargetArrays] = None
    _groups: Optional[subs.SubscriptionGroups] = None
    _flat: Optional[subs.SubscriptionTable] = None
    _host_targets: Dict[bool, Tuple] = dataclasses.field(default_factory=dict)
    # device sID tables by pair-target layout, for drains and
    # ``fused_sids_table`` (uploaded once per epoch)
    _sid_tables: Dict = dataclasses.field(default_factory=dict)
    # a cohort channel's device (locs, brokers, slot->uid table), keyed by
    # (user_epoch, user version)
    _cohort_users: Optional[Tuple] = None

    def note_change(self) -> None:
        """Advance the epoch and log the aggregator's accumulated delta so
        the stacked caches can patch in place instead of rebuilding."""
        delta = self.aggregator.take_delta()
        self.epoch += 1
        self.delta_log.append((self.epoch, delta))
        self._drop_host_caches()

    def note_user_change(self, touched_slots: set) -> None:
        """Cohort churn: slots remap, so spatial pair spills go stale (epoch
        bump) and the stacked user-set cache gets a patchable delta."""
        self.epoch += 1
        self.user_epoch += 1
        self.user_delta_log.append((self.user_epoch,
                                    frozenset(touched_slots)))
        self._drop_host_caches()

    def invalidate_targets(self) -> None:
        """Out-of-band invalidation (no delta recorded): every epoch-tracked
        cache sees the gap and rebuilds."""
        self.aggregator.take_delta()
        self.epoch += 1
        self._drop_host_caches()

    def _drop_host_caches(self) -> None:
        self._targets_flat = self._targets_grouped = None
        self._groups = self._flat = None
        self._host_targets = {}
        self._sid_tables = {}
        self._cohort_users = None


@dataclasses.dataclass
class _GroupCache:
    """Epoch-tracked stacked device targets of one param join group.

    Capacity-padded (tmax slots / dmax domain / mmax fan-out / cap members)
    to shared power-of-two buckets; -1 / 0 padding never forms a valid pair.
    Group deltas patch rows of these tensors in place, and ``epochs``
    records the per-channel subscription epoch they reflect."""

    names: Tuple[str, ...]
    aggregated: bool
    epochs: List[int]
    tmax: int
    dmax: int
    mmax: int
    cap: int
    targets: plans.TargetArrays
    up_masks: torch.Tensor          # (C, dmax) bool
    domains: torch.Tensor           # (C,) int32
    sids: torch.Tensor              # (C, tmax, cap) int32


@dataclasses.dataclass
class _SpatialCache:
    """Epoch-tracked stacked per-channel user sets of one spatial join
    group; cohort deltas patch slot rows in place. ``identity`` is True
    when every channel serves the full global user set: delivery then uses
    the 0-width identity fanout."""

    names: Tuple[str, ...]
    user_version: int
    cohorted: Tuple[bool, ...]
    epochs: List[int]               # per-channel user_epoch reflected
    ub: int
    locs: torch.Tensor              # (C, ub, 2) float32, -FAR holes
    brokers: torch.Tensor           # (C, ub) int32
    uids: torch.Tensor              # (C, ub) int32 global uid per slot, -1 holes

    @property
    def identity(self) -> bool:
        return not any(self.cohorted)


class SpillQueue:
    """Bounded host-side capture of overflowed notifications.

    Two lanes, mirroring the broker's two delivery stages: *pairs* (result
    pairs that missed the convert-stage wire buffer, keyed by channel and
    target LAYOUT — False = flat rows, True = compacted group rows,
    "slot" = aggregator slot rows — so a drain re-packs against the right
    table) and *sids* (end-subscriber ids that missed the send-stage notify
    buffer). Entries keep their channel identity; each lane is bounded by
    ``capacity`` — pushes past it are rejected (the caller counts them as
    dropped, so nothing is ever lost *silently*).

    Pair entries record the channel's subscription EPOCH at spill time:
    target indices are only meaningful against the table they were produced
    from, so a drain discards (and counts as dropped) entries whose channel
    churned in between. Raw sIDs never go stale.

    A third *resolved* lane holds pairs whose target->sID fanout was already
    resolved against the producing call's OWN table (the pipelined runtime
    materializes stats ticks after dispatch, when the live table may have
    churned past the dispatch-time epoch — resolving at capture time makes
    the entry epoch-free, so deferred batched drains deliver the identical
    multiset as the synchronous path). Resolved entries share the pairs
    lane's capacity budget and never go stale.
    """

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._pairs: Dict[Tuple[str, bool], Deque] = {}
        self._sids: Dict[str, Deque] = {}
        self._resolved: Dict[str, Deque] = {}
        self._n_pairs = 0
        self._n_sids = 0

    def push_pairs(self, channel: str, aggregated: bool, rows: np.ndarray,
                   targets: np.ndarray, version: int) -> int:
        """Append up to the remaining capacity; returns entries accepted."""
        n = min(len(rows), self.capacity - self._n_pairs)
        if n > 0:
            q = self._pairs.setdefault((channel, aggregated),
                                       collections.deque())
            q.append((np.asarray(rows[:n]), np.asarray(targets[:n]), version))
            self._n_pairs += n
        return max(n, 0)

    def _push_front_pairs(self, channel: str, aggregated: bool,
                          rows: np.ndarray, targets: np.ndarray,
                          version: int) -> None:
        """Requeue a just-popped tail at the FRONT (drain order preserved,
        no capacity check — the pop already released the room)."""
        if len(rows):
            q = self._pairs.setdefault((channel, aggregated),
                                       collections.deque())
            q.appendleft((np.asarray(rows), np.asarray(targets), version))
            self._n_pairs += len(rows)

    def pop_pairs(self, channel: str, aggregated: bool, n: int,
                  current_version: Optional[int]
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Remove up to ``n`` entries in FIFO order. Entries whose version no
        longer matches ``current_version`` are discarded and counted in the
        returned ``stale`` (they index a table that no longer exists).
        Returns (rows, targets, stale)."""
        q = self._pairs.get((channel, aggregated))
        rows, tgts, stale, taken = [], [], 0, 0
        while q and taken < n:
            r, t, v = q.popleft()
            take = min(len(r), n - taken)
            if take < len(r):
                q.appendleft((r[take:], t[take:], v))
            self._n_pairs -= take
            if v != current_version:
                stale += take
            else:
                rows.append(r[:take])
                tgts.append(t[:take])
            taken += take
        if q is not None and not q:
            del self._pairs[(channel, aggregated)]
        cat = lambda xs: (np.concatenate(xs) if xs
                          else np.zeros((0,), np.int32))
        return cat(rows), cat(tgts), stale

    def push_resolved(self, channel: str, rows: np.ndarray,
                      targets: np.ndarray, sid_rows: np.ndarray) -> int:
        """Append pre-resolved (row, target, sID-row) entries up to the
        remaining PAIR capacity; returns entries accepted. ``sid_rows`` is
        the (n, w) slice of the producing call's sID table for these
        targets (w >= 1; -1 padding never fans out)."""
        n = min(len(rows), self.capacity - self._n_pairs)
        if n > 0:
            q = self._resolved.setdefault(channel, collections.deque())
            q.append((np.asarray(rows[:n]), np.asarray(targets[:n]),
                      np.asarray(sid_rows[:n])))
            self._n_pairs += n
        return max(n, 0)

    def _push_front_resolved(self, channel: str, rows: np.ndarray,
                             targets: np.ndarray,
                             sid_rows: np.ndarray) -> None:
        if len(rows):
            q = self._resolved.setdefault(channel, collections.deque())
            q.appendleft((np.asarray(rows), np.asarray(targets),
                          np.asarray(sid_rows)))
            self._n_pairs += len(rows)

    def pop_resolved(self, channel: str, n: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Remove up to ``n`` resolved entries in FIFO order; sID rows from
        entries of different widths are right-padded with -1 to the widest.
        Returns (rows, targets, sid_rows)."""
        q = self._resolved.get(channel)
        rows, tgts, srows, taken = [], [], [], 0
        while q and taken < n:
            r, t, s = q.popleft()
            take = min(len(r), n - taken)
            if take < len(r):
                q.appendleft((r[take:], t[take:], s[take:]))
            self._n_pairs -= take
            rows.append(r[:take])
            tgts.append(t[:take])
            srows.append(s[:take])
            taken += take
        if q is not None and not q:
            del self._resolved[channel]
        if not rows:
            return (np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                    np.zeros((0, 1), np.int32))
        w = max(s.shape[1] for s in srows)
        srows = [np.pad(s, ((0, 0), (0, w - s.shape[1])), constant_values=-1)
                 if s.shape[1] < w else s for s in srows]
        return (np.concatenate(rows), np.concatenate(tgts),
                np.concatenate(srows))

    def push_sids(self, channel: str, sids: np.ndarray) -> int:
        n = min(len(sids), self.capacity - self._n_sids)
        if n > 0:
            self._sids.setdefault(channel, collections.deque()).append(
                np.asarray(sids[:n]))
            self._n_sids += n
        return max(n, 0)

    def _push_front_sids(self, channel: str, sids: np.ndarray) -> None:
        if len(sids):
            self._sids.setdefault(channel, collections.deque()).appendleft(
                np.asarray(sids))
            self._n_sids += len(sids)

    def pop_sids(self, channel: str, n: int) -> np.ndarray:
        q = self._sids.get(channel)
        out, taken = [], 0
        while q and taken < n:
            s = q.popleft()
            take = min(len(s), n - taken)
            if take < len(s):
                q.appendleft(s[take:])
            self._n_sids -= take
            out.append(s[:take])
            taken += take
        if q is not None and not q:
            del self._sids[channel]
        return np.concatenate(out) if out else np.zeros((0,), np.int32)

    def pair_keys(self) -> List[Tuple[str, bool]]:
        return list(self._pairs.keys())

    def sid_keys(self) -> List[str]:
        return list(self._sids.keys())

    def resolved_keys(self) -> List[str]:
        return list(self._resolved.keys())

    def pending_pairs(self, channel: Optional[str] = None) -> int:
        if channel is None:
            return self._n_pairs
        return (sum(sum(len(r) for r, _, _ in q)
                    for (name, _), q in self._pairs.items()
                    if name == channel)
                + sum(len(r) for r, _, _ in self._resolved.get(channel, ())))

    def pending_sids(self, channel: Optional[str] = None) -> int:
        if channel is None:
            return self._n_sids
        return sum(len(s) for s in self._sids.get(channel, ()))

    def clear(self) -> None:
        self._pairs.clear()
        self._sids.clear()
        self._resolved.clear()
        self._n_pairs = self._n_sids = 0


@dataclasses.dataclass
class DrainReport:
    """One channel's ``drain_spilled`` round: ``stats`` accounts the retry
    (delivered = re-delivered this round, spilled = still queued, dropped =
    stale/unroutable); ``payload`` / ``notify`` are the re-packed wire buffer
    and re-sent sID buffer (delivered prefix meaningful), left on the
    engine's device: a slot-layout buffer of a 1M-subscription channel is
    hundreds of MB."""

    stats: DeliveryStats
    payload: Optional[torch.Tensor] = None
    notify: Optional[torch.Tensor] = None


@dataclasses.dataclass
class ExecutionReport:
    channel: str
    flags: plans.ExecutionFlags
    result: plans.ChannelResult
    wall_time_s: float
    num_results: int
    num_notified: int
    scanned: int
    broker_bytes: np.ndarray
    # the full plan (flags + backend) of a fused execution; None on the
    # per-channel ``execute_channel`` path
    plan: Optional[plans.ChannelPlan] = None
    # broker overflow accounting; None unless executed with ``deliver=True``
    overflow: Optional[DeliveryStats] = None
    # delivered wire buffers (delivered prefix meaningful), only on
    # ``execute_all(deliver=True)`` with ``debug_delivery_buffers`` set
    payload: Optional[np.ndarray] = None
    notify: Optional[np.ndarray] = None


@dataclasses.dataclass
class _PendingGroup:
    """One dispatched plan-group awaiting its host half: the group's outputs
    (device tensors, possibly still being computed), layouts and
    dispatch-time epoch snapshots for SpillQueue tagging, and, when spills
    are resolved, clones of the dispatch-time stacked sID tables: a later
    dispatch patches the live tables in place before this group syncs."""

    plan: plans.ChannelPlan
    param_chs: List
    spatial_chs: List
    res: tuple                       # (res_p, res_s, del_p, del_s)
    ranks: tuple                     # (rank_p, rank_s): (ranked pairs,
                                     # ranked sIDs) or None without a stage
    p_layout: object
    s_layout: object
    deliver: bool
    wall: float                      # timed wall; 0.0 when untimed
    t0: float
    p_epochs: List[int]
    s_epochs: List[int]
    p_sids: Optional[torch.Tensor] = None
    s_sids: Optional[torch.Tensor] = None


class BADEngine:
    def __init__(self,
                 dataset_capacity: int = 1 << 18,
                 index_capacity: int = 1 << 15,
                 max_window: int = 1 << 15,
                 max_candidates: int = 1 << 13,
                 frame_bytes: int = 40 * 1024,
                 schema: R.Schema = R.ENRICHED_TWEET_SCHEMA,
                 brokers: Tuple[str, ...] = ("BrokerA",),
                 use_pallas: bool = False,
                 group_cap: Optional[int] = None,
                 max_deliver_pairs: int = 1 << 12,
                 max_notify: int = 1 << 14,
                 deliver_payload_words: int = 8,
                 max_spill: int = 1 << 13,
                 spill_capacity: int = 1 << 16,
                 incremental: bool = True,
                 ring_capacity: int = 1 << 12,
                 enrichment: Optional[enrich.EnrichmentStage] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.schema = schema
        self.dataset = R.ActiveDataset.create(dataset_capacity, schema,
                                              self.device)
        self.index_capacity = index_capacity
        self.max_window = max_window
        self.max_candidates = max_candidates
        self.frame_bytes = frame_bytes
        self.group_cap = group_cap or subs.cap_from_frame_bytes(frame_bytes)
        self.brokers = BrokerRegistry.create(*brokers)
        self.channels: Dict[str, ChannelState] = {}
        self.use_pallas = use_pallas
        self.max_deliver_pairs = max_deliver_pairs
        self.max_notify = max_notify
        self.deliver_payload_words = deliver_payload_words
        # device-side spill capture buffer per delivery call and the
        # host-side bounded retry queue
        self.max_spill = max_spill
        self.spill = SpillQueue(spill_capacity)
        # device-resident retry rings, one per fused join group (keyed by
        # (kind, plan, membership)); 0 disables them (overflow goes straight
        # to the SpillQueue)
        self.ring_capacity = ring_capacity
        self._rings: Dict = {}
        self.ring_flush_drops = 0
        # surface delivered wire buffers on ExecutionReport (testing aid)
        self.debug_delivery_buffers = False
        # adaptive compacted-stream capacities (compact backends): pow2
        # buckets per (kind, plan, membership) key, grown to the live
        # total's bucket when a run would overflow and halved after
        # ``_STREAM_PATIENCE`` runs at <= half occupancy
        self._stream_buckets: Dict = {}
        self._stream_idle: Dict = {}
        # stacked device state of the fused path, per join group
        self._stacked_cache: Dict = {}
        # keys the stacked user sets; bumped by set_user_locations
        self._user_version = 0
        self.user_locations = torch.zeros((1, 2), dtype=torch.float32,
                                          device=self.device)
        self.user_brokers = torch.zeros((1,), dtype=I32, device=self.device)
        # host copies of the user tables: cohort rows are gathered on the
        # host without reading the device back
        self._user_host = (np.zeros((1, 2), np.float32),
                           np.zeros((1,), np.int32))
        self.now = 0
        # host mirror of dataset.size, maintained by ``ingest``: row ids and
        # watermarks are derived on the host, never read back from the device
        self.size_host = 0
        self._conds: Optional[CompiledConditions] = None
        self.index_state = bidx.BADIndexState.create(0, index_capacity,
                                                     self.device)
        self.incremental = incremental
        self.maintenance = MaintenanceStats()
        # post-join enrichment stage (core/enrich.py): scores the candidates
        # of each fused join group before delivery; its identity is stamped
        # into the executed plans, so rings and stream buckets key on it
        self.enrichment = enrichment

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------

    def create_channel(self, spec: ChannelSpec) -> None:
        if spec.name in self.channels:
            raise ValueError(f"channel {spec.name} exists")
        st = ChannelState(
            spec=spec,
            index=len(self.channels),
            aggregator=subs.Aggregator(self.group_cap),
            user_params=UserParameters.create(spec.param_domain),
            last_exec_ts=self.now,
        )
        st.last_exec_size = self.size_host
        self.channels[spec.name] = st
        self._rebuild_conditions()

    def drop_channel(self, name: str) -> None:
        del self.channels[name]
        survivors = sorted(self.channels.values(), key=lambda s: s.index)
        old_rows = [st.index for st in survivors]
        for i, st in enumerate(survivors):
            st.index = i
        self._rebuild_conditions(old_rows)

    def default_plan(self) -> plans.ChannelPlan:
        """The plan channels run under until one is assigned: the default
        ExecutionFlags with the engine's kernel backend."""
        return plans.ChannelPlan(
            backend="pallas" if self.use_pallas else "oracle")

    def channel_plan(self, name: str) -> plans.ChannelPlan:
        return self.channels[name].plan or self.default_plan()

    def set_plan(self, name: str, plan: plans.ChannelPlan) -> bool:
        """Assign a channel's physical plan; returns True when it changed.
        The NEXT ``execute_all(flags=None)`` partitions plan-groups from the
        new value; the old plan-group's retry ring migrates into the host
        SpillQueue (tagged with the layout it was produced under) and
        re-delivers through ``drain_spilled``."""
        if not isinstance(plan, plans.ChannelPlan):
            raise TypeError(f"expected ChannelPlan, got {type(plan)!r}")
        st = self.channels[name]
        if st.plan == plan:
            return False
        st.plan = plan
        return True

    def plan_assignment(self) -> Dict[str, plans.ChannelPlan]:
        """Every channel's effective plan (assigned or engine default)."""
        return {name: self.channel_plan(name) for name in self.channels}

    def set_enrichment(self,
                       stage: Optional[enrich.EnrichmentStage]) -> bool:
        """Attach (or detach, with None) the post-join enrichment stage;
        returns True when it changed. A host-side assignment, like
        ``set_plan``: the next fused execution stamps the stage's
        ``identity`` into every executed plan, so the previous plan-groups'
        retry rings migrate through the flush path into the host
        SpillQueue; nothing is lost or re-ranked across the switch."""
        if stage is not None and not callable(getattr(stage, "score", None)):
            raise TypeError(f"expected an EnrichmentStage, got {stage!r}")
        if self.enrichment is stage:
            return False
        self.enrichment = stage
        return True

    def subscribe(self, channel: str, param: int, broker: str = "BrokerA",
                  sid: Optional[int] = None) -> int:
        st = self.channels[channel]
        if not 0 <= param < st.user_params.domain:   # before any mutation
            raise ValueError(
                f"param {param} out of [0, {st.user_params.domain}) "
                f"for {channel}")
        bid = self.brokers.names[broker]
        sid = st.aggregator.add_subscription(param, bid, sid)
        st.user_params.add(param)
        st.note_change()
        return sid

    def subscribe_bulk(self, channel: str, params: np.ndarray,
                       brokers: np.ndarray,
                       sids: Optional[np.ndarray] = None) -> np.ndarray:
        """Bulk control-plane load through the vectorized ``aggregate`` path:
        Algorithm-1 grouping semantics with no per-subscription Python work.
        Returns the assigned sIDs (``sids`` assigns explicit ids)."""
        with trace.span("subscribe_bulk"):
            st = self.channels[channel]
            params = np.asarray(params, dtype=np.int32).ravel()
            brokers = np.asarray(brokers, dtype=np.int32).ravel()
            # validate BEFORE mutating
            if params.size and (int(params.min()) < 0
                                or int(params.max()) >= st.user_params.domain):
                raise ValueError(
                    f"params out of [0, {st.user_params.domain}) for "
                    f"{channel}")
            nb = self.brokers.num_brokers
            if brokers.size and (int(brokers.min()) < 0
                                 or int(brokers.max()) >= nb):
                raise ValueError(f"broker ids out of [0, {nb}) for {channel}")
            if self.incremental:
                sids = st.aggregator.add_bulk(params, brokers, sids)
                st.user_params.add_bulk(params)
                st.note_change()
            else:
                # the rebuild baseline: O(S) re-aggregation + invalidation
                sids = st.aggregator.rebuild_bulk(params, brokers, sids)
                st.user_params.add_bulk(params)
                st.invalidate_targets()
            return sids

    def unsubscribe(self, channel: str, param: int, broker: str, sid: int) -> bool:
        st = self.channels[channel]
        ok = st.aggregator.remove_subscription(param, self.brokers.names[broker], sid)
        if ok:
            st.user_params.remove(param)
            st.note_change()
        return ok

    def remove_subscriptions(self, channel: str, sids: np.ndarray) -> int:
        """Bulk removal by sID: UserParameters refcounts decremented for every
        subscription actually removed, one epoch bump. Unknown sIDs are
        ignored; returns the number removed."""
        with trace.span("remove_subscriptions"):
            st = self.channels[channel]
            params = st.aggregator.remove_bulk(np.asarray(sids))
            if params.size:
                st.user_params.remove_bulk(params)
                st.note_change()
            return int(params.size)

    def subscribe_users(self, channel: str, user_ids: np.ndarray) -> int:
        """Attach users to a spatial channel's cohort. The first call
        converts the channel from the all-users semantics to an explicit
        cohort holding exactly the given ids. Returns the number newly
        attached."""
        with trace.span("subscribe_users"):
            st = self.channels[channel]
            if st.spec.join != "spatial":
                raise ValueError(f"{channel} is not a spatial channel")
            uids = np.asarray(user_ids, dtype=np.int32).ravel()
            nu = self.user_locations.shape[0]
            if uids.size and (int(uids.min()) < 0 or int(uids.max()) >= nu):
                raise ValueError(f"user ids out of [0, {nu})")
            created = st.cohort is None
            if created:
                st.cohort = UserCohort()
            touched = st.cohort.add(uids)
            if touched or created:
                # creation alone changes semantics (all users -> explicit
                # cohort) and remaps the spill target space: bump even when
                # no id was new
                st.note_user_change(touched)
            return len(touched)

    def unsubscribe_users(self, channel: str, user_ids: np.ndarray) -> int:
        """Detach users from a spatial channel's cohort (no-op for ids not
        in it). Returns the number detached."""
        with trace.span("unsubscribe_users"):
            st = self.channels[channel]
            if st.cohort is None:
                return 0
            touched = st.cohort.remove(np.asarray(user_ids, dtype=np.int32))
            if touched:
                st.note_user_change(touched)
            return len(touched)

    def set_user_locations(self, locations: np.ndarray,
                           brokers: Optional[np.ndarray] = None) -> None:
        locations = np.array(locations, dtype=np.float32)
        if brokers is None:
            brokers = np.zeros((locations.shape[0],), dtype=np.int32)
        brokers = np.array(brokers, dtype=np.int32)
        self._user_host = (locations, brokers)
        self.user_locations = torch.as_tensor(
            locations, device=self.device).contiguous()
        self.user_brokers = torch.as_tensor(brokers, device=self.device)
        self._user_version += 1      # the stacked user sets rebuild

    # ------------------------------------------------------------------
    # data plane: ingestion
    # ------------------------------------------------------------------

    def _rebuild_conditions(self, old_rows: Optional[List[int]] = None) -> None:
        """Recompile the conditionsList and re-shape the BAD index.

        ``old_rows[i]`` is the *previous* index row of the channel now at row
        ``i`` — surviving channels keep their own buffers/watermarks by
        identity, not by position.
        """
        specs = sorted(self.channels.values(), key=lambda s: s.index)
        self._conds = compile_conditions([list(s.spec.fixed_preds) for s in specs])
        old = self.index_state
        new = bidx.BADIndexState.create(len(specs), self.index_capacity,
                                        self.device)
        if old_rows is None:  # channel append: surviving rows keep positions
            old_rows = list(range(min(old.num_channels, new.num_channels)))
        if not all(0 <= r < old.num_channels for r in old_rows):
            raise ValueError(f"bad BAD-index rows {old_rows}")
        if old_rows:
            src = torch.as_tensor(old_rows, dtype=torch.long,
                                  device=self.device)
            n = len(old_rows)
            new.row_ids[:n] = old.row_ids[src]
            new.counts[:n] = old.counts[src]
            new.watermarks[:n] = old.watermarks[src]
            new.overflowed[:n] = old.overflowed[src]
        self.index_state = new
        # stream buckets re-converge; stacked caches track per-channel
        # epochs, and a same-named channel re-created at epoch 0 would
        # collide, so they go too
        self._stream_buckets.clear()
        self._stream_idle.clear()
        self._stacked_cache.clear()
        # retry rings are shaped by the channel set: hand their entries to
        # the host queue (dropped channels drop at drain time, counted)
        self.flush_rings()

    def ingest(self, batch: R.RecordBatch) -> np.ndarray:
        """Data feed entry point: append + BAD-index maintenance (Algorithm 2).

        Row ids and the ``now`` watermark are derived on the host: ``append``
        assigns ``size + arange(n)``, ``size_host`` mirrors the device size
        exactly, and timestamps come from the batch's host copy, so ingest
        never reads a device value back. The dataset and the BAD index are
        updated in place."""
        if batch.fields.device != self.device:
            raise ValueError(f"batch on {batch.fields.device}, engine on "
                             f"{self.device}")
        if batch.host_fields is None:
            raise ValueError("ingest reads timestamps from the batch's host "
                             "copy: build it with RecordBatch.from_numpy")
        n = batch.num_records
        with trace.span("ingest"):
            row_ids = np.arange(self.size_host, self.size_host + n,
                                dtype=np.int32)
            dev_rows = R.append(self.dataset, batch)
            if self.use_pallas:
                from repro_torch.kernels.predicate_filter import ops as pf_ops
                matches = pf_ops.predicate_filter(batch.fields, self._conds)
            else:
                matches = evaluate_conditions(batch.fields, self._conds)
            self._make_room(matches)
            bidx.insert(self.index_state, dev_rows, matches)
            self.size_host += n
            if n:
                self.now = max(self.now,
                               int(batch.host_fields[:, R.TIMESTAMP].max()))
            return row_ids

    @property
    def index_state(self) -> bidx.BADIndexState:
        return self._index_state

    @index_state.setter
    def index_state(self, state: bidx.BADIndexState) -> None:
        # a new state (a channel created or dropped, state installed):
        # its counts are unknown until ``_make_room`` reads them
        self._index_state = state
        self._index_bound = None
        self._index_full = frozenset()

    def _make_room(self, matches: torch.Tensor) -> None:
        """Keep the BAD index from dropping entries it need not: a host
        bound on the largest count of the channels that are not full grows
        by the batch's rows each insert; only when it could pass the
        capacity does ``bidx.make_room`` read the counts back and shift the
        executed channels' live windows to the front (the LSM merge of
        paper §4.3). A full channel (watermark 0: nothing to shift) stays
        out of the bound until an execution moves its watermark
        (``_advanced``), so it costs one read when it fills, not one an
        ingest."""
        n = matches.shape[0]
        bound = self._index_bound
        if bound is not None and bound + n <= self._index_state.capacity:
            self._index_bound = bound + n
            return
        bound, full = bidx.make_room(self._index_state, matches)
        self._index_bound, self._index_full = bound, frozenset(full.tolist())

    def _advanced(self, rows) -> None:
        """The watermarks of these index rows moved: a full one among them
        can make room now, so the next ingest reads the counts."""
        if self._index_full.intersection(rows):
            self._index_bound = None

    # ------------------------------------------------------------------
    # data plane: channel execution
    # ------------------------------------------------------------------

    def _targets_host(self, st: ChannelState, aggregated: bool) -> Tuple:
        """Host-side (numpy) join targets: (params, brokers, counts, by_param,
        by_param_count)."""
        cached = st._host_targets.get(aggregated)
        if cached is not None:
            return cached
        if aggregated:
            groups = st._groups or st.aggregator.build()
            st._groups = groups
            params = np.asarray(groups.group_params, np.int32)
            brokers = np.asarray(groups.group_brokers, np.int32)
            counts = np.asarray(groups.group_counts, np.int32)
        else:
            flat = self._flat_table(st)
            params = np.asarray(flat.params, np.int32)
            brokers = np.asarray(flat.brokers, np.int32)
            counts = np.ones_like(params)
        by_param, by_count = subs.param_to_targets(params, st.spec.param_domain)
        out = (params, brokers, counts, by_param, by_count)
        st._host_targets[aggregated] = out
        return out

    def _targets(self, st: ChannelState, aggregated: bool) -> plans.TargetArrays:
        cached = st._targets_grouped if aggregated else st._targets_flat
        if cached is None:
            cached = plans.TargetArrays(*(
                torch.as_tensor(a, device=self.device)
                for a in self._targets_host(st, aggregated)))
            if aggregated:
                st._targets_grouped = cached
            else:
                st._targets_flat = cached
        return cached

    def _flat_table(self, st: ChannelState) -> subs.SubscriptionTable:
        if st._flat is None:
            groups = st._groups or st.aggregator.build()
            st._groups = groups
            st._flat = subs.flatten_groups(groups)
        return st._flat

    def _cohort_rows(self, st: ChannelState, slots=None):
        """Host (locs, brokers, uids) rows for a cohort channel's slots:
        holes (and uids past the current user table) sit at the far
        sentinel / -1, so they can never match or fan out."""
        from repro_torch.kernels.spatial_match.ops import FAR
        uids = st.cohort.slot_uids()
        if slots is not None:
            uids = uids[slots]
        locs_h, brokers_h = self._user_host
        ok = (uids >= 0) & (uids < locs_h.shape[0])
        safe = np.where(ok, uids, 0)
        locs = np.where(ok[:, None], locs_h[safe], -FAR).astype(np.float32)
        brokers = np.where(ok, brokers_h[safe], 0).astype(np.int32)
        return locs, brokers, np.where(ok, uids, -1).astype(np.int32)

    def _cohort_device(self, st: ChannelState) -> Tuple[torch.Tensor,
                                                        torch.Tensor,
                                                        torch.Tensor]:
        """One cohort channel's device (locs, brokers, slot->uid table),
        cached on the ChannelState by (user_epoch, user version): the
        per-channel join and the delivery and drain paths read the same
        upload."""
        key = (st.user_epoch, self._user_version)
        if st._cohort_users is not None and st._cohort_users[0] == key:
            return st._cohort_users[1]
        locs, brokers, uids = self._cohort_rows(st)
        n = uids.shape[0]
        both = self._upload(np.concatenate(
            [locs.reshape(-1).view(np.int32), brokers, uids]))
        val = (both[:2 * n].view(torch.float32).reshape(n, 2),
               both[2 * n:3 * n], both[3 * n:][:, None])
        st._cohort_users = (key, val)
        return val

    def _channel_users(self, st: ChannelState) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
        """One channel's user set for the per-channel spatial join: the
        global tables without a cohort, else the cohort's slot-shaped rows
        (holes at the far sentinel, so slot indices, the pair targets, line
        up with the fused stacked rows)."""
        if st.spec.join != "spatial" or st.cohort is None:
            return self.user_locations, self.user_brokers
        return self._cohort_device(st)[:2]

    def _spatial_sids_table(self, st: ChannelState) -> Optional[torch.Tensor]:
        """Slot->uid delivery table of a cohort spatial channel ((U, 1), -1
        holes); None selects the identity fanout (no cohort: targets
        already ARE global user ids)."""
        if st.cohort is None:
            return None
        return self._cohort_device(st)[2]

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """One host->device copy of an int32 buffer, without blocking
        (``records.to_device``)."""
        return R.to_device(np.asarray(host, dtype=np.int32), self.device)

    def group_sids_array(self, channel: str, aggregated: bool) -> torch.Tensor:
        st = self.channels[channel]
        if aggregated:
            groups = st._groups or st.aggregator.build()
            st._groups = groups
            return torch.as_tensor(groups.group_sids, device=self.device)
        flat = self._flat_table(st)
        return torch.as_tensor(flat.sids, device=self.device)[:, None]

    def _discover_one(self, st: ChannelState, flags: plans.ExecutionFlags,
                      max_cand: int) -> plans.CandidateSet:
        """One channel's candidate discovery under the scan mode."""
        spec = st.spec
        conds_one = compile_conditions([list(spec.fixed_preds)])
        ds = self.dataset
        if flags.scan_mode == "full":
            return plans.candidates_full_scan(ds, conds_one, st.last_exec_ts,
                                              max_cand)
        if flags.scan_mode == "window":
            return plans.candidates_window(ds, conds_one, st.last_exec_size,
                                           self.max_window)
        if flags.scan_mode == "trad_index":
            return plans.candidates_trad_index(ds, conds_one, _best_pred(st),
                                               st.last_exec_size,
                                               self.max_window, max_cand)
        return plans.candidates_bad_index(ds, self.index_state, st.index,
                                          max_cand)

    def _run_plan(self, st: ChannelState, flags: plans.ExecutionFlags,
                  cand: plans.CandidateSet, backend: str,
                  targets: plans.TargetArrays, up_mask: torch.Tensor
                  ) -> plans.ChannelResult:
        """One channel's padded join (param or spatial) of ``cand``."""
        spec = st.spec
        num_brokers = self.brokers.num_brokers
        ds = self.dataset
        if spec.join == "spatial":
            spatial_fn = None
            if plans.backend_family(backend) == "pallas":
                from repro_torch.kernels.spatial_match import ops as sm_ops
                spatial_fn = sm_ops.spatial_match
            return plans.join_spatial(ds, cand, *self._channel_users(st),
                                      spec.spatial_radius,
                                      spec.payload_bytes, num_brokers,
                                      spatial_fn)
        return plans.join_param_targets(
            ds, cand, targets, spec.param_field, spec.payload_bytes,
            num_brokers, up_mask if flags.param_pushdown else None,
            flags.aggregation)

    def _run_compact_one(self, st: ChannelState, flags: plans.ExecutionFlags,
                         cand: plans.CandidateSet, backend: str,
                         targets: plans.TargetArrays, up_mask: torch.Tensor,
                         stream_cap: int) -> plans.ChannelResult:
        """One channel on a compact backend: the fused path's stream code
        run as a C == 1 compacted stream of ``stream_cap`` entries."""
        spec = st.spec
        num_brokers = self.brokers.num_brokers
        ds = self.dataset
        dev = self.device
        cand1 = plans.CandidateSet(*(t[None] for t in cand))
        stream = plans.compact_candidates(cand1, stream_cap)
        payload = torch.tensor([spec.payload_bytes], dtype=I32, device=dev)
        if spec.join == "spatial":
            locs, ubrokers = self._channel_users(st)
            sj = plans.join_spatial_stream(
                ds, stream, locs[None], ubrokers[None],
                torch.tensor([spec.spatial_radius], dtype=torch.float32,
                             device=dev), payload, num_brokers)
        else:
            join_fn = None
            if backend == "compact_pallas":
                from repro_torch.kernels.join_compact import ops as jc_ops
                join_fn = jc_ops.join_pairs
            scal = torch.tensor([spec.param_field, targets.by_param.shape[0]],
                                dtype=I32, device=dev)
            sj = plans.join_param_stream(
                ds, stream, plans.TargetArrays(*(t[None] for t in targets)),
                scal[0:1], payload, num_brokers,
                up_mask[None] if flags.param_pushdown else None,
                flags.aggregation, scal[1:2], join_fn)
        width = min(stream_cap, cand.rows.shape[0])
        res1 = plans.stream_to_stacked(sj, stream, cand1.scanned, width)
        return plans.ChannelResult(*(t[0] for t in res1))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _deliver(self, st: ChannelState, result: plans.ChannelResult,
                 aggregated: bool) -> DeliveryStats:
        """Run the broker convert+send stages on one channel's result (the
        fused ``deliver_all`` on a C == 1 stack), capture overflow into the
        spill queue, and account every pair/sID (delivered + spilled +
        dropped == produced, per stage)."""
        res1 = plans.ChannelResult(*(t[None] for t in result))
        counts = None
        if st.spec.join == "spatial":
            tbl = self._spatial_sids_table(st)
            if tbl is None:
                # spatial targets ARE end-user ids; a 0-wide table selects
                # the brokers' identity fanout
                sids = torch.zeros((1, 0), dtype=I32, device=self.device)
                tb = self.user_brokers[None]
            else:
                # cohort channel: targets are cohort SLOTS; the slot->uid
                # table maps them to global user ids, brokers follow the
                # cohort rows
                sids = tbl[None]
                tb = self._channel_users(st)[1][None]
        else:
            sids = self.group_sids_array(st.spec.name, aggregated)[None]
            targets = self._targets(st, aggregated)
            tb = targets.brokers[None]
            counts = targets.counts[None]
        d = deliver_all(res1, sids, self.deliver_payload_words,
                        self.max_deliver_pairs, self.max_notify,
                        self.max_spill, target_brokers=tb,
                        num_brokers=self.brokers.num_brokers, counts=counts)
        return self._spill_and_stats([st], aggregated,
                                     _host_arrays(_delivery_tensors(d)))[
                                         st.spec.name]

    def _spill_and_stats(self, chs: List[ChannelState], layout,
                         h: Dict[str, np.ndarray],
                         epochs: Optional[List[int]] = None,
                         resolve_tables: Optional[torch.Tensor] = None
                         ) -> Dict[str, DeliveryStats]:
        """Host side of a delivery, on its host copy ``h``
        (``_delivery_tensors``): push the captured flat spill streams into
        the SpillQueue per channel (entries past the queue's capacity, or
        past the device capture buffer, become counted drops) and assemble
        each channel's conserving DeliveryStats. ``layout`` tags the pair
        lane with the target index space the producing join used (False =
        flat rows, True = compacted group rows, "slot" / "flat_slot" =
        aggregator slot rows); ``epochs`` stamps pair entries with the
        dispatch-time epochs instead of the live ones. ``resolve_tables``
        (the dispatch-time stacked sID tables, on the device) switches pair
        capture to the epoch-free RESOLVED lane: each spilled pair's fanout
        is resolved here, against the table its producing call joined, so
        deferred batched drains cannot go stale. ``h`` may carry the
        enrichment stage's per-channel ``ranked_pairs`` / ``ranked_sids``:
        delivery saw the pruned result, so those pairs re-enter as counted
        drops."""
        pack_d, pack_p = h["pack_delivered"], h["pack_produced"]
        fan_d, fan_p = h["fan_delivered"], h["fan_produced"]
        per_broker = h["per_broker"]
        pvalid = h["pair_valid"]
        prows = h["pair_rows"][pvalid]
        pchan = h["pair_channels"][pvalid]
        ptgts = h["pair_targets"][pvalid]
        svalid = h["sid_valid"]
        svals = h["sid_values"][svalid]
        schan = h["sid_channels"][svalid]
        ring = "retried_pairs" in h
        rank_p = h.get("ranked_pairs", np.zeros(len(chs), np.int32))
        rank_s = h.get("ranked_sids", np.zeros(len(chs), np.int32))
        out: Dict[str, DeliveryStats] = {}
        for i, st in enumerate(chs):
            name = st.spec.name
            sel = pchan == i
            if resolve_tables is not None:
                rows_i, tgts_i = prows[sel], ptgts[sel]
                spilled_p = self.spill.push_resolved(
                    name, rows_i, tgts_i,
                    _resolve_rows(resolve_tables[i], tgts_i))
            else:
                epoch = st.epoch if epochs is None else epochs[i]
                spilled_p = self.spill.push_pairs(name, layout, prows[sel],
                                                  ptgts[sel], epoch)
            spilled_s = self.spill.push_sids(name, svals[schan == i])
            ov_p = int(pack_p[i] - pack_d[i])
            ov_s = int(fan_p[i] - fan_d[i])
            brokers = tuple(int(x) for x in per_broker[i])
            rk_p, rk_s = int(rank_p[i]), int(rank_s[i])
            if not ring:
                out[name] = DeliveryStats(
                    delivered_pairs=int(pack_d[i]), spilled_pairs=spilled_p,
                    dropped_pairs=ov_p - spilled_p + rk_p,
                    delivered_sids=int(fan_d[i]), spilled_sids=spilled_s,
                    dropped_sids=ov_s - spilled_s + rk_s,
                    delivered_pairs_broker=brokers,
                    ranked_pairs=rk_p, ranked_sids=rk_s)
                continue
            # ring-resident entries count as spilled; overflow past the ring
            # that also missed the queue (or went epoch-stale in the ring)
            # counts as dropped
            stale_p = int(h["stale_pairs"][i])
            ring_p, ring_s = int(h["ring_pairs"][i]), int(h["ring_sids"][i])
            host_want_p = ov_p - stale_p - ring_p
            host_want_s = ov_s - ring_s
            out[name] = DeliveryStats(
                delivered_pairs=int(pack_d[i]),
                spilled_pairs=ring_p + spilled_p,
                dropped_pairs=stale_p + host_want_p - spilled_p + rk_p,
                delivered_sids=int(fan_d[i]),
                spilled_sids=ring_s + spilled_s,
                dropped_sids=host_want_s - spilled_s + rk_s,
                delivered_pairs_broker=brokers,
                retried_pairs=int(h["retried_pairs"][i]),
                retried_sids=int(h["retried_sids"][i]),
                ranked_pairs=rk_p, ranked_sids=rk_s)
        return out

    def execute_channel(self, channel: str,
                        flags: plans.ExecutionFlags,
                        advance: bool = True,
                        timed: bool = True,
                        deliver: bool = False,
                        backend: Optional[str] = None) -> ExecutionReport:
        """Execute one channel under ``flags`` on any backend (default: the
        engine's). ``timed`` is accepted for the reference's signature:
        eager PyTorch has no trace to warm, so ``wall_time_s`` always times
        the execution itself, ending in a device synchronize on a CUDA
        engine. The compact backends run the C == 1 compacted stream, whose
        capacity grows to the live total's power of two when the remembered
        bucket would overflow (one host read of the total)."""
        st = self.channels[channel]
        backend = backend or ("pallas" if self.use_pallas else "oracle")
        if backend not in plans.BACKENDS:
            raise ValueError(f"backend must be one of {plans.BACKENDS}")
        # The BAD index knows its exact candidate count before execution (the
        # watermark delta), so downstream buffers are shape-bucketed to it.
        max_cand = self.max_candidates
        if flags.scan_mode == "bad_index":
            pending = int(self.index_state.counts[st.index]
                          - self.index_state.watermarks[st.index])
            max_cand = min(_pow2_bucket(pending, 6), self.max_candidates)
        targets = self._targets(st, flags.aggregation)
        up_mask = st.user_params.mask(self.device)
        self._sync()
        t0 = time.perf_counter()
        cand = self._discover_one(st, flags, max_cand)
        if plans.is_compact(backend):
            key = ("chan", channel, flags, st.spec.join == "spatial")
            width = (self.max_window if flags.scan_mode == "window"
                     else max_cand)
            stream_cap = min(self._stream_buckets.get(key, 1 << _STREAM_FLOOR),
                             _pow2_bucket(width, _STREAM_FLOOR))
            total = int(cand.valid.sum())     # the grow protocol's host read
            if total > stream_cap:
                stream_cap = _pow2_bucket(total, _STREAM_FLOOR)
            self._stream_buckets[key] = stream_cap
            result = self._run_compact_one(st, flags, cand, backend, targets,
                                           up_mask, stream_cap)
        else:
            result = self._run_plan(st, flags, cand, backend, targets,
                                    up_mask)
        self._sync()
        wall = time.perf_counter() - t0
        if advance:
            bidx.advance_watermark(self.index_state, st.index)
            self._advanced((st.index,))
            st.last_exec_ts = self.now
            st.last_exec_size = self.size_host
            st.executions += 1
        overflow = self._deliver(st, result, flags.aggregation) if deliver else None
        h = _host_arrays({"num_results": result.num_results,
                          "num_notified": result.num_notified,
                          "scanned": result.scanned,
                          "broker_bytes": result.broker_bytes})
        return ExecutionReport(
            channel=channel, flags=flags, result=result, wall_time_s=wall,
            num_results=int(h["num_results"]),
            num_notified=int(h["num_notified"]),
            scanned=int(h["scanned"]), broker_bytes=h["broker_bytes"],
            overflow=overflow)

    # ------------------------------------------------------------------
    # data plane: fused multi-channel execution
    # ------------------------------------------------------------------

    def _group_state(self, chs: List[ChannelState],
                     aggregated: bool) -> _GroupCache:
        """The fused path's stacked group state for one param join group,
        keyed by layout and membership and maintained by the epoch/delta
        protocol. Shapes are capacity-padded to shared power-of-two buckets
        (tmax slot rows / real max domain / mmax join fan-out); -1 / 0
        padding never forms a valid pair. On an epoch move the entry is
        PATCHED in place from the channels' group deltas (O(delta) host work
        and one host->device copy per changed channel); it rebuilds only
        when padded capacity is exceeded, a delta is unavailable (log gap,
        whole-table delta, out-of-band mutation), the channel set changed,
        or the engine runs with ``incremental=False``."""
        names = tuple(st.spec.name for st in chs)
        key = ("groups", aggregated, names)
        cache = self._stacked_cache.get(key)
        if cache is not None:
            if cache.epochs == [st.epoch for st in chs]:
                return cache
            if self.incremental:
                with trace.span("patch", layout="group" if aggregated
                                else "flat") as sp:
                    if aggregated:
                        patches = self._group_patches(cache, chs)
                        if patches is not None:
                            self._apply_group_patches(cache, chs, patches)
                    else:
                        patches = self._flat_patches(cache, chs)
                        if patches is not None:
                            self._apply_flat_patches(cache, chs, patches)
                    sp.set(applied=patches is not None)
                if patches is not None:
                    return cache
        with trace.span("rebuild", layout="group"):
            cache = self._build_group_state(chs, aggregated)
        self._stacked_put(key, cache)
        return cache

    def _stacked_put(self, key, cache, cap: int = 32) -> None:
        """Insert a stacked cache entry with FIFO eviction: plan switches
        re-group channels, and superseded groupings must not pin dead
        device tensors forever."""
        if key not in self._stacked_cache and len(self._stacked_cache) >= cap:
            self._stacked_cache.pop(next(iter(self._stacked_cache)))
        self._stacked_cache[key] = cache

    def _build_group_state(self, chs: List[ChannelState],
                           aggregated: bool) -> _GroupCache:
        """Stacked targets in the reference's three layouts: aggregator SLOT
        rows (aggregated, incremental), FLAT stable slots (flat,
        incremental; join-map rows positional with -1 holes) and the
        compacted ``build()`` rows (non-incremental)."""
        self.maintenance.rebuilds += 1
        names = tuple(st.spec.name for st in chs)
        n = len(chs)
        dmax = max(st.spec.param_domain for st in chs)
        if aggregated and self.incremental:
            hosts = [st.aggregator.slot_arrays() for st in chs]
            tmax = _pow2_bucket(max(h[0].shape[0] for h in hosts), 3)
            mmax = _pow2_bucket(
                max(st.aggregator.max_param_fanout() for st in chs), 3)
            cap = max(st.aggregator.cap for st in chs)
            by_param = np.full((n, dmax, mmax), -1, np.int32)
            by_count = np.zeros((n, dmax), np.int32)
            sids = np.full((n, tmax, cap), -1, np.int32)
            for i, (st, h) in enumerate(zip(chs, hosts)):
                for p, row in st.aggregator.param_items():
                    by_param[i, p, :len(row)] = row
                    by_count[i, p] = len(row)
                sids[i, :h[3].shape[0], :h[3].shape[1]] = h[3]
        elif self.incremental:
            hosts = [st.aggregator.flat_slot_arrays() for st in chs]
            tmax = _pow2_bucket(max(h[0].shape[0] for h in hosts), 3)
            mmax = _pow2_bucket(
                max(st.aggregator.max_flat_extent() for st in chs), 3)
            cap = 1
            by_param = np.full((n, dmax, mmax), -1, np.int32)
            by_count = np.zeros((n, dmax), np.int32)
            sids = np.full((n, tmax, cap), -1, np.int32)
            for i, (st, h) in enumerate(zip(chs, hosts)):
                for p, row in st.aggregator.flat_param_rows():
                    by_param[i, p, :len(row)] = row
                    by_count[i, p] = len(row)       # extent, holes masked
                sids[i, :h[3].shape[0], 0] = h[3]
        else:
            hosts2 = [self._targets_host(st, aggregated) for st in chs]
            hosts = [(h[0], h[1], h[2]) for h in hosts2]
            tmax = _pow2_bucket(max(h[0].shape[0] for h in hosts2), 3)
            mmax = _pow2_bucket(max(h[3].shape[1] for h in hosts2), 3)
            by_param = np.full((n, dmax, mmax), -1, np.int32)
            by_count = np.zeros((n, dmax), np.int32)
            srcs = []
            for st in chs:
                if aggregated:
                    groups = st._groups or st.aggregator.build()
                    st._groups = groups
                    srcs.append(np.asarray(groups.group_sids, np.int32))
                else:
                    srcs.append(np.asarray(self._flat_table(st).sids,
                                           np.int32)[:, None])
            cap = max(h.shape[1] for h in srcs)
            sids = np.full((n, tmax, cap), -1, np.int32)
            for i, (h2, h) in enumerate(zip(hosts2, srcs)):
                d, m = h2[3].shape
                by_param[i, :d, :m] = h2[3]
                by_count[i, :d] = h2[4]
                sids[i, :h.shape[0], :h.shape[1]] = h
        params = np.zeros((n, tmax), np.int32)
        brokers = np.zeros((n, tmax), np.int32)
        counts = np.zeros((n, tmax), np.int32)
        up_masks = np.zeros((n, dmax), bool)
        domains = np.zeros((n,), np.int32)
        for i, (st, (p, b, c, *_)) in enumerate(zip(chs, hosts)):
            t = p.shape[0]
            params[i, :t] = p
            brokers[i, :t] = b
            counts[i, :t] = c
            up_masks[i, :st.spec.param_domain] = st.user_params.refcount > 0
            domains[i] = st.spec.param_domain
        dev = self.device
        targets = plans.TargetArrays(*(
            torch.as_tensor(a, device=dev)
            for a in (params, brokers, counts, by_param, by_count)))
        return _GroupCache(names, aggregated, [st.epoch for st in chs],
                           tmax, dmax, mmax, cap, targets,
                           torch.as_tensor(up_masks, device=dev),
                           torch.as_tensor(domains, device=dev),
                           torch.as_tensor(sids, device=dev))

    @staticmethod
    def _delta_union(st_log, cached_e: int, now_e: int):
        """The delta records of epochs (cached_e, now_e] from a channel's
        log, or None on a gap."""
        if now_e - cached_e > len(st_log):
            return None              # gap certain: don't materialize it
        need = set(range(cached_e + 1, now_e + 1))
        out = [d for e, d in st_log if e in need]
        return out if len(out) == len(need) else None

    def _group_patches(self, cache: _GroupCache, chs: List[ChannelState]):
        """Per-channel (slots, params) patch sets covering every epoch since
        the cache's snapshot, or None if any channel must rebuild (delta
        gap, whole-table delta, or padded capacity exceeded)."""
        out = []
        for st, cached_e in zip(chs, cache.epochs):
            if st.epoch == cached_e:
                out.append(None)
                continue
            deltas = self._delta_union(st.delta_log, cached_e, st.epoch)
            if deltas is None or any(d.full for d in deltas):
                return None
            slots, params_t = set(), set()
            for d in deltas:
                slots |= d.slots
                params_t |= d.params
            agg = st.aggregator
            if agg.num_slots > cache.tmax or agg.cap != cache.cap:
                return None
            if any(len(agg.param_slots(p)) > cache.mmax for p in params_t):
                return None
            out.append((slots, params_t))
        return out

    def _apply_group_patches(self, cache: _GroupCache,
                             chs: List[ChannelState], patches) -> None:
        """Per changed channel: the touched slot rows and by-param rows are
        re-read from the aggregator (current content), packed into one int32
        buffer, uploaded once and written in place with ``index_copy_``
        (exact-length index tensors: the sorted unique slots and params)."""
        t = cache.targets
        for ci, (st, patch) in enumerate(zip(chs, patches)):
            if patch is None:
                continue
            slots, params_t = patch
            agg = st.aggregator
            sl = np.sort(np.fromiter(slots, np.int64, len(slots)))
            pl = np.asarray(sorted(params_t), np.int64)
            k, m = len(sl), len(pl)
            sl_p, sl_b, sl_c, sl_s = agg.slot_rows(sl)
            p_rows = np.full((m, cache.mmax), -1, np.int32)
            p_cnt = np.zeros((m,), np.int32)
            for j, p in enumerate(pl.tolist()):
                row = agg.param_slots(p)
                p_rows[j, :len(row)] = row
                p_cnt[j] = len(row)
            p_mask = (st.user_params.refcount[pl] > 0).astype(np.int32)
            dev = self._upload(np.concatenate(
                [sl, sl_p, sl_b, sl_c, sl_s.reshape(-1), pl,
                 p_rows.reshape(-1), p_cnt, p_mask]))
            parts = _split(dev, (k, k, k, k, k * cache.cap, m,
                                 m * cache.mmax, m, m))
            si, pi = parts[0].long(), parts[5].long()
            t.params[ci].index_copy_(0, si, parts[1])
            t.brokers[ci].index_copy_(0, si, parts[2])
            t.counts[ci].index_copy_(0, si, parts[3])
            cache.sids[ci].index_copy_(0, si, parts[4].view(k, cache.cap))
            t.by_param[ci].index_copy_(0, pi, parts[6].view(m, cache.mmax))
            t.by_param_count[ci].index_copy_(0, pi, parts[7])
            cache.up_masks[ci].index_copy_(0, pi, parts[8].bool())
            self.maintenance.patches += 1
        cache.epochs = [st.epoch for st in chs]

    def _flat_patches(self, cache: _GroupCache, chs: List[ChannelState]):
        """Per-channel (flat slots, join-map cells, params) patch sets
        covering every epoch since the cache's snapshot, or None if any
        channel must rebuild (delta gap, whole-table delta, or padded
        capacity exceeded)."""
        out = []
        for st, cached_e in zip(chs, cache.epochs):
            if st.epoch == cached_e:
                out.append(None)
                continue
            deltas = self._delta_union(st.delta_log, cached_e, st.epoch)
            if deltas is None or any(d.full for d in deltas):
                return None
            slots, cells, params_t = set(), set(), set()
            for d in deltas:
                slots |= d.flat_slots
                cells |= d.flat_cells
                params_t |= d.params
            agg = st.aggregator
            if agg.num_flat_slots > cache.tmax:
                return None
            if any(agg.flat_row_extent(p) > cache.mmax for p in params_t):
                return None
            out.append((slots, cells, params_t))
        return out

    def _apply_flat_patches(self, cache: _GroupCache,
                            chs: List[ChannelState], patches) -> None:
        """Per changed channel: the touched flat-slot rows are re-read from
        the aggregator's flat table and the touched join-map CELLS
        ((param, position), stable under churn) written in place, so a
        patch costs O(delta) cells, never whole by-param rows. One upload a
        channel; cells outside the padded map are dropped, as the
        reference's scatter drops them."""
        t = cache.targets
        for ci, (st, patch) in enumerate(zip(chs, patches)):
            if patch is None:
                continue
            slots, cells, params_t = patch
            agg = st.aggregator
            sl = np.sort(np.fromiter(slots, np.int64, len(slots)))
            sl_p, sl_b, sl_c, sl_s = agg.flat_slot_rows(sl)
            c_p, c_pos, c_val = agg.flat_cell_rows(sorted(cells))
            keep = (c_p < cache.dmax) & (c_pos < cache.mmax)
            c_p, c_pos, c_val = c_p[keep], c_pos[keep], c_val[keep]
            el = np.asarray(sorted(params_t), np.int64)
            e_cnt = np.asarray([agg.flat_row_extent(p) for p in el.tolist()],
                               np.int32)
            e_mask = (st.user_params.refcount[el] > 0).astype(np.int32)
            k, c, m = len(sl), len(c_p), len(el)
            dev = self._upload(np.concatenate(
                [sl, sl_p, sl_b, sl_c, sl_s, c_p, c_pos, c_val, el,
                 e_cnt.reshape(-1), e_mask]))
            parts = _split(dev, (k, k, k, k, k, c, c, c, m, m, m))
            si, ei = parts[0].long(), parts[8].long()
            t.params[ci].index_copy_(0, si, parts[1])
            t.brokers[ci].index_copy_(0, si, parts[2])
            t.counts[ci].index_copy_(0, si, parts[3])
            cache.sids[ci].index_copy_(0, si, parts[4][:, None])
            t.by_param[ci].index_put_((parts[5].long(), parts[6].long()),
                                      parts[7])
            t.by_param_count[ci].index_copy_(0, ei, parts[9])
            cache.up_masks[ci].index_copy_(0, ei, parts[10].bool())
            self.maintenance.patches += 1
        cache.epochs = [st.epoch for st in chs]

    def _spatial_state(self, chs: List[ChannelState]) -> _SpatialCache:
        """Stacked per-channel user sets of one spatial join group,
        maintained by the same epoch/delta protocol as the group caches:
        cohort churn patches slot rows in place; a ``set_user_locations``
        (user-version bump), cohort creation, capacity overflow or a delta
        gap rebuilds."""
        names = tuple(st.spec.name for st in chs)
        cohorted = tuple(st.cohort is not None for st in chs)
        cache = self._stacked_cache.get(("spatial", names))
        if cache is not None and cache.user_version == self._user_version \
                and cache.cohorted == cohorted:
            if cache.epochs == [st.user_epoch for st in chs]:
                return cache
            if self.incremental:
                with trace.span("patch", layout="spatial") as sp:
                    patches = self._spatial_patches(cache, chs)
                    if patches is not None:
                        self._apply_spatial_patches(cache, chs, patches)
                    sp.set(applied=patches is not None)
                if patches is not None:
                    return cache
        with trace.span("rebuild", layout="spatial"):
            cache = self._build_spatial_state(chs)
        self._stacked_put(("spatial", names), cache)
        return cache

    def _build_spatial_state(self, chs: List[ChannelState]) -> _SpatialCache:
        """Every channel's user rows, padded to a shared power of two at the
        far sentinel: the global table for a channel without a cohort, the
        cohort's slot rows otherwise; one upload."""
        from repro_torch.kernels.spatial_match.ops import FAR
        self.maintenance.rebuilds += 1
        locs_h, brokers_h = self._user_host
        u = locs_h.shape[0]
        rows = [u if st.cohort is None else max(st.cohort.num_slots, 1)
                for st in chs]
        ub = _pow2_bucket(max(rows), 3)
        n = len(chs)
        locs = np.full((n, ub, 2), -FAR, np.float32)
        brokers = np.zeros((n, ub), np.int32)
        uids = np.full((n, ub), -1, np.int32)
        for i, st in enumerate(chs):
            if st.cohort is None:
                locs[i, :u] = locs_h
                brokers[i, :u] = brokers_h
                uids[i, :u] = np.arange(u, dtype=np.int32)
            else:
                k = st.cohort.num_slots
                if k:
                    locs[i, :k], brokers[i, :k], uids[i, :k] = \
                        self._cohort_rows(st)
        dev = self._upload(np.concatenate(
            [locs.reshape(-1).view(np.int32), brokers.reshape(-1),
             uids.reshape(-1)]))
        parts = _split(dev, (n * ub * 2, n * ub, n * ub))
        return _SpatialCache(
            tuple(st.spec.name for st in chs), self._user_version,
            tuple(st.cohort is not None for st in chs),
            [st.user_epoch for st in chs], ub,
            parts[0].view(torch.float32).view(n, ub, 2),
            parts[1].view(n, ub), parts[2].view(n, ub))

    def _spatial_patches(self, cache: _SpatialCache,
                         chs: List[ChannelState]):
        """Per-channel touched cohort slots since the cache's snapshot, or
        None if any channel must rebuild (gap, no cohort, or more slots than
        the padded rows)."""
        out = []
        for st, cached_e in zip(chs, cache.epochs):
            if st.user_epoch == cached_e:
                out.append(None)
                continue
            deltas = self._delta_union(st.user_delta_log, cached_e,
                                       st.user_epoch)
            if deltas is None or st.cohort is None \
                    or st.cohort.num_slots > cache.ub:
                return None
            out.append(set().union(*deltas))
        return out

    def _apply_spatial_patches(self, cache: _SpatialCache,
                               chs: List[ChannelState], patches) -> None:
        """Per changed channel: the touched cohort slot rows (locations,
        brokers, uids) in one upload, written in place."""
        for ci, (st, slots) in enumerate(zip(chs, patches)):
            if slots is None:
                continue
            sl = np.asarray(sorted(slots), np.int32)
            k = len(sl)
            locs, brokers, uids = self._cohort_rows(st, sl)
            dev = self._upload(np.concatenate(
                [sl, locs.reshape(-1).view(np.int32), brokers, uids]))
            parts = _split(dev, (k, 2 * k, k, k))
            si = parts[0].long()
            cache.locs[ci].index_copy_(
                0, si, parts[1].view(torch.float32).view(k, 2))
            cache.brokers[ci].index_copy_(0, si, parts[2])
            cache.uids[ci].index_copy_(0, si, parts[3])
            self.maintenance.patches += 1
        cache.epochs = [st.user_epoch for st in chs]

    def _stacked_spatial_sids(self, chs: List[ChannelState]) -> torch.Tensor:
        """Delivery sID tables of the spatial group: the 0-width identity
        fanout while every channel serves all users (targets ARE end-user
        ids); with cohorts, a (C, ub, 1) slot->uid view of the cache, so
        delivered sIDs are GLOBAL user ids, not cohort slots."""
        c = self._spatial_state(chs)
        if c.identity:
            return torch.zeros((len(chs), 0), dtype=I32, device=self.device)
        return c.uids[:, :, None]

    def fused_sids_table(self, name: str, aggregated: bool) -> torch.Tensor:
        """The sID table matching the FUSED path's pair-target space for one
        channel: slot tables on an incremental engine (group slots when
        aggregated, flat per-subscription slots otherwise), the compacted
        build tables on a rebuild engine, and the cohort slot->uid table (or
        the 0-width identity fanout) for spatial channels."""
        st = self.channels[name]
        if st.spec.join == "spatial":
            tbl = self._spatial_sids_table(st)
            return (torch.zeros((0,), dtype=I32, device=self.device)
                    if tbl is None else tbl)
        if self.incremental:
            return self._sid_table(st, "slot" if aggregated else "flat_slot")
        return self._sid_table(st, aggregated)

    def _sid_table(self, st: ChannelState, layout) -> torch.Tensor:
        """One channel's device sID table for a pair-target layout ("slot" /
        "flat_slot": aggregator slot rows; True / False: compacted build
        rows), uploaded once per subscription epoch."""
        tbl = st._sid_tables.get(layout)
        if tbl is None:
            if layout == "slot":
                tbl = torch.as_tensor(st.aggregator.slot_arrays()[3],
                                      device=self.device)
            elif layout == "flat_slot":
                tbl = torch.as_tensor(st.aggregator.flat_slot_arrays()[3],
                                      device=self.device)[:, None]
            else:
                tbl = self.group_sids_array(st.spec.name, layout)
            st._sid_tables[layout] = tbl
        return tbl

    def _group_scalars(self, chs: List[ChannelState]) -> Dict[str, torch.Tensor]:
        """The (C,) per-channel scalars of one join group, uploaded in ONE
        host->device copy: index rows, trad-index predicate, param field,
        payload, last execution marks, epochs and (bit-cast) radii."""
        radii = np.asarray([st.spec.spatial_radius for st in chs], np.float32)
        cols = {"rows": [st.index for st in chs],
                "best": [_best_pred(st) for st in chs],
                "param_field": [st.spec.param_field for st in chs],
                "payload": [st.spec.payload_bytes for st in chs],
                "last_ts": [st.last_exec_ts for st in chs],
                "last_size": [st.last_exec_size for st in chs],
                "epochs": [st.epoch for st in chs],
                "radius": radii.view(np.int32)}
        dev = self._upload(
            np.stack([np.asarray(v, np.int32) for v in cols.values()]))
        out = {k: dev[i] for i, k in enumerate(cols)}
        out["radius"] = out["radius"].view(torch.float32)
        return out

    def _conds_rows(self, chs: List[ChannelState]) -> CompiledConditions:
        rows = [st.index for st in chs]
        c = self._conds
        return CompiledConditions(c.field_idx[rows], c.op[rows],
                                  c.value[rows], c.npreds[rows])

    def _discover_all(self, plan: plans.ChannelPlan, chs: List[ChannelState],
                      inp: Dict, max_cand: int) -> plans.CandidateSet:
        """Stacked candidate discovery of one join group under the plan's
        scan mode; a pallas-family plan evaluates predicates with the
        ``predicate_filter`` kernel (the rows form for window/trad_index)."""
        conds = self._conds_rows(chs)
        match_fn = match_rows_fn = None
        if plans.backend_family(plan.backend) == "pallas":
            from repro_torch.kernels.predicate_filter import ops as pf_ops
            match_fn = lambda f: pf_ops.predicate_filter(f, conds)
            match_rows_fn = lambda f: pf_ops.predicate_filter_rows(f, conds)
        ds = self.dataset
        if plan.scan_mode == "full":
            return plans.candidates_full_scan_all(ds, conds, inp["last_ts"],
                                                  max_cand, match_fn)
        if plan.scan_mode == "window":
            return plans.candidates_window_all(ds, conds, inp["last_size"],
                                               self.max_window, match_rows_fn)
        if plan.scan_mode == "trad_index":
            return plans.candidates_trad_index_all(
                ds, conds, inp["best"], inp["last_size"], self.max_window,
                max_cand, match_rows_fn)
        return plans.candidates_bad_index_all(self.index_state, inp["rows"],
                                              max_cand)

    def _run_group(self, plan: plans.ChannelPlan,
                   param_chs: List[ChannelState],
                   spatial_chs: List[ChannelState], max_cand: int,
                   deliver: bool, p_in: Optional[Dict], s_in: Optional[Dict],
                   p_ring: Optional[RetryRing], s_ring: Optional[RetryRing]):
        """ONE plan-group's execution: stacked discovery per join group
        (param / spatial), the stacked joins over the channel axis, and with
        ``deliver`` the broker convert+send stages (``deliver_all``, ring
        aware when a ring is given) on the same device, no host round trip
        in between. The compact backends compress the discovered candidates
        into a channel-major stream whose capacity ``_stream_caps`` chooses
        first, so every run is accepted and a ring is presented once. With
        the plan's ``scorer`` tag and an attached enrichment stage, each join
        group's result is ranked (``enrich.rank_result``) before delivery;
        the returned results stay the full join.
        Returns ((res_p, res_s, del_p, del_s), (rank_p, rank_s))."""
        nb = self.brokers.num_brokers
        pushdown, aggregated = plan.param_pushdown, plan.aggregation
        use_pallas = plans.backend_family(plan.backend) == "pallas"
        compact = plans.is_compact(plan.backend)
        ds = self.dataset
        with trace.span("discover"):
            cand_p = (self._discover_all(plan, param_chs, p_in, max_cand)
                      if param_chs else None)
            cand_s = (self._discover_all(plan, spatial_chs, s_in, max_cand)
                      if spatial_chs else None)
        if compact:
            p_stream, s_stream = self._stream_caps(plan, param_chs,
                                                   spatial_chs, cand_p,
                                                   cand_s, max_cand)
        pw, mp = self.deliver_payload_words, self.max_deliver_pairs
        mn, sc = self.max_notify, self.max_spill
        # the stage binds when the plan carries its tag; a tagged plan given
        # to an engine with no stage attached runs unranked
        stage = (self.enrichment
                 if deliver and plan.scorer is not None else None)
        res_p = res_s = del_p = del_s = rank_p = rank_s = None
        if param_chs:
            cand = cand_p
            up = p_in["up_masks"] if pushdown else None
            with trace.span("join"):
                if compact:
                    join_fn = None
                    if plan.backend == "compact_pallas":
                        from repro_torch.kernels.join_compact import (
                            ops as jc_ops)
                        join_fn = jc_ops.join_pairs
                    stream = plans.compact_candidates(cand, p_stream)
                    sj = plans.join_param_stream(
                        ds, stream, p_in["targets"], p_in["param_field"],
                        p_in["payload"], nb, up, aggregated, p_in["domains"],
                        join_fn)
                    res_p = plans.stream_to_stacked(
                        sj, stream, cand.scanned,
                        min(p_stream, cand.rows.shape[1]))
                    del stream, sj
                else:
                    res_p = plans.join_param_targets_all(
                        ds, cand, p_in["targets"], p_in["param_field"],
                        p_in["payload"], nb, up, aggregated, p_in["domains"])
            if deliver:
                res_del = res_p
                if stage is not None:
                    with trace.span("rank"):
                        res_del, *rank_p = enrich.rank_result(
                            stage, ds, res_p, p_in["rows"], p_in["sids"],
                            counts=p_in["targets"].counts)
                with trace.span("deliver"):
                    del_p = deliver_all(
                        res_del, p_in["sids"], pw, mp, mn, sc,
                        target_brokers=p_in["targets"].brokers,
                        num_brokers=nb, counts=p_in["targets"].counts,
                        ring=p_ring,
                        epochs=None if p_ring is None else p_in["epochs"])
        if spatial_chs:
            cand = cand_s
            with trace.span("join"):
                if compact:
                    stream = plans.compact_candidates(cand, s_stream)
                    sj = plans.join_spatial_stream(
                        ds, stream, s_in["locs"], s_in["brokers"],
                        s_in["radius"], s_in["payload"], nb)
                    res_s = plans.stream_to_stacked(
                        sj, stream, cand.scanned,
                        min(s_stream, cand.rows.shape[1]))
                    del stream, sj
                else:
                    spatial_fn = None
                    if use_pallas:
                        from repro_torch.kernels.spatial_match import (
                            ops as sm_ops)
                        spatial_fn = sm_ops.spatial_match
                    res_s = plans.join_spatial_all(
                        ds, cand, s_in["locs"], s_in["brokers"],
                        s_in["radius"], s_in["payload"], nb, spatial_fn)
            if deliver:
                res_del = res_s
                if stage is not None:
                    with trace.span("rank"):
                        res_del, *rank_s = enrich.rank_result(
                            stage, ds, res_s, s_in["rows"], s_in["sids"])
                with trace.span("deliver"):
                    del_s = deliver_all(
                        res_del, s_in["sids"], pw, mp, mn, sc,
                        target_brokers=s_in["brokers"], num_brokers=nb,
                        ring=s_ring,
                        epochs=None if s_ring is None else s_in["epochs"])
        return (res_p, res_s, del_p, del_s), (rank_p, rank_s)

    def _stream_caps(self, plan: plans.ChannelPlan,
                     param_chs: List[ChannelState],
                     spatial_chs: List[ChannelState],
                     cand_p: Optional[plans.CandidateSet],
                     cand_s: Optional[plans.CandidateSet],
                     max_cand: int) -> Tuple[int, int]:
        """The adaptive stream-capacity protocol of one compact plan-group
        (see ``_STREAM_FLOOR``), per (kind, plan, membership) key: start
        from the remembered bucket; when the live total exceeds it, run at
        the total's power-of-two bucket instead (the reference runs,
        detects the overflow and re-runs; discovery is pure, so reading the
        totals first gives the same capacities and never runs a truncated
        join); halve the remembered bucket after ``_STREAM_PATIENCE``
        consecutive runs at <= half occupancy. One host read of both
        totals. Returns the (param, spatial) capacities to run at."""
        width = self.max_window if plan.scan_mode == "window" else max_cand
        floor = 1 << _STREAM_FLOOR
        zero = torch.zeros((), dtype=I32, device=self.device)
        with trace.span("read.stream_totals"):
            tots = torch.stack([zero if c is None else c.valid.sum(dtype=I32)
                                for c in (cand_p, cand_s)]).cpu().tolist()
        caps = []
        for kind, chs, tot in (("param", param_chs, tots[0]),
                               ("spatial", spatial_chs, tots[1])):
            if not chs:
                caps.append(0)
                continue
            key = (kind, plan, tuple(st.spec.name for st in chs))
            cap = min(self._stream_buckets.get(key, floor),
                      _pow2_bucket(len(chs) * width, _STREAM_FLOOR))
            if tot > cap:
                cap = _pow2_bucket(tot, _STREAM_FLOOR)
            caps.append(cap)
            keep = cap
            if cap > floor and tot <= cap // 2:
                idle = self._stream_idle.get(key, 0) + 1
                if idle >= _STREAM_PATIENCE:
                    keep, idle = cap // 2, 0
                self._stream_idle[key] = idle
            else:
                self._stream_idle[key] = 0
            self._stream_buckets[key] = keep
        return caps[0], caps[1]

    def execute_all(self, flags: Optional[plans.ExecutionFlags] = None,
                    advance: bool = True, timed: bool = True,
                    deliver: bool = False) -> Dict[str, ExecutionReport]:
        """Execute EVERY channel, param-join AND spatial, in one fused call
        per PLAN-GROUP: stacked candidate discovery per join group, the
        stacked param join, the stacked spatial join (per-channel radii over
        the stacked user sets), fused broker accounting.

        ``flags=None`` partitions channels by their assigned ``ChannelPlan``
        (``set_plan`` / engine default): channels sharing a plan run in ONE
        fused call, each distinct plan in its own, with its own stacked
        caches and retry ring. Explicit ``flags`` run every channel under
        that plan on the engine backend (assignments are ignored, not
        overwritten). Result-for-result equal to looping
        ``execute_channel``; ``wall_time_s`` is the plan-group's wall
        amortized per channel. ``deliver=True`` runs ``deliver_all`` inside
        each group's call and surfaces per-channel ``DeliveryStats`` in
        ``report.overflow``; a plan switch between calls migrates the
        superseded group's ring through ``_flush_ring`` into the host
        SpillQueue. A thin wrapper over ``execute(ExecutionRequest(...))``."""
        return self.execute(plans.ExecutionRequest(
            flags=flags, advance=advance, timed=timed, deliver=deliver))

    def execute(self, request: plans.ExecutionRequest
                ) -> Dict[str, ExecutionReport]:
        """Run one ``ExecutionRequest`` synchronously: ``dispatch(request)``
        then ``sync()``, the single execution surface every facade
        (``execute_all``, ``dispatch_all``) routes through."""
        return self.dispatch(request).sync()

    def dispatch_all(self, flags: Optional[plans.ExecutionFlags] = None,
                     advance: bool = True, timed: bool = False,
                     deliver: bool = False,
                     resolve_spills: bool = False):
        """``dispatch`` under the keyword surface of ``execute_all``
        (``flags`` forces one homogeneous plan; None runs the per-channel
        assignments)."""
        return self.dispatch(plans.ExecutionRequest(
            flags=flags, advance=advance, timed=timed, deliver=deliver,
            resolve_spills=resolve_spills))

    def dispatch(self, request: plans.ExecutionRequest):
        """Enqueue every plan-group's work on the engine's stream WITHOUT
        reading any output back: returns a ``runtime.PendingExecution``
        whose ``sync()`` materializes the per-channel reports (one bulk
        device->host copy per join group) and runs the host half of the
        delivery accounting (SpillQueue pushes, conserving DeliveryStats).

        The request resolves to one plan per requested channel, and
        channels sharing a plan run as one plan-group (first-channel order,
        so a homogeneous resolution is one group). With an enrichment stage
        attached and ``deliver=True`` every plan is stamped with the
        stage's identity. Everything the control plane sees happens AT
        DISPATCH: stacked caches are patched, successor rings stored (device
        tensors), watermarks advanced (in place, after the group's work on
        the same stream) and ``last_exec_*`` moved, so back-to-back
        dispatches pipeline and a deferred ``sync()`` reports exactly the
        state its work was dispatched against.

        ``resolve_spills`` captures overflowed pairs into the SpillQueue's
        epoch-free RESOLVED lane, against clones of the dispatch-time
        stacked sID tables taken here (the live tables are patched in place
        by later dispatches): required when syncs are deferred across
        churn.

        A plan-group's host sync points, by design: the ``bad_index`` scan
        mode reads the watermark deltas to bucket candidate shapes (one
        read), and the compact backends read the live-candidate totals for
        the stream capacity (one read). The per-group scalars, the patches
        and the executed index rows are uploaded without blocking; a
        cache rebuild uploads its tables with blocking copies. Each read
        is a ``read.*`` span of ``core/trace``."""
        from repro_torch.core.runtime import PendingExecution
        execution = trace.next_execution()
        with trace.span("dispatch", execution=execution):
            deliver = request.deliver
            ordered = sorted(self.channels.values(), key=lambda s: s.index)
            if request.channels is not None:
                unknown = set(request.channels) - set(self.channels)
                if unknown:
                    raise KeyError(f"unknown channels: {sorted(unknown)}")
                want = set(request.channels)
                ordered = [st for st in ordered if st.spec.name in want]
            if not ordered:
                return PendingExecution(self, [], execution)
            forced = request.forced_plan(
                "pallas" if self.use_pallas else "oracle")
            # with a stage attached and delivery on, every executed plan carries
            # the stage's identity, so rings and stream buckets key on it
            tag = (self.enrichment.identity
                   if self.enrichment is not None and deliver else None)
            groups: Dict[plans.ChannelPlan, Tuple[List, List]] = {}
            for st in ordered:
                p = forced or (st.plan or self.default_plan())
                if forced is None and request.backend is not None:
                    p = dataclasses.replace(p, backend=request.backend)
                if tag is not None:
                    p = dataclasses.replace(p, scorer=tag)
                g = groups.setdefault(p, ([], []))
                (g[0] if st.spec.join == "param" else g[1]).append(st)
            use_ring = deliver and self.ring_capacity > 0
            if use_ring and request.channels is None:
                # plan-switch ring migration: a ring whose (kind, plan,
                # membership) no longer executes hands its entries to the host
                # SpillQueue, tagged with the layout they were produced under
                active = set()
                for plan, (pchs, schs) in groups.items():
                    if pchs:
                        active.add(("param", plan,
                                    tuple(st.spec.name for st in pchs)))
                    if schs:
                        active.add(("spatial", plan,
                                    tuple(st.spec.name for st in schs)))
                for k in [k for k in self._rings if k not in active]:
                    self._flush_ring(*self._rings.pop(k))
            pending = [self._dispatch_plan_group(plan, pchs, schs, request.timed,
                                                 deliver, use_ring,
                                                 request.resolve_spills)
                       for plan, (pchs, schs) in groups.items()]
            if request.advance:
                with trace.span("advance"):
                    rows = [st.index for st in ordered]
                    bidx.advance_watermarks(self.index_state,
                                            self._upload(np.asarray(rows)))
                    self._advanced(rows)
                    for st in ordered:
                        st.last_exec_ts = self.now
                        st.last_exec_size = self.size_host
                        st.executions += 1
            return PendingExecution(self, pending, execution)

    def _dispatch_plan_group(self, plan: plans.ChannelPlan,
                             param_chs: List[ChannelState],
                             spatial_chs: List[ChannelState], timed: bool,
                             deliver: bool, use_ring: bool,
                             resolve_spills: bool) -> _PendingGroup:
        """Gather one plan-group's stacked inputs and rings (patching the
        caches), enqueue its work, and store its successor rings; the
        reports materialize later in ``_materialize_group``."""
        with trace.span("group", backend=plan.backend, scan=plan.scan_mode,
                        channels=len(param_chs) + len(spatial_chs)):
            chans = param_chs + spatial_chs
            max_cand = self.max_candidates
            if plan.scan_mode == "bad_index":
                # shared shape bucket: the largest watermark delta across THIS
                # group's channels, from one host read
                with trace.span("read.watermarks"):
                    pend = (self.index_state.counts
                            - self.index_state.watermarks).cpu().numpy()
                pending = max(int(pend[st.index]) for st in chans)
                max_cand = min(_pow2_bucket(pending, 6), self.max_candidates)
            # fused aggregated targets of an incremental engine are SLOT indices
            # and its flat targets FLAT-slot indices, not build()'s compacted
            # rows: spills carry the matching layout so a drain re-packs against
            # the right table
            if self.incremental:
                p_layout = "slot" if plan.aggregation else "flat_slot"
            else:
                p_layout = plan.aggregation
            p_names = tuple(st.spec.name for st in param_chs)
            s_names = tuple(st.spec.name for st in spatial_chs)
            p_in = s_in = p_ring = s_ring = None
            with trace.span("caches"):
                if param_chs:
                    c = self._group_state(param_chs, plan.aggregation)
                    p_in = self._group_scalars(param_chs)
                    p_in.update(targets=c.targets, up_masks=c.up_masks,
                                domains=c.domains, sids=c.sids)
                    if use_ring:
                        p_ring = self._ring_in(("param", plan, p_names), p_names,
                                               len(param_chs))
                if spatial_chs:
                    c = self._spatial_state(spatial_chs)
                    s_in = self._group_scalars(spatial_chs)
                    s_in.update(locs=c.locs, brokers=c.brokers,
                                sids=self._stacked_spatial_sids(spatial_chs))
                    if use_ring:
                        s_ring = self._ring_in(("spatial", plan, s_names),
                                               s_names, len(spatial_chs))
            if timed:
                self._sync()
            t0 = time.perf_counter()
            res, ranks = self._run_group(plan, param_chs, spatial_chs, max_cand,
                                         deliver, p_in, s_in, p_ring, s_ring)
            wall = 0.0
            if timed:
                self._sync()
                wall = time.perf_counter() - t0
            del_p, del_s = res[2], res[3]

            def keep(inp):
                # the resolved lane reads the dispatch-time sID table at sync,
                # after later dispatches may have patched the live one in place
                if inp is None or not (resolve_spills and deliver):
                    return None
                return inp["sids"].clone()

            if use_ring:
                if param_chs:
                    self._rings[("param", plan, p_names)] = (
                        p_names, p_layout, del_p.ring)
                if spatial_chs:
                    self._rings[("spatial", plan, s_names)] = (
                        s_names, plan.aggregation, del_s.ring)
            return _PendingGroup(
                plan=plan, param_chs=param_chs, spatial_chs=spatial_chs,
                res=res, ranks=ranks, p_layout=p_layout,
                s_layout=plan.aggregation,
                deliver=deliver, wall=wall, t0=t0,
                p_epochs=[st.epoch for st in param_chs],
                s_epochs=[st.epoch for st in spatial_chs],
                p_sids=keep(p_in), s_sids=keep(s_in))

    def _materialize_group(self, g: _PendingGroup,
                           reports: Dict[str, ExecutionReport]) -> None:
        """Host half of one plan-group: ONE device->host copy per join group
        (counts, bytes, delivery counters and spill streams together), then
        per-channel reports; the pair grids stay on the device
        (``report.result`` holds per-channel views)."""
        with trace.span("materialize"):
            res_p, res_s, del_p, del_s = g.res
            wall = g.wall
            for chs, res, dlv, rank, layout, epochs, sids in (
                    (g.param_chs, res_p, del_p, g.ranks[0], g.p_layout,
                     g.p_epochs, g.p_sids),
                    (g.spatial_chs, res_s, del_s, g.ranks[1], g.s_layout,
                     g.s_epochs, g.s_sids)):
                if not chs:
                    continue
                named = {"num_results": res.num_results,
                         "num_notified": res.num_notified,
                         "scanned": res.scanned,
                         "broker_bytes": res.broker_bytes}
                if g.deliver:
                    named.update(_delivery_tensors(dlv))
                if rank is not None:
                    named.update(ranked_pairs=rank[0], ranked_sids=rank[1])
                h = _host_arrays(named)
                if not wall:
                    wall = time.perf_counter() - g.t0
                stats = {}
                if g.deliver:
                    with trace.span("accounting"):
                        stats = self._spill_and_stats(chs, layout, h, epochs,
                                                      sids)
                pay = noti = None
                if g.deliver and self.debug_delivery_buffers:
                    with trace.span("read.buffers"):
                        pay = dlv.pack.payload.cpu().numpy()
                        noti = dlv.fan.notify.cpu().numpy()
                    # the card leaves the lines past each channel's count as
                    # they were; the report reads as the plain version's
                    clear_dead_lines(pay, h["pack_delivered"])
                share = wall / max(len(g.param_chs) + len(g.spatial_chs), 1)
                for i, st in enumerate(chs):
                    reports[st.spec.name] = ExecutionReport(
                        channel=st.spec.name, flags=g.plan.flags, plan=g.plan,
                        result=plans.ChannelResult(*(t[i] for t in res)),
                        wall_time_s=share,
                        num_results=int(h["num_results"][i]),
                        num_notified=int(h["num_notified"][i]),
                        scanned=int(h["scanned"][i]),
                        broker_bytes=h["broker_bytes"][i],
                        overflow=stats.get(st.spec.name),
                        payload=None if pay is None else pay[i],
                        notify=None if noti is None else noti[i])

    # ------------------------------------------------------------------
    # device-resident retry rings
    # ------------------------------------------------------------------

    def _ring_in(self, key, names: Tuple[str, ...],
                 num_channels: int) -> RetryRing:
        """The resident ring of one plan-group, or a fresh empty one when
        the group's channel set changed (the old ring's entries are handed
        to the host queue, never silently lost)."""
        cur = self._rings.get(key)
        if cur is not None:
            if cur[0] == names:
                return cur[2]
            del self._rings[key]
            self._flush_ring(*cur)
        return empty_ring(num_channels, self.ring_capacity, self.device)

    def _flush_ring(self, names: Tuple[str, ...], layout,
                    ring: RetryRing) -> None:
        """Push a ring's resident entries into the host SpillQueue (pairs
        keep their recorded epoch as the staleness version). Entries past
        the queue's capacity are lost, counted in ``ring_flush_drops``."""
        h = _host_arrays(dict(zip(RetryRing._fields, ring)),
                         "read.ring_flush")
        pc, sc = h["pair_count"], h["sid_count"]
        rows, tgts = h["pair_rows"], h["pair_targets"]
        eps, vals = h["pair_epochs"], h["sid_values"]
        for i, name in enumerate(names):
            n = int(pc[i])
            if n:
                for e in np.unique(eps[i, :n]).tolist():
                    sel = eps[i, :n] == e
                    acc = self.spill.push_pairs(name, layout,
                                                rows[i, :n][sel],
                                                tgts[i, :n][sel], int(e))
                    self.ring_flush_drops += int(sel.sum()) - acc
            m = int(sc[i])
            if m:
                acc = self.spill.push_sids(name, vals[i, :m])
                self.ring_flush_drops += m - acc

    def flush_rings(self) -> None:
        """Hand every ring's resident entries to the host SpillQueue (for
        ``drain_spilled``) and drop the rings."""
        rings, self._rings = self._rings, {}
        for names, layout, ring in rings.values():
            self._flush_ring(names, layout, ring)

    def ring_pending_pairs(self) -> int:
        return sum(int(r.pair_count.sum()) for _, _, r in self._rings.values())

    def ring_pending_sids(self) -> int:
        return sum(int(r.sid_count.sum()) for _, _, r in self._rings.values())

    # ------------------------------------------------------------------
    # spill retry
    # ------------------------------------------------------------------

    def _synthetic_result(self, rows: np.ndarray,
                          tgts: np.ndarray) -> plans.ChannelResult:
        """A shape-bucketed ChannelResult holding exactly the given (row,
        target) pairs: the drain path's re-entry into the broker stages."""
        n = len(rows)
        bucket = _pow2_bucket(n, 6)
        rt = np.full((2, bucket), -1, np.int32)
        rt[0, :n], rt[1, :n] = rows, tgts
        both = torch.as_tensor(rt, device=self.device)
        r, t = both[0], both[1]
        valid = torch.arange(bucket, device=self.device) < n
        z = torch.zeros((), dtype=I32, device=self.device)
        zb = torch.zeros((self.brokers.num_brokers,), dtype=I32,
                         device=self.device)
        return plans.ChannelResult(r[:, None], t[:, None], valid[:, None], r,
                                   valid, z, z, z, zb, zb)

    def drain_spilled(self) -> Dict[str, DrainReport]:
        """Re-deliver spilled notifications, exactly once per stage.

        Pairs lane: pop up to ``max_deliver_pairs`` for ONE (channel, layout)
        lane per channel per round and re-run the convert stage against the
        channel's CURRENT table of that layout; entries whose channel
        version moved (or whose channel was dropped) are unroutable and
        counted as dropped. Sids lane: pop up to ``max_notify`` per channel
        and re-run the send stage (raw sIDs never go stale). Anything that
        misses this round's buffers is requeued at the front: never
        duplicated, never lost. Call once per tick until
        ``spill.pending_pairs() + spill.pending_sids() == 0``."""
        with trace.span("drain"):
            out: Dict[str, DrainReport] = {}
            pw, dev = self.deliver_payload_words, self.device

            def merge(name: str, rep: DrainReport) -> None:
                prev = out.get(name)
                if prev is None:
                    out[name] = rep
                else:
                    out[name] = DrainReport(
                        prev.stats.merged(rep.stats),
                        rep.payload if prev.payload is None else prev.payload,
                        rep.notify if prev.notify is None else prev.notify)

            drained_pairs = set()
            # resolved lane first: entries whose fanout was resolved against the
            # producing call's own table re-enter with their recorded sID rows
            # as the table, immune to churn between spill and drain
            for name in self.spill.resolved_keys():
                if name in drained_pairs:
                    continue
                drained_pairs.add(name)
                rows, tgts, sid_rows = self.spill.pop_resolved(
                    name, self.max_deliver_pairs)
                dropped = delivered = respilled = 0
                payload = None
                if name not in self.channels:
                    dropped = len(rows)
                elif len(rows):
                    n = len(rows)
                    res = self._synthetic_result(rows,
                                                 np.arange(n, dtype=np.int32))
                    tbl = np.full((_pow2_bucket(n, 6), sid_rows.shape[1]), -1,
                                  np.int32)
                    tbl[:n] = sid_rows
                    payload, dlv, _ = pack_payloads(res, torch.as_tensor(
                        tbl, device=dev), pw, self.max_deliver_pairs)
                    with trace.span("read.drain"):
                        delivered = int(dlv)
                    payload[:delivered, 1] = torch.as_tensor(tgts[:delivered],
                                                             device=dev)
                    if delivered < n:   # exact in-order prefix delivered
                        self.spill._push_front_resolved(
                            name, rows[delivered:], tgts[delivered:],
                            sid_rows[delivered:])
                        respilled = n - delivered
                if delivered or dropped or respilled:
                    merge(name, DrainReport(
                        DeliveryStats(delivered, respilled, dropped, 0, 0, 0),
                        payload=payload))

            for name, layout in self.spill.pair_keys():
                if name in drained_pairs:
                    # one pair lane per channel per round: the layouts re-pack
                    # against different tables with different wire widths
                    continue
                drained_pairs.add(name)
                st = self.channels.get(name)
                version = st.epoch if st is not None else None
                rows, tgts, stale = self.spill.pop_pairs(
                    name, layout, self.max_deliver_pairs, version)
                dropped = stale
                payload = None
                delivered = respilled = 0
                if st is None:
                    dropped += len(rows)
                elif len(rows):
                    res = self._synthetic_result(rows, tgts)
                    if st.spec.join == "spatial":
                        sids = self._spatial_sids_table(st)
                        if sids is None:
                            sids = torch.zeros((0,), dtype=I32, device=dev)
                    else:
                        sids = self._sid_table(st, layout)
                    payload, dlv, _ = pack_payloads(res, sids, pw,
                                                    self.max_deliver_pairs)
                    with trace.span("read.drain"):
                        delivered = int(dlv)
                    if delivered < len(rows):   # exact in-order prefix delivered
                        self.spill._push_front_pairs(
                            name, layout, rows[delivered:], tgts[delivered:],
                            st.epoch)
                        respilled = len(rows) - delivered
                if delivered or dropped or respilled:
                    merge(name, DrainReport(
                        DeliveryStats(delivered, respilled, dropped, 0, 0, 0),
                        payload=payload))

            for name in self.spill.sid_keys():
                sids = self.spill.pop_sids(name, self.max_notify)
                if not len(sids):
                    continue
                # identity fanout: targets ARE the sIDs, so the send stage
                # re-emits them verbatim in spill order
                res = self._synthetic_result(sids, sids)
                buf, dlv, _ = fanout_sids(res, torch.zeros((0,), dtype=I32,
                                                           device=dev),
                                          self.max_notify)
                with trace.span("read.drain"):
                    delivered = int(dlv)
                respilled = len(sids) - delivered
                if respilled:
                    self.spill._push_front_sids(name, sids[delivered:])
                merge(name, DrainReport(
                    DeliveryStats(0, 0, 0, delivered, respilled, 0),
                    notify=buf))
            return out


def _delivery_tensors(d: FusedDelivery) -> Dict[str, torch.Tensor]:
    """The delivery outputs the host half reads, by name (ring counters
    included when the delivery was ring-aware)."""
    named = {"pack_delivered": d.pack.delivered,
             "pack_produced": d.pack.produced,
             "fan_delivered": d.fan.delivered,
             "fan_produced": d.fan.produced,
             "per_broker": d.pack.per_broker,
             "pair_valid": d.pair_spill.valid,
             "pair_rows": d.pair_spill.rows,
             "pair_channels": d.pair_spill.channels,
             "pair_targets": d.pair_spill.targets,
             "sid_valid": d.sid_spill.valid,
             "sid_values": d.sid_spill.values,
             "sid_channels": d.sid_spill.channels}
    if d.counters is not None:
        named.update(zip(RingCounters._fields, d.counters))
    return named


def _host_arrays(named: Dict[str, torch.Tensor],
                 read: str = "read.reports") -> Dict[str, np.ndarray]:
    """Read many small tensors with ONE device->host copy: each is
    flattened to int32, concatenated, copied once and split back into numpy
    arrays of its own shape (bools restored). The copy is the ``read``
    span, with its ``bytes``."""
    with trace.span(read) as sp:
        host = torch.cat([t.reshape(-1).to(I32)
                          for t in named.values()]).cpu().numpy()
        sp.set(bytes=host.nbytes)
    out, at = {}, 0
    for k, t in named.items():
        n = t.numel()
        a = host[at:at + n].reshape(tuple(t.shape))
        out[k] = a.astype(bool) if t.dtype == torch.bool else a
        at += n
    return out


def _split(flat: torch.Tensor, sizes) -> List[torch.Tensor]:
    """Consecutive views of one uploaded buffer."""
    out, at = [], 0
    for n in sizes:
        out.append(flat[at:at + n])
        at += n
    return out


def _resolve_rows(table: torch.Tensor, targets: np.ndarray) -> np.ndarray:
    """``broker.resolve_pair_sids`` against one channel's device sID table,
    copying only the rows the targets name to the host."""
    targets = np.asarray(targets, np.int32)
    if table.ndim != 2 or table.numel() == 0 or not len(targets):
        if table.ndim == 2 and table.shape[1] and table.shape[0]:
            return np.zeros((0, table.shape[1]), np.int32)
        return resolve_pair_sids(np.empty(tuple(table.shape), np.int32),
                                 targets)
    safe = torch.as_tensor(np.clip(targets, 0, table.shape[0] - 1),
                           dtype=torch.long, device=table.device)
    with trace.span("read.resolve"):
        return table[safe].to(I32).cpu().numpy()


def _pow2_bucket(n: int, floor_bits: int) -> int:
    """Smallest power of two >= n, clamped below by 2**floor_bits."""
    return 1 << max(floor_bits, (max(n, 1) - 1).bit_length())


# Compacted-stream capacity policy: streams start at 2**_STREAM_FLOOR
# entries, run at the power-of-two bucket of the live total when it would
# overflow the remembered bucket, and halve after _STREAM_PATIENCE
# consecutive runs at <= half occupancy, so buckets converge to the
# workload's live-candidate envelope.
_STREAM_FLOOR = 7
_STREAM_PATIENCE = 8


def _pred_rank(p) -> int:
    """Heuristic selectivity rank for picking the traditional-index field."""
    return 2 if p.op == EQ else 1


def _best_pred(st: ChannelState) -> int:
    """The channel's traditional-index predicate: its most selective."""
    preds = st.spec.fixed_preds
    return int(np.argmax([_pred_rank(p) for p in preds])) if preds else 0
