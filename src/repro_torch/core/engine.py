"""BADEngine: the host-side orchestrator tying the data plane together.

Responsibilities (paper Fig. 1): data feed ingestion -> ActiveDataset append +
conditionsList evaluation + BAD-index maintenance; channel execution under a
chosen ``ExecutionFlags`` plan; broker accounting; subscription control plane
(Algorithm 1 grouping + UserParameters upkeep).

This is the main-path slice of the reference engine: one BAD tick through
``execute_channel`` on the padded backends, with broker delivery
(``deliver=True``) through the same fused ``deliver_all`` the multi-channel
path uses, run at C == 1. Pairs and sIDs that miss a delivery buffer land in
the bounded host-side ``SpillQueue`` with their channel identity; what does
not fit there is counted as dropped (delivered + spilled + dropped ==
produced, per stage).

``use_pallas=True`` (backend ``"pallas"``) routes ingestion-time predicate
evaluation through the ``predicate_filter`` CUDA kernel and the spatial join
through the ``spatial_match`` CUDA kernel; ``"oracle"`` runs the plain
PyTorch versions. On a CPU engine the kernels' wrappers run their plain
versions (see ``repro_torch/kernels``).

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item porting it: fused multi-channel execution (``execute_all``,
``execute``), the dispatch/sync split (``dispatch``, ``dispatch_all``),
``drain_spilled``, the compact backends, spatial cohorts and the enrichment
stage.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bad_index as bidx
from repro_torch.core import plans
from repro_torch.core import records as R
from repro_torch.core import subscriptions as subs
from repro_torch.core.broker import (BrokerRegistry, DeliveryStats,
                                     FusedDelivery, deliver_all)
from repro_torch.core.channel import ChannelSpec
from repro_torch.core.predicates import (EQ, CompiledConditions,
                                         compile_conditions,
                                         evaluate_conditions)
from repro_torch.core.user_params import UserParameters
from repro_torch.device import DeviceLike, resolve_device

I32 = torch.int32


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1, {item})")


@dataclasses.dataclass
class MaintenanceStats:
    """Counters for the epoch/delta maintenance machinery.

    In the reference, ``traces`` counts jit traces of engine-owned device
    functions. Eager PyTorch has no traces, so in this port it stays 0;
    what it counts here is left to the churn slice (ROADMAP Queue 1, item
    11). ``rebuilds`` and ``patches`` count stacked-cache rebuilds and delta
    patches, which only the fused path (not ported yet) performs."""

    traces: int = 0
    rebuilds: int = 0
    patches: int = 0

    def snapshot(self) -> "MaintenanceStats":
        return dataclasses.replace(self)

    def since(self, prior: "MaintenanceStats") -> "MaintenanceStats":
        return MaintenanceStats(self.traces - prior.traces,
                                self.rebuilds - prior.rebuilds,
                                self.patches - prior.patches)


@dataclasses.dataclass
class ChannelState:
    spec: ChannelSpec
    index: int                      # row in the stacked conditionsList / BADIndexState
    aggregator: subs.Aggregator
    user_params: UserParameters
    plan: Optional[plans.ChannelPlan] = None
    last_exec_ts: int = 0
    last_exec_size: int = 0
    executions: int = 0
    # ``epoch`` is a total order over this channel's subscription state:
    # bumped on EVERY control-plane change; it keys spill staleness.
    # ``delta_log`` holds the (epoch, GroupDelta) records the fused path's
    # delta-patched caches will consume.
    epoch: int = 0
    delta_log: Deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=64))
    # device TargetArrays + host group/flat views, cached per channel and
    # dropped whenever the subscription set changes
    _targets_flat: Optional[plans.TargetArrays] = None
    _targets_grouped: Optional[plans.TargetArrays] = None
    _groups: Optional[subs.SubscriptionGroups] = None
    _flat: Optional[subs.SubscriptionTable] = None
    _host_targets: Dict[bool, Tuple] = dataclasses.field(default_factory=dict)

    def note_change(self) -> None:
        """Advance the epoch and log the aggregator's accumulated delta."""
        delta = self.aggregator.take_delta()
        self.epoch += 1
        self.delta_log.append((self.epoch, delta))
        self._drop_host_caches()

    def invalidate_targets(self) -> None:
        """Out-of-band invalidation (no delta recorded)."""
        self.aggregator.take_delta()
        self.epoch += 1
        self._drop_host_caches()

    def _drop_host_caches(self) -> None:
        self._targets_flat = self._targets_grouped = None
        self._groups = self._flat = None
        self._host_targets = {}


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
    and re-sent sID buffer (delivered prefix meaningful)."""

    stats: DeliveryStats
    payload: Optional[np.ndarray] = None
    notify: Optional[np.ndarray] = None


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
    # broker overflow accounting; None unless executed with ``deliver=True``
    overflow: Optional[DeliveryStats] = None


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
                 enrichment=None,
                 device: DeviceLike = "cuda"):
        if enrichment is not None:
            raise _not_ported("the enrichment stage", "item 14")
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
        # kept for the fused slice, whose retry rings it sizes
        self.ring_capacity = ring_capacity
        self.user_locations = torch.zeros((1, 2), dtype=torch.float32,
                                          device=self.device)
        self.user_brokers = torch.zeros((1,), dtype=I32, device=self.device)
        self.now = 0
        # host mirror of dataset.size, maintained by ``ingest``: row ids and
        # watermarks are derived on the host, never read back from the device
        self.size_host = 0
        self._conds: Optional[CompiledConditions] = None
        self.index_state = bidx.BADIndexState.create(0, index_capacity,
                                                     self.device)
        self.incremental = incremental
        self.maintenance = MaintenanceStats()

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
        st = self.channels[channel]
        params = np.asarray(params, dtype=np.int32).ravel()
        brokers = np.asarray(brokers, dtype=np.int32).ravel()
        # validate BEFORE mutating
        if params.size and (int(params.min()) < 0
                            or int(params.max()) >= st.user_params.domain):
            raise ValueError(
                f"params out of [0, {st.user_params.domain}) for {channel}")
        nb = self.brokers.num_brokers
        if brokers.size and (int(brokers.min()) < 0 or int(brokers.max()) >= nb):
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
        st = self.channels[channel]
        params = st.aggregator.remove_bulk(np.asarray(sids))
        if params.size:
            st.user_params.remove_bulk(params)
            st.note_change()
        return int(params.size)

    def subscribe_users(self, channel: str, user_ids: np.ndarray) -> int:
        raise _not_ported("spatial cohorts (subscribe_users)", "item 11")

    def unsubscribe_users(self, channel: str, user_ids: np.ndarray) -> int:
        raise _not_ported("spatial cohorts (unsubscribe_users)", "item 11")

    def set_user_locations(self, locations: np.ndarray,
                           brokers: Optional[np.ndarray] = None) -> None:
        locations = np.asarray(locations, dtype=np.float32)
        self.user_locations = torch.as_tensor(
            locations, device=self.device).contiguous()
        if brokers is None:
            brokers = np.zeros((locations.shape[0],), dtype=np.int32)
        self.user_brokers = torch.as_tensor(np.asarray(brokers, np.int32),
                                            device=self.device)

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
        row_ids = np.arange(self.size_host, self.size_host + n,
                            dtype=np.int32)
        dev_rows = R.append(self.dataset, batch)
        if self.use_pallas:
            from repro_torch.kernels.predicate_filter import ops as pf_ops
            matches = pf_ops.predicate_filter(batch.fields, self._conds)
        else:
            matches = evaluate_conditions(batch.fields, self._conds)
        bidx.insert(self.index_state, dev_rows, matches)
        self.size_host += n
        if n:
            self.now = max(self.now,
                           int(batch.host_fields[:, R.TIMESTAMP].max()))
        return row_ids

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

    def group_sids_array(self, channel: str, aggregated: bool) -> torch.Tensor:
        st = self.channels[channel]
        if aggregated:
            groups = st._groups or st.aggregator.build()
            st._groups = groups
            return torch.as_tensor(groups.group_sids, device=self.device)
        flat = self._flat_table(st)
        return torch.as_tensor(flat.sids, device=self.device)[:, None]

    def _run_plan(self, st: ChannelState, flags: plans.ExecutionFlags,
                  max_cand: Optional[int], backend: str,
                  targets: plans.TargetArrays, up_mask: torch.Tensor
                  ) -> plans.ChannelResult:
        """One channel's padded plan: candidate discovery under the scan
        mode, then the param or spatial join."""
        spec = st.spec
        conds_one = compile_conditions([list(spec.fixed_preds)])
        best_pred = int(np.argmax([_pred_rank(p) for p in spec.fixed_preds])) \
            if spec.fixed_preds else 0
        max_cand = max_cand or self.max_candidates
        num_brokers = self.brokers.num_brokers
        ds = self.dataset
        if flags.scan_mode == "full":
            cand = plans.candidates_full_scan(ds, conds_one, st.last_exec_ts,
                                              max_cand)
        elif flags.scan_mode == "window":
            cand = plans.candidates_window(ds, conds_one, st.last_exec_size,
                                           self.max_window)
        elif flags.scan_mode == "trad_index":
            cand = plans.candidates_trad_index(ds, conds_one, best_pred,
                                               st.last_exec_size,
                                               self.max_window, max_cand)
        else:
            cand = plans.candidates_bad_index(ds, self.index_state, st.index,
                                              max_cand)
        if spec.join == "spatial":
            spatial_fn = None
            if plans.backend_family(backend) == "pallas":
                from repro_torch.kernels.spatial_match import ops as sm_ops
                spatial_fn = sm_ops.spatial_match
            return plans.join_spatial(ds, cand, self.user_locations,
                                      self.user_brokers, spec.spatial_radius,
                                      spec.payload_bytes, num_brokers,
                                      spatial_fn)
        return plans.join_param_targets(
            ds, cand, targets, spec.param_field, spec.payload_bytes,
            num_brokers, up_mask if flags.param_pushdown else None,
            flags.aggregation)

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
            # spatial targets ARE end-user ids; a 0-wide table selects the
            # brokers' identity fanout
            sids = torch.zeros((1, 0), dtype=I32, device=self.device)
            tb = self.user_brokers[None]
        else:
            sids = self.group_sids_array(st.spec.name, aggregated)[None]
            targets = self._targets(st, aggregated)
            tb = targets.brokers[None]
            counts = targets.counts[None]
        d = deliver_all(res1, sids, self.deliver_payload_words,
                        self.max_deliver_pairs, self.max_notify,
                        self.max_spill, target_brokers=tb,
                        num_brokers=self.brokers.num_brokers, counts=counts)
        return self._spill_and_stats([st], aggregated, d)[st.spec.name]

    def _spill_and_stats(self, chs: List[ChannelState], layout,
                         d: FusedDelivery) -> Dict[str, DeliveryStats]:
        """Host side of a delivery: push the captured flat spill streams into
        the SpillQueue per channel (entries past the queue's capacity — or
        past the device capture buffer — become counted drops) and assemble
        each channel's conserving DeliveryStats. ``layout`` tags the pair
        lane with the target index space the producing join used (False =
        flat rows, True = compacted group rows)."""
        def host(t):
            return t.cpu().numpy()

        pack_d, pack_p = host(d.pack.delivered), host(d.pack.produced)
        fan_d, fan_p = host(d.fan.delivered), host(d.fan.produced)
        per_broker = host(d.pack.per_broker)
        pvalid = host(d.pair_spill.valid)
        prows = host(d.pair_spill.rows)[pvalid]
        pchan = host(d.pair_spill.channels)[pvalid]
        ptgts = host(d.pair_spill.targets)[pvalid]
        svalid = host(d.sid_spill.valid)
        svals = host(d.sid_spill.values)[svalid]
        schan = host(d.sid_spill.channels)[svalid]
        out: Dict[str, DeliveryStats] = {}
        for i, st in enumerate(chs):
            name = st.spec.name
            sel = pchan == i
            spilled_p = self.spill.push_pairs(name, layout, prows[sel],
                                              ptgts[sel], st.epoch)
            sel = schan == i
            spilled_s = self.spill.push_sids(name, svals[sel])
            ov_p = int(pack_p[i] - pack_d[i])
            ov_s = int(fan_p[i] - fan_d[i])
            out[name] = DeliveryStats(
                delivered_pairs=int(pack_d[i]), spilled_pairs=spilled_p,
                dropped_pairs=ov_p - spilled_p,
                delivered_sids=int(fan_d[i]), spilled_sids=spilled_s,
                dropped_sids=ov_s - spilled_s,
                delivered_pairs_broker=tuple(int(x) for x in per_broker[i]))
        return out

    def execute_channel(self, channel: str,
                        flags: plans.ExecutionFlags,
                        advance: bool = True,
                        timed: bool = True,
                        deliver: bool = False,
                        backend: Optional[str] = None) -> ExecutionReport:
        """Execute one channel under ``flags`` on a padded backend
        ("oracle" or "pallas"). ``timed`` is accepted for the reference's
        signature: eager PyTorch has no trace to warm, so ``wall_time_s``
        always times the execution itself, ending in a device
        synchronize on a CUDA engine."""
        st = self.channels[channel]
        backend = backend or ("pallas" if self.use_pallas else "oracle")
        if backend not in plans.BACKENDS:
            raise ValueError(f"backend must be one of {plans.BACKENDS}")
        if plans.is_compact(backend):
            raise _not_ported(f"the {backend!r} backend", "item 10")
        # The BAD index knows its exact candidate count before execution (the
        # watermark delta), so downstream buffers are shape-bucketed to it.
        max_cand = None
        if flags.scan_mode == "bad_index":
            pending = int(self.index_state.counts[st.index]
                          - self.index_state.watermarks[st.index])
            max_cand = min(_pow2_bucket(pending, 6), self.max_candidates)
        targets = self._targets(st, flags.aggregation)
        up_mask = st.user_params.mask(self.device)
        self._sync()
        t0 = time.perf_counter()
        result = self._run_plan(st, flags, max_cand, backend, targets,
                                up_mask)
        self._sync()
        wall = time.perf_counter() - t0
        if advance:
            bidx.advance_watermark(self.index_state, st.index)
            st.last_exec_ts = self.now
            st.last_exec_size = self.size_host
            st.executions += 1
        overflow = self._deliver(st, result, flags.aggregation) if deliver else None
        return ExecutionReport(
            channel=channel, flags=flags, result=result, wall_time_s=wall,
            num_results=int(result.num_results),
            num_notified=int(result.num_notified),
            scanned=int(result.scanned),
            broker_bytes=result.broker_bytes.cpu().numpy(),
            overflow=overflow)

    # ------------------------------------------------------------------
    # paths of the reference engine that later slices port
    # ------------------------------------------------------------------

    def execute_all(self, *args, **kwargs):
        raise _not_ported("fused multi-channel execution (execute_all)",
                          "item 8")

    def execute(self, *args, **kwargs):
        raise _not_ported("fused multi-channel execution (execute)", "item 8")

    def dispatch_all(self, *args, **kwargs):
        raise _not_ported("the dispatch/sync split (dispatch_all)", "item 13")

    def dispatch(self, *args, **kwargs):
        raise _not_ported("the dispatch/sync split (dispatch)", "item 13")

    def drain_spilled(self) -> Dict[str, DrainReport]:
        raise _not_ported("drain_spilled", "item 8")

    def set_enrichment(self, stage) -> bool:
        raise _not_ported("the enrichment stage", "item 14")


def _pow2_bucket(n: int, floor_bits: int) -> int:
    """Smallest power of two >= n, clamped below by 2**floor_bits."""
    return 1 << max(floor_bits, (max(n, 1) - 1).bit_length())


def _pred_rank(p) -> int:
    """Heuristic selectivity rank for picking the traditional-index field."""
    return 2 if p.op == EQ else 1
