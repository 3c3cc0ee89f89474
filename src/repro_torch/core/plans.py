"""Executable channel plans: original vs the three optimizations (paper §4).

The plan layer as plain functions on tensors: the padded single-channel
plans, their stacked forms over a leading channel axis (the fused
multi-channel path; the reference's ``vmap`` becomes batched tensor code),
and the compacted candidate stream of the compact backends.

scan_mode (how candidate records are found)          -- paper Fig. 11
  "full"       full dataset scan + is_new timestamp filter   (original, no index)
  "window"     delta scan of records since last execution    (ts-ordered storage)
  "trad_index" traditional secondary index on the single most selective fixed
               predicate: candidates = that predicate's matches, remaining
               predicates evaluated at query time
  "bad_index"  the BAD index: precomputed full-conjunction matches + watermark
aggregation     join against subscription-groups instead of raw subscriptions
param_pushdown  early semi-join with UserParameters           -- paper Fig. 9(b)

Backend names are persisted identifiers (``ChannelPlan.to_dict``) shared
with the reference package, so they keep its spelling: the ``"oracle"``
family runs the plain PyTorch versions, and the ``"pallas"`` family means
"the CUDA kernels written by hand for Hopper" (``kernels/predicate_filter``
at ingest and in the fused discovery, ``kernels/spatial_match`` in the
spatial joins, ``kernels/join_compact`` in the compacted param join). The
compacted ``"compact"``/``"compact_pallas"`` formulations run the join over
a flat channel-major stream of the live candidates only.

Scatters drop out-of-range indices and gathers clamp, as in the reference;
every count and byte total is int32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import bad_index as bidx
from repro_torch.core import records as R
from repro_torch.core.predicates import (CompiledConditions, apply_op,
                                         evaluate_conditions)
from repro_torch.core.user_params import semi_join

SCAN_MODES = ("full", "window", "trad_index", "bad_index")
BACKENDS = ("oracle", "pallas", "compact", "compact_pallas")

I32 = torch.int32


def backend_family(backend: str) -> str:
    """The kernel family ("oracle" | "pallas") of any backend name."""
    return "pallas" if backend in ("pallas", "compact_pallas") else "oracle"


def is_compact(backend: str) -> bool:
    """True for the compacted-stream join formulation."""
    return backend in ("compact", "compact_pallas")


def compact_variant(backend: str) -> str:
    """The compacted-stream backend of the given backend's family."""
    return "compact_pallas" if backend_family(backend) == "pallas" \
        else "compact"


@dataclasses.dataclass(frozen=True)
class ExecutionFlags:
    scan_mode: str = "window"
    aggregation: bool = False
    param_pushdown: bool = False

    def __post_init__(self):
        if self.scan_mode not in SCAN_MODES:
            raise ValueError(f"scan_mode must be one of {SCAN_MODES}")

    @staticmethod
    def original() -> "ExecutionFlags":
        return ExecutionFlags(scan_mode="full")

    @staticmethod
    def fully_optimized() -> "ExecutionFlags":
        return ExecutionFlags(scan_mode="bad_index", aggregation=True,
                              param_pushdown=True)


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """A channel's full physical plan: scan mode x target layout x kernel
    backend. ``ExecutionFlags`` names the paper's three optimizations;
    ``ChannelPlan`` adds the backend axis."""

    scan_mode: str = "window"
    aggregation: bool = False
    param_pushdown: bool = False
    backend: str = "oracle"
    # the attached EnrichmentStage's ``identity`` (core/enrich.py), stamped
    # by the engine at execution so every plan-keyed state (stream buckets,
    # retry rings) keys on the scorer too: an attach, detach or swap
    # re-rings like a plan switch. Never assigned to a channel and never
    # persisted (``to_dict`` omits it).
    scorer: Optional[tuple] = None

    def __post_init__(self):
        if self.scan_mode not in SCAN_MODES:
            raise ValueError(f"scan_mode must be one of {SCAN_MODES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")

    @property
    def flags(self) -> ExecutionFlags:
        """The ExecutionFlags view (everything but the backend axis)."""
        return ExecutionFlags(self.scan_mode, self.aggregation,
                              self.param_pushdown)

    @staticmethod
    def from_flags(flags: ExecutionFlags,
                   backend: str = "oracle") -> "ChannelPlan":
        return ChannelPlan(flags.scan_mode, flags.aggregation,
                           flags.param_pushdown, backend)

    def to_dict(self) -> dict:
        return {"scan_mode": self.scan_mode, "aggregation": self.aggregation,
                "param_pushdown": self.param_pushdown, "backend": self.backend}

    @staticmethod
    def from_dict(d: dict) -> "ChannelPlan":
        return ChannelPlan(d["scan_mode"], bool(d["aggregation"]),
                           bool(d["param_pushdown"]), d.get("backend", "oracle"))


def enumerate_plans(backends=("oracle",), param_pushdown: bool = True):
    """Every static (scan mode x layout x backend) combination."""
    return tuple(ChannelPlan(scan, agg, param_pushdown, b)
                 for b in backends for scan in SCAN_MODES
                 for agg in (False, True))


@dataclasses.dataclass(frozen=True)
class ExecutionRequest:
    """The single execution spec behind ``BADEngine.execute``.

    ``flags`` runs every requested channel under
    ``ChannelPlan.from_flags(flags, backend)``; ``plan`` is an explicit
    homogeneous ``ChannelPlan`` (mutually exclusive with ``flags``); with
    neither, channels run their assigned plan (``set_plan``) or the engine
    default, partitioned into plan-groups. ``backend`` overrides the kernel
    backend of whatever plan that resolves to; ``channels`` restricts
    execution to a subset (None = all). ``resolve_spills`` captures
    overflowed pairs into the SpillQueue's epoch-free resolved lane (see
    ``BADEngine.dispatch``)."""

    flags: Optional[ExecutionFlags] = None
    plan: Optional[ChannelPlan] = None
    backend: Optional[str] = None
    channels: Optional[tuple] = None
    advance: bool = True
    timed: bool = False
    deliver: bool = False
    resolve_spills: bool = False

    def __post_init__(self):
        if self.flags is not None and self.plan is not None:
            raise ValueError("pass flags or plan, not both")
        if self.backend is not None and self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.channels is not None:
            object.__setattr__(self, "channels", tuple(self.channels))

    def forced_plan(self, default_backend: str) -> Optional[ChannelPlan]:
        """The homogeneous plan this request forces on every requested
        channel, or None for the per-channel-assignment mode (where a
        ``backend`` override, if any, is applied per channel)."""
        if self.plan is not None:
            return (self.plan if self.backend is None
                    else dataclasses.replace(self.plan, backend=self.backend))
        if self.flags is not None:
            return ChannelPlan.from_flags(self.flags,
                                          self.backend or default_backend)
        return None


class TargetArrays(NamedTuple):
    """Device-side join targets: either raw subscriptions or groups."""

    params: torch.Tensor          # (T,) int32
    brokers: torch.Tensor         # (T,) int32
    counts: torch.Tensor          # (T,) int32  (1 for raw subscriptions)
    by_param: torch.Tensor        # (domain, maxT) int32, -1 padded
    by_param_count: torch.Tensor  # (domain,) int32


class CandidateSet(NamedTuple):
    rows: torch.Tensor      # (Rmax,) int32 row ids
    valid: torch.Tensor     # (Rmax,) bool
    scanned: torch.Tensor   # () int32 -- records examined (cost accounting)


class ChannelResult(NamedTuple):
    pair_rows: torch.Tensor       # (Rmax, maxT) int32 record row of each pair
    pair_targets: torch.Tensor    # (Rmax, maxT) int32 target (sub or group)
    pair_valid: torch.Tensor      # (Rmax, maxT) bool
    matched_rows: torch.Tensor    # (Rmax,) int32 candidate rows that matched
    matched_valid: torch.Tensor   # (Rmax,) bool
    num_results: torch.Tensor     # () int32 -- result records produced (pairs)
    num_notified: torch.Tensor    # () int32 -- end subscribers covered
    scanned: torch.Tensor         # () int32
    broker_bytes: torch.Tensor    # (B,) int32 platform->broker traffic (bytes)
    broker_results: torch.Tensor  # (B,) int32 results per broker


class PairStream(NamedTuple):
    """Flat channel-major (row, channel, target) pair stream: the broker's
    spill capture emits per-channel windows (each channel's in-order
    overflow prefix, up to its window size). ``valid`` marks live slots,
    ``total`` is the pre-truncation count across ALL channels; invalid
    slots hold -1."""

    rows: torch.Tensor      # (P,) int32
    channels: torch.Tensor  # (P,) int32
    targets: torch.Tensor   # (P,) int32
    valid: torch.Tensor     # (P,) bool
    total: torch.Tensor     # () int32


class ValueStream(NamedTuple):
    """Flat channel-major (value, channel) stream (e.g. overflowed sIDs);
    same ``valid``/``total`` semantics as ``PairStream``."""

    values: torch.Tensor    # (P,) int32
    channels: torch.Tensor  # (P,) int32
    valid: torch.Tensor     # (P,) bool
    total: torch.Tensor     # () int32


# ---------------------------------------------------------------------------
# Step 1: candidate discovery
# ---------------------------------------------------------------------------


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=I32, device=like.device)


def candidates_full_scan(ds: R.ActiveDataset, conds_one: CompiledConditions,
                         last_ts, max_rows: int) -> CandidateSet:
    """Original plan: scan the whole dataset, is_new() via timestamp compare,
    then evaluate every fixed predicate at query time."""
    cap = ds.capacity
    row_ids = _slot_row_ids(ds, _arange(cap, ds.fields))
    live = (row_ids >= 0) & (row_ids < ds.size)
    is_new = ds.fields[:, R.TIMESTAMP] > _scalar(last_ts, ds.fields)
    match = evaluate_conditions(ds.fields, conds_one)[:, 0]
    rows, valid = _compact(row_ids, live & is_new & match, max_rows)
    return CandidateSet(rows, valid, _scalar(cap, ds.fields))


def candidates_window(ds: R.ActiveDataset, conds_one: CompiledConditions,
                      last_size, max_rows: int) -> CandidateSet:
    """Delta scan: only records ingested since last execution (ts-ordered)."""
    last_size = _scalar(last_size, ds.fields)
    row_ids = last_size + _arange(max_rows, ds.fields)
    in_range = row_ids < ds.size
    fields = ds.fields[(row_ids % ds.capacity).long()]
    keep = in_range & evaluate_conditions(fields, conds_one)[:, 0]
    scanned = torch.clamp(ds.size - last_size, max=max_rows).to(I32)
    return CandidateSet(torch.where(keep, row_ids, -1), keep, scanned)


def candidates_trad_index(ds: R.ActiveDataset, conds_one: CompiledConditions,
                          best_pred: int, last_size, max_rows: int,
                          max_candidates: int) -> CandidateSet:
    """Traditional secondary index on the most selective fixed predicate:
    the index returns rows matching that ONE predicate (compacted — this is
    the index read), remaining predicates are evaluated on the candidates."""
    last_size = _scalar(last_size, ds.fields)
    row_ids = last_size + _arange(max_rows, ds.fields)
    in_range = row_ids < ds.size
    fields = ds.fields[(row_ids % ds.capacity).long()]
    fi = int(conds_one.field_idx[0, best_pred])
    idx_hit = apply_op(fields[:, fi], conds_one.op[0, best_pred],
                       conds_one.value[0, best_pred]) & in_range
    cand_rows, cand_valid = _compact(row_ids, idx_hit, max_candidates)
    cfields = ds.fields[(torch.clamp(cand_rows, min=0) % ds.capacity).long()]
    keep = cand_valid & evaluate_conditions(cfields, conds_one)[:, 0]
    return CandidateSet(torch.where(keep, cand_rows, -1), keep,
                        idx_hit.sum(dtype=I32))


def candidates_bad_index(ds: R.ActiveDataset, index: bidx.BADIndexState,
                         channel: int, max_rows: int) -> CandidateSet:
    """BAD-index plan: fixed predicates were already evaluated at ingestion;
    read only entries newer than the watermark. No re-evaluation."""
    rows, valid = bidx.new_entries(index, channel, max_rows)
    return CandidateSet(rows, valid, valid.sum(dtype=I32))


# ---------------------------------------------------------------------------
# Step 2+3: (optional) UserParameters semi-join, then the target join
# ---------------------------------------------------------------------------


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the reference's clamping gather semantics; an
    empty table reads zeros (every such read is masked by the caller)."""
    if table.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=table.dtype, device=table.device)
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def join_param_targets(ds: R.ActiveDataset, cand: CandidateSet,
                       targets: TargetArrays, param_field: int,
                       payload_bytes: int, num_brokers: int,
                       up_mask: Optional[torch.Tensor],
                       aggregated: bool) -> ChannelResult:
    """record[param_field] == target.param join via the dense by_param map."""
    slots = (torch.clamp(cand.rows, min=0) % ds.capacity).long()
    pvals = ds.fields[slots, param_field]                     # (Rm,)
    valid = cand.valid
    if up_mask is not None:
        valid = valid & semi_join(pvals, up_mask)             # Fig. 9(b) early join
    domain = targets.by_param.shape[0]
    pv = torch.clamp(pvals, 0, domain - 1).long()
    tgt = targets.by_param[pv]                                # (Rm, maxT)
    tgt_n = targets.by_param_count[pv]                        # (Rm,)
    maxT = tgt.shape[1]
    pair_valid = (valid[:, None] & (_arange(maxT, tgt)[None, :] < tgt_n[:, None])
                  & (tgt >= 0))
    tgt_safe = torch.clamp(tgt, min=0)
    pair_rows = torch.where(pair_valid, cand.rows[:, None], -1)
    pair_targets = torch.where(pair_valid, tgt, -1)
    members = torch.where(pair_valid, _take(targets.counts, tgt_safe), 0)
    num_results = pair_valid.sum(dtype=I32)
    num_notified = members.sum(dtype=I32)
    # Platform->broker traffic: one payload per result pair; aggregated pairs
    # additionally carry the member sID list (4 B each) -- paper §4.1.2.
    # Byte totals stay int32 end to end, as in the reference.
    per_pair = payload_bytes + (4 * members if aggregated
                                else torch.zeros_like(members))
    pair_bytes = torch.where(pair_valid, per_pair, 0).to(I32)
    bids = torch.where(pair_valid, _take(targets.brokers, tgt_safe),
                       num_brokers)
    broker_bytes = _channel_broker_sums(pair_bytes[None], bids[None],
                                        num_brokers)[0]
    broker_results = _channel_broker_sums(pair_valid.to(I32)[None],
                                          bids[None], num_brokers)[0]
    return ChannelResult(pair_rows.to(I32), pair_targets.to(I32), pair_valid,
                         torch.where(valid, cand.rows, -1), valid,
                         num_results, num_notified, cand.scanned,
                         broker_bytes, broker_results)


def join_spatial(ds: R.ActiveDataset, cand: CandidateSet,
                 user_locations: torch.Tensor, user_brokers: torch.Tensor,
                 radius, payload_bytes, num_brokers: int,
                 spatial_fn=None) -> ChannelResult:
    """spatial_distance(user.location, record.location) < radius join
    (TweetsAboutCrime). ``spatial_fn`` lets the engine swap in the CUDA
    kernel's wrapper; the default is the plain euclidean oracle."""
    slots = (torch.clamp(cand.rows, min=0) % ds.capacity).long()
    locs = ds.location[slots]                                  # (Rm, 2)
    if spatial_fn is None:
        from repro_torch.kernels.spatial_match import ref as spatial_ref
        hits = spatial_ref.spatial_match(locs, user_locations, radius)
    else:
        hits = spatial_fn(locs, user_locations, radius)        # (Rm, U) bool
    pair_valid = hits & cand.valid[:, None]
    U = user_locations.shape[0]
    pair_rows = torch.where(pair_valid, cand.rows[:, None], -1)
    pair_targets = torch.where(pair_valid, _arange(U, locs)[None, :], -1)
    num_results = pair_valid.sum(dtype=I32)
    # A pair's broker is its user's, so reduce the (Rm, U) grid over the
    # tweets once and sum the U per-user counts per broker. Every pair
    # carries the same payload: the byte sums are payload x count, equal to
    # the reference's int32 sums modulo 2^32.
    per_user = pair_valid.sum(dim=0, dtype=I32)                # (U,)
    broker_results = _channel_broker_sums(per_user[None], user_brokers[None],
                                          num_brokers)[0]
    broker_bytes = (broker_results.to(torch.int64)
                    * int(payload_bytes)).to(I32)
    return ChannelResult(pair_rows.to(I32), pair_targets.to(I32), pair_valid,
                         torch.where(cand.valid, cand.rows, -1), cand.valid,
                         num_results, num_results, cand.scanned,
                         broker_bytes, broker_results)


# ---------------------------------------------------------------------------
# Fused multi-channel execution: every stacked function carries a leading
# channel axis C, so one call covers every channel of a plan-group. The
# reference's vmap over channels becomes batched tensor code here, never a
# Python loop that launches per channel.
# ---------------------------------------------------------------------------


def _eval_channel_rows(fields: torch.Tensor,
                       conds: CompiledConditions) -> torch.Tensor:
    """(C, N, F) row blocks x each channel's padded predicate row -> (C, N)
    bool: channel c's conjunction on its own block (plain version)."""
    dev = fields.device
    C, N, _ = fields.shape
    field_idx = torch.as_tensor(conds.field_idx, device=dev).long()  # (C, P)
    op = torch.as_tensor(conds.op, device=dev)
    value = torch.as_tensor(conds.value, device=dev)
    vals = torch.gather(fields, 2, field_idx[:, None, :].expand(
        C, N, field_idx.shape[1]))                                  # (C, N, P)
    return apply_op(vals, op[:, None, :], value[:, None, :]).all(dim=-1)


def _match_rows(fields: torch.Tensor, conds: CompiledConditions,
                match_fn) -> torch.Tensor:
    """(C, N, F) stacked row blocks -> (C, N): channel c's conjunction on its
    own block, via ``match_fn`` (the ``predicate_filter_rows`` kernel) or
    the plain version."""
    if match_fn is not None:
        return match_fn(fields)
    return _eval_channel_rows(fields, conds)


def candidates_full_scan_all(ds: R.ActiveDataset, conds: CompiledConditions,
                             last_ts: torch.Tensor, max_rows: int,
                             match_fn=None) -> CandidateSet:
    """Stacked 'full' scan: ONE conditionsList pass covers every channel.
    ``match_fn``: optional (N, F) -> (N, C) evaluator (the
    ``predicate_filter`` kernel); default is the plain oracle."""
    cap = ds.capacity
    row_ids = _slot_row_ids(ds, _arange(cap, ds.fields))
    live = (row_ids >= 0) & (row_ids < ds.size)
    ts = ds.fields[:, R.TIMESTAMP]
    match = (evaluate_conditions(ds.fields, conds) if match_fn is None
             else match_fn(ds.fields))                          # (cap, C)
    keep = live[None, :] & (ts[None, :] > last_ts[:, None]) & match.T
    rows, valid = _compact(row_ids, keep, max_rows)
    scanned = torch.full((keep.shape[0],), cap, dtype=I32,
                         device=ds.fields.device)
    return CandidateSet(rows, valid, scanned)


def candidates_window_all(ds: R.ActiveDataset, conds: CompiledConditions,
                          last_size: torch.Tensor, max_rows: int,
                          match_fn=None) -> CandidateSet:
    """Stacked delta scan: each channel reads its own [last_size, size)
    window. ``match_fn``: optional (C, W, F) -> (C, W) evaluator
    (``predicate_filter_rows``); default is the plain version."""
    row_ids = last_size[:, None] + _arange(max_rows, ds.fields)[None, :]
    in_range = row_ids < ds.size                                # (C, W)
    fields = ds.fields[(row_ids % ds.capacity).long()]          # (C, W, F)
    keep = in_range & _match_rows(fields, conds, match_fn)
    scanned = torch.clamp(ds.size - last_size, max=max_rows).to(I32)
    return CandidateSet(torch.where(keep, row_ids, -1), keep, scanned)


def candidates_trad_index_all(ds: R.ActiveDataset, conds: CompiledConditions,
                              best_pred: torch.Tensor,
                              last_size: torch.Tensor, max_rows: int,
                              max_candidates: int,
                              match_fn=None) -> CandidateSet:
    """Stacked traditional-index scan: per channel, the index read is its
    most selective fixed predicate (``best_pred`` (C,)); the rest evaluate
    on the candidates (via ``match_fn`` with the same (C, N, F) -> (C, N)
    contract as ``candidates_window_all``)."""
    dev = ds.fields.device
    ch = torch.arange(last_size.shape[0], device=dev)
    best = best_pred.long()
    fi = torch.as_tensor(conds.field_idx, device=dev).long()[ch, best]
    op = torch.as_tensor(conds.op, device=dev)[ch, best]
    val = torch.as_tensor(conds.value, device=dev)[ch, best]
    row_ids = last_size[:, None] + _arange(max_rows, ds.fields)[None, :]
    in_range = row_ids < ds.size                                # (C, W)
    vals = ds.fields[(row_ids % ds.capacity).long(), fi[:, None]]
    idx_hit = apply_op(vals, op[:, None], val[:, None]) & in_range
    cand_rows, cand_valid = _compact(row_ids, idx_hit, max_candidates)
    cfields = ds.fields[(torch.clamp(cand_rows, min=0)
                         % ds.capacity).long()]                 # (C, Rc, F)
    keep = cand_valid & _match_rows(cfields, conds, match_fn)
    return CandidateSet(torch.where(keep, cand_rows, -1), keep,
                        idx_hit.sum(dim=1, dtype=I32))


def candidates_bad_index_all(index: bidx.BADIndexState,
                             channels: torch.Tensor,
                             max_rows: int) -> CandidateSet:
    """Stacked BAD-index read: every channel's watermark window at once."""
    ch = channels.long()
    wm = index.watermarks[ch]
    idx = wm[:, None] + torch.arange(max_rows, dtype=I32,
                                     device=wm.device)[None, :]
    valid = idx < index.counts[ch][:, None]
    safe = torch.clamp(idx, max=index.capacity - 1).long()
    rows = torch.where(valid, index.row_ids[ch[:, None], safe], -1)
    return CandidateSet(rows, valid, valid.sum(dim=1, dtype=I32))


def _semi_join_rows(pvals: torch.Tensor, up_mask: torch.Tensor
                    ) -> torch.Tensor:
    """``semi_join`` per channel: (C, R) param values x (C, D) masks."""
    d = up_mask.shape[1]
    ch = torch.arange(pvals.shape[0], device=pvals.device)[:, None]
    clipped = torch.clamp(pvals, 0, d - 1).long()
    return up_mask[ch, clipped] & (pvals >= 0) & (pvals < d)


def _channel_broker_sums(values: torch.Tensor, bids: torch.Tensor,
                         num_brokers: int) -> torch.Tensor:
    """(C, B) int32 per-channel per-broker sums of ``values``, reducing every
    axis but the leading one; entries whose broker id lies outside [0, B)
    (the sentinel ``num_brokers``) count nowhere. One masked reduction per
    broker -- the reference's ``fused`` formulation, equal to its segment
    sum -- because a scatter-add of a large pair grid into a handful of
    bins serializes on atomics."""
    C = values.shape[0]
    sums = [torch.where(bids == b, values, 0).reshape(C, -1).sum(
        dim=1, dtype=I32) for b in range(num_brokers)]
    if not sums:
        return torch.zeros((C, 0), dtype=I32, device=values.device)
    return torch.stack(sums, dim=1)


def _channel_broker_counts(bids: torch.Tensor,
                           num_brokers: int) -> torch.Tensor:
    """(C, B) int32 count of entries per channel carrying each broker id."""
    C = bids.shape[0]
    counts = [(bids == b).reshape(C, -1).sum(dim=1, dtype=I32)
              for b in range(num_brokers)]
    if not counts:
        return torch.zeros((C, 0), dtype=I32, device=bids.device)
    return torch.stack(counts, dim=1)


def join_param_targets_all(ds: R.ActiveDataset, cand: CandidateSet,
                           targets: TargetArrays, param_field: torch.Tensor,
                           payload_bytes: torch.Tensor, num_brokers: int,
                           up_mask: Optional[torch.Tensor], aggregated: bool,
                           domain: torch.Tensor) -> ChannelResult:
    """``join_param_targets`` over the channel axis.

    ``cand``/``targets``/``up_mask`` and the (C,) scalars carry a leading C
    axis; targets are shape-bucketed (padded to the max T / domain / fan-out
    across channels) with -1 / 0 padding that can never produce a valid
    pair, and ``domain`` (the real per-channel domain) bounds the clip.

    The (C, Rm, maxT) pair grid is the large object here, so the code keeps
    few grids alive at once: the target grid becomes ``pair_targets`` in
    place, members and brokers are gathered with one shared index, and the
    per-broker byte sums come from the per-broker pair counts (each pair
    carries ``payload`` bytes, plus 4 per member when aggregated): equal to
    the reference's int32 sums modulo 2^32, without a byte grid."""
    C = cand.rows.shape[0]
    dev = cand.rows.device
    ch = torch.arange(C, device=dev)[:, None]                   # (C, 1)
    slots = (torch.clamp(cand.rows, min=0) % ds.capacity).long()
    pvals = ds.fields[slots, param_field.long()[:, None]]       # (C, Rm)
    valid = cand.valid
    if up_mask is not None:
        valid = valid & _semi_join_rows(pvals, up_mask)         # Fig. 9(b)
    pv = torch.minimum(torch.clamp(pvals, min=0),
                       domain[:, None] - 1).long()
    pair_targets = targets.by_param[ch, pv]                     # (C, Rm, maxT)
    tgt_n = targets.by_param_count[ch, pv]                      # (C, Rm)
    maxT = pair_targets.shape[2]
    pair_valid = pair_targets >= 0
    pair_valid &= _arange(maxT, pvals) < tgt_n[..., None]
    pair_valid &= valid[..., None]
    invalid = ~pair_valid
    pair_targets.masked_fill_(invalid, -1)
    members, bids = _take_rows((targets.counts, targets.brokers),
                               ch[..., None], pair_targets)
    members.masked_fill_(invalid, 0)
    bids.masked_fill_(invalid, num_brokers)
    del invalid
    pair_rows = torch.where(pair_valid, cand.rows[..., None], -1)
    num_results = pair_valid.sum(dim=(1, 2), dtype=I32)
    num_notified = members.sum(dim=(1, 2), dtype=I32)
    # Platform->broker traffic: one payload per result pair; aggregated
    # pairs additionally carry the member sID list (4 B each) -- §4.1.2.
    # invalid pairs carry the sentinel broker, so counting ids counts pairs
    broker_results = _channel_broker_counts(bids, num_brokers)
    wide = broker_results.to(torch.int64) * payload_bytes.to(
        torch.int64)[:, None]
    if aggregated:
        wide += 4 * _channel_broker_sums(members, bids,
                                         num_brokers).to(torch.int64)
    return ChannelResult(pair_rows.to(I32), pair_targets, pair_valid,
                         torch.where(valid, cand.rows, -1), valid,
                         num_results, num_notified, cand.scanned,
                         wide.to(I32), broker_results)


def join_spatial_all(ds: R.ActiveDataset, cand: CandidateSet,
                     user_locations: torch.Tensor, user_brokers: torch.Tensor,
                     radius: torch.Tensor, payload_bytes: torch.Tensor,
                     num_brokers: int, spatial_fn=None) -> ChannelResult:
    """``join_spatial`` over the channel axis (TweetsAboutCrime at fused
    scale). ``user_locations`` (C, U, 2) / ``user_brokers`` (C, U) are the
    stacked per-channel user sets, padded by the engine at the far sentinel
    (padded users never fall inside any radius); ``radius`` and
    ``payload_bytes`` are (C,). ``spatial_fn`` (the stacked ``spatial_match``
    wrapper) evaluates every channel in one launch; the default is the plain
    euclidean oracle."""
    C = cand.rows.shape[0]
    slots = (torch.clamp(cand.rows, min=0) % ds.capacity).long()
    locs = ds.location[slots]                                   # (C, Rm, 2)
    if spatial_fn is None:
        from repro_torch.kernels.spatial_match import ref as spatial_ref
        hits = spatial_ref.spatial_match(locs, user_locations, radius)
    else:
        hits = spatial_fn(locs, user_locations, radius)         # (C, Rm, U)
    pair_valid = hits & cand.valid[..., None]
    U = user_locations.shape[1]
    pair_rows = torch.where(pair_valid, cand.rows[..., None], -1)
    pair_targets = torch.where(pair_valid, _arange(U, cand.rows)[None, None],
                               -1)
    num_results = pair_valid.sum(dim=(1, 2), dtype=I32)
    # as in ``join_spatial``: reduce over the tweets once, then sum the
    # per-user counts per broker; bytes are payload x count (mod 2^32)
    per_user = pair_valid.sum(dim=1, dtype=I32)                 # (C, U)
    broker_results = _channel_broker_sums(per_user, user_brokers,
                                          num_brokers)
    broker_bytes = (broker_results.to(torch.int64)
                    * payload_bytes.to(torch.int64)[:, None]).to(I32)
    return ChannelResult(pair_rows.to(I32), pair_targets.to(I32), pair_valid,
                         torch.where(cand.valid, cand.rows, -1), cand.valid,
                         num_results, num_results, cand.scanned,
                         broker_bytes, broker_results)


# ---------------------------------------------------------------------------
# Flat pair streams and the compacted execution join ("compact" /
# "compact_pallas"). After stacked discovery, live candidates across ALL
# channels compact into one flat channel-major CandStream (a stable
# prefix-sum scatter); the param/spatial join and the broker accounting then
# run over that stream, so their cost scales with live candidates instead of
# the padded C x shape-bucket grid. ``stream_to_stacked`` re-presents the
# stream join as a stacked ChannelResult whose per-channel valid pairs appear
# in exactly the padded path's ravel order, so delivery is pair for pair
# identical. The flatten_* builders are the standalone compaction API.
# ---------------------------------------------------------------------------


class CandStream(NamedTuple):
    """Flat channel-major compacted candidate stream.

    ``counts`` / ``total`` are PRE-truncation: ``total > rows.shape[0]``
    means the stream overflowed its capacity and the caller re-runs with a
    larger one (a truncated stream's results are never used). ``channels``
    is 0 on invalid slots (safe as a gather index)."""

    rows: torch.Tensor      # (S,) int32 record row ids, -1 on invalid slots
    channels: torch.Tensor  # (S,) int32 owning channel, 0 on invalid slots
    valid: torch.Tensor     # (S,) bool
    counts: torch.Tensor    # (C,) int32 per-channel live counts
    total: torch.Tensor     # () int32


class StreamJoin(NamedTuple):
    """Per-entry join output over a CandStream: (S, maxT) pair grids plus
    per-channel (C,) accounting, ready for ``stream_to_stacked``."""

    pair_rows: torch.Tensor       # (S, maxT) int32
    pair_targets: torch.Tensor    # (S, maxT) int32
    pair_valid: torch.Tensor      # (S, maxT) bool
    matched_rows: torch.Tensor    # (S,) int32
    matched_valid: torch.Tensor   # (S,) bool
    num_results: torch.Tensor     # (C,) int32
    num_notified: torch.Tensor    # (C,) int32
    broker_bytes: torch.Tensor    # (C, B) int32
    broker_results: torch.Tensor  # (C, B) int32


def _compact_flat_indices(mask: torch.Tensor, out_size: int):
    """Indices of set mask positions, compacted in order into ``out_size``
    slots. Returns (idx, valid, total); positions past the buffer are dropped
    (written to a discarded spare slot, never aliased onto the last kept
    one), as the reference's drop-mode scatter does."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, dim=0, dtype=I32) - 1
    dest = torch.where(mask, pos, out_size).clamp(max=out_size)
    idx = torch.zeros((out_size + 1,), dtype=I32, device=mask.device)
    idx.scatter_(0, dest.long(), _arange(n, mask))
    total = mask.sum(dtype=I32)
    valid = _arange(out_size, mask) < total
    return idx[:out_size], valid, total


def flatten_pairs_all(pair_rows: torch.Tensor, pair_targets: torch.Tensor,
                      mask: torch.Tensor, max_total: int) -> PairStream:
    """Compact a stacked (C, ...) masked pair set into one flat channel-major
    (row, channel, target) stream of at most ``max_total`` entries."""
    C = pair_rows.shape[0]
    rows = pair_rows.reshape(C, -1)
    per = rows.shape[1]
    idx, valid, total = _compact_flat_indices(mask.reshape(-1), max_total)
    return PairStream(
        torch.where(valid, _take(rows.reshape(-1), idx), -1),
        torch.where(valid, idx // max(per, 1), -1).to(I32),
        torch.where(valid, _take(pair_targets.reshape(-1), idx), -1),
        valid, total)


def flatten_result_pairs(result: ChannelResult, max_total: int) -> PairStream:
    """The stacked fused-join output as a compacted flat pair stream: every
    valid (record row, channel, target) pair across all channels, in
    channel-major delivery order."""
    return flatten_pairs_all(result.pair_rows, result.pair_targets,
                             result.pair_valid, max_total)


def flatten_values_all(values: torch.Tensor, mask: torch.Tensor,
                       max_total: int) -> ValueStream:
    """Compact stacked (C, M) masked values into one flat channel-major
    (value, channel) stream of at most ``max_total`` entries."""
    C = values.shape[0]
    per = values.reshape(C, -1).shape[1]
    idx, valid, total = _compact_flat_indices(mask.reshape(-1), max_total)
    return ValueStream(
        torch.where(valid, _take(values.reshape(-1), idx), -1),
        torch.where(valid, idx // max(per, 1), -1).to(I32), valid, total)


def compact_candidates(cand: CandidateSet, max_total: int) -> CandStream:
    """Compact a stacked (C, Rm) CandidateSet into one flat channel-major
    stream of at most ``max_total`` live candidates. Stable: within a
    channel, candidates keep their discovery order."""
    Rm = cand.rows.shape[1]
    idx, valid, total = _compact_flat_indices(cand.valid.reshape(-1),
                                              max_total)
    rows = torch.where(valid, _take(cand.rows.reshape(-1), idx), -1)
    channels = torch.where(valid, idx // max(Rm, 1), 0).to(I32)
    counts = cand.valid.sum(dim=1, dtype=I32)
    return CandStream(rows, channels, valid, counts, total)


def _take_rows(tables, ch: torch.Tensor, idx: torch.Tensor):
    """``table[ch, idx]`` for each (C, T) table of ``tables`` (same T), with
    the reference's clamping gather; ``ch`` (int64) broadcasts against
    ``idx``. One int64 flat index serves every table."""
    T = tables[0].shape[1]
    if T == 0:
        return tuple(torch.zeros(idx.shape, dtype=t.dtype, device=idx.device)
                     for t in tables)
    flat = torch.clamp(idx, 0, T - 1).long()
    flat += ch * T
    return tuple(t.reshape(-1)[flat] for t in tables)


def join_param_stream(ds: R.ActiveDataset, stream: CandStream,
                      targets: TargetArrays, param_field: torch.Tensor,
                      payload_bytes: torch.Tensor, num_brokers: int,
                      up_mask: Optional[torch.Tensor], aggregated: bool,
                      domain: torch.Tensor, join_fn=None) -> StreamJoin:
    """``join_param_targets_all`` over a compacted stream: every gather is
    per stream ENTRY (channel id -> that channel's stacked tables), so work
    is O(S x maxT) instead of O(C x Rm x maxT). ``join_fn`` is the
    pair-expansion hook (``kernels/join_compact``): the plain version by
    default, the CUDA kernel's wrapper under "compact_pallas"."""
    if join_fn is None:
        from repro_torch.kernels.join_compact import ref as jc_ref
        join_fn = jc_ref.join_pairs
    ch = stream.channels.long()
    slots = (torch.clamp(stream.rows, min=0) % ds.capacity).long()
    pvals = ds.fields[slots, param_field.long()[ch]]            # (S,)
    valid = stream.valid
    if up_mask is not None:
        # per-entry semi_join (Fig. 9(b)): same clip/in-domain semantics
        dom_max = up_mask.shape[1]
        clipped = torch.clamp(pvals, 0, dom_max - 1).long()
        in_dom = (pvals >= 0) & (pvals < dom_max)
        valid = valid & up_mask[ch, clipped] & in_dom
    pv = torch.minimum(torch.clamp(pvals, min=0), domain[ch] - 1).long()
    tgt = targets.by_param[ch, pv]                              # (S, maxT)
    tgt_n = targets.by_param_count[ch, pv]                      # (S,)
    members_tbl, bids_tbl = _take_rows((targets.counts, targets.brokers),
                                       ch[:, None], tgt)        # (S, maxT)
    pair_valid, members, pair_bytes, bids = join_fn(
        tgt, tgt_n, members_tbl, bids_tbl, valid, payload_bytes[ch],
        num_brokers, aggregated)
    del members_tbl, bids_tbl
    pair_rows = torch.where(pair_valid, stream.rows[:, None], -1)
    pair_targets = torch.where(pair_valid, tgt, -1)
    return StreamJoin(
        pair_rows, pair_targets, pair_valid,
        torch.where(valid, stream.rows, -1), valid,
        *_stream_accounting(ch, pair_valid, members, pair_bytes, bids,
                            param_field.shape[0], num_brokers))


def join_spatial_stream(ds: R.ActiveDataset, stream: CandStream,
                        user_locations: torch.Tensor,
                        user_brokers: torch.Tensor, radius: torch.Tensor,
                        payload_bytes: torch.Tensor,
                        num_brokers: int) -> StreamJoin:
    """``join_spatial_all`` over a compacted stream: each entry gathers its
    channel's user set and evaluates the euclidean oracle formula (the
    compact family keeps the oracle formula on both backends, as the
    reference does, so compacted spatial results equal the padded oracle
    path's)."""
    ch = stream.channels.long()
    slots = (torch.clamp(stream.rows, min=0) % ds.capacity).long()
    locs = ds.location[slots]                                   # (S, 2)
    d0 = locs[:, 0:1] - user_locations[..., 0][ch]              # (S, U)
    d1 = locs[:, 1:2] - user_locations[..., 1][ch]
    r = radius[ch]
    hits = d0 * d0 + d1 * d1 < (r * r)[:, None]
    pair_valid = hits & stream.valid[:, None]                   # (S, U)
    U = user_locations.shape[1]
    pair_rows = torch.where(pair_valid, stream.rows[:, None], -1)
    pair_targets = torch.where(pair_valid, _arange(U, locs)[None, :], -1)
    members = pair_valid.to(I32)
    pair_bytes = torch.where(pair_valid, payload_bytes[ch][:, None], 0).to(I32)
    bids = torch.where(pair_valid, user_brokers[ch], num_brokers).to(I32)
    num_results, _, broker_bytes, broker_results = _stream_accounting(
        ch, pair_valid, members, pair_bytes, bids, user_locations.shape[0],
        num_brokers)
    return StreamJoin(pair_rows, pair_targets.to(I32), pair_valid,
                      torch.where(stream.valid, stream.rows, -1),
                      stream.valid, num_results, num_results, broker_bytes,
                      broker_results)


def _stream_accounting(ch: torch.Tensor, pair_valid: torch.Tensor,
                       members: torch.Tensor, pair_bytes: torch.Tensor,
                       bids: torch.Tensor, num_channels: int,
                       num_brokers: int):
    """Per-channel result/notify/broker accounting over a flat stream, equal
    to the reference's segment sums over channel x (broker + sentinel).
    Without a scatter-add (a scatter of a large grid into a few bins
    serializes on atomics): each entry's row is reduced per broker with one
    masked pass over the (S, maxT) grid, then the (S,) row sums are summed
    per channel with one masked reduction over a (C, S) channel mask."""
    rows = [pair_valid.sum(dim=1, dtype=I32), members.sum(dim=1, dtype=I32)]
    for b in range(num_brokers):
        hit = bids == b
        rows.append(torch.where(hit, pair_bytes, 0).sum(dim=1, dtype=I32))
        rows.append(hit.sum(dim=1, dtype=I32))
    per_entry = torch.stack(rows)                               # (K, S)
    owner = ch[None, :] == torch.arange(num_channels,
                                        device=ch.device)[:, None]  # (C, S)
    sums = torch.where(owner[None], per_entry[:, None, :], 0).sum(
        dim=-1, dtype=I32)                                      # (K, C)
    return (sums[0], sums[1], sums[2::2].T.contiguous(),
            sums[3::2].T.contiguous())


def stream_to_stacked(sj: StreamJoin, stream: CandStream,
                      scanned: torch.Tensor, width: int) -> ChannelResult:
    """Re-present a stream join as a stacked (C, width, maxT) ChannelResult.

    The stream is channel-major, so channel c's entries are the contiguous
    segment [off_c, off_c + counts_c): a plain offset gather rebuilds the
    per-channel view, preserving within-channel pair order exactly.
    ``width`` need only bound the largest per-channel live count. Only
    meaningful when the stream did not truncate (``total <= S``); gathers
    past the stream clamp to its last entry and are masked."""
    S = stream.rows.shape[0]
    counts = stream.counts
    off = torch.cumsum(counts, dim=0, dtype=I32) - counts       # exclusive
    k = _arange(width, counts)
    src = off[:, None] + k[None, :]                             # (C, width)
    ok = (k[None, :] < counts[:, None]) & (src < S)
    srcc = torch.clamp(src, max=S - 1).long()
    pair_valid = sj.pair_valid[srcc] & ok[..., None]
    return ChannelResult(
        torch.where(pair_valid, sj.pair_rows[srcc], -1),
        torch.where(pair_valid, sj.pair_targets[srcc], -1),
        pair_valid,
        torch.where(ok, sj.matched_rows[srcc], -1),
        sj.matched_valid[srcc] & ok,
        sj.num_results, sj.num_notified, scanned,
        sj.broker_bytes, sj.broker_results)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _slot_row_ids(ds: R.ActiveDataset, slots: torch.Tensor) -> torch.Tensor:
    """Stable row id currently stored in each ring slot (-1 if never used)."""
    size = ds.size
    cap = ds.capacity
    # largest id == slot (mod cap) and < size; floor division, as in the
    # reference, because size - 1 - slot goes negative for unused slots
    base = torch.div(size - 1 - slots, cap, rounding_mode="floor") * cap + slots
    return torch.where(size > slots % cap, base, -1).to(I32)


def _compact(row_ids: torch.Tensor, mask: torch.Tensor,
             out_size: int):
    """Stable masked compaction along the last axis into a fixed-size buffer
    (leading axes, if any, are channels; ``row_ids`` broadcasts against
    ``mask``). Entries past the buffer are dropped: written to a discarded
    spare slot, never over the last kept one."""
    pos = torch.cumsum(mask, dim=-1, dtype=I32) - 1
    dest = torch.where(mask, pos, out_size).clamp(max=out_size)
    out = torch.full(mask.shape[:-1] + (out_size + 1,), -1, dtype=I32,
                     device=mask.device)
    out.scatter_(-1, dest.long(), torch.where(mask, row_ids, -1).to(I32))
    valid = _arange(out_size, mask) < mask.sum(dim=-1, dtype=I32)[..., None]
    return out[..., :out_size].contiguous(), valid
