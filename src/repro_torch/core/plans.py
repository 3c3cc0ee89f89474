"""Executable channel plans: original vs the three optimizations (paper §4).

This is the padded single-channel part of the plan layer, as plain
functions on tensors:

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
at ingest, ``kernels/spatial_match`` in the spatial join). The compacted
``"compact"``/``"compact_pallas"`` formulations are named here but not yet
ported.

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


def _broker_sums(values: torch.Tensor, bids: torch.Tensor,
                 num_brokers: int) -> torch.Tensor:
    """(B,) int32 per-broker sums of ``values``; entries whose broker id lies
    outside [0, B) (the sentinel ``num_brokers``) count nowhere. One masked
    reduction per broker — the reference's ``fused`` formulation, equal to
    its segment sum — because a scatter-add of a large pair grid into a
    handful of bins serializes on atomics."""
    sums = [torch.where(bids == b, values, 0).sum(dtype=I32)
            for b in range(num_brokers)]
    if not sums:
        return torch.zeros((0,), dtype=I32, device=values.device)
    return torch.stack(sums)


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
    broker_bytes = _broker_sums(pair_bytes, bids, num_brokers)
    broker_results = _broker_sums(pair_valid.to(I32), bids, num_brokers)
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
    broker_results = _broker_sums(per_user, user_brokers, num_brokers)
    broker_bytes = (broker_results.to(torch.int64)
                    * int(payload_bytes)).to(I32)
    return ChannelResult(pair_rows.to(I32), pair_targets.to(I32), pair_valid,
                         torch.where(cand.valid, cand.rows, -1), cand.valid,
                         num_results, num_results, cand.scanned,
                         broker_bytes, broker_results)


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
    """Stable masked compaction into a fixed-size buffer; entries past it are
    dropped (written to a discarded spare slot, never over the last one)."""
    pos = torch.cumsum(mask, dim=0, dtype=I32) - 1
    dest = torch.where(mask, pos, out_size).clamp(max=out_size)
    out = torch.full((out_size + 1,), -1, dtype=I32, device=row_ids.device)
    out.scatter_(0, dest.long(), torch.where(mask, row_ids, -1).to(I32))
    valid = _arange(out_size, row_ids) < mask.sum(dtype=I32)
    return out[:out_size], valid
