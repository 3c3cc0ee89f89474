"""Broker subsystem (paper §3.2, §4.1.2, Table 2).

Brokers are HTTP endpoints in the real platform; here they are simulated but
their *work* is real and measurable, mirroring Table 2's three stages:

  receive  -- proportional to platform->broker bytes (ChannelResult.broker_bytes)
  convert  -- "converting to JSON": materialize a wire payload buffer. For the
              original layout that is one record copy per subscription; for the
              aggregated layout one record copy per group + the sID list.
  send     -- per-subscriber dispatch; identical between layouts (Table 2).

``pack_payloads_all`` / ``fanout_sids_all`` / ``deliver_all`` run every
channel's convert+send over a stacked leading channel axis C (the
single-channel engine calls them at C == 1). On a card ``deliver_all`` is
the hand-written ``deliver`` kernel (``kernels/deliver``: four launches,
every output word written once but the wire lines past each channel's
delivered count, which it leaves as they were); what follows describes the
plain version ``deliver_plain``, which the CPU and ``meta`` run. It is
gather-formulated: each output slot binary-searches its source pair in
per-channel prefix sums (batched ``torch.searchsorted(..., right=True)``
over (C, P) rows), so the work is proportional to the delivery capacity,
not to the padded pair grid. Whatever misses a delivery buffer lands, with
its channel identity, in the device-resident ``RetryRing`` when the caller
passes one (re-packed and re-delivered ahead of the fresh result on the
NEXT call, epoch-masked staleness) and past its window in flat
channel-major spill streams for the engine's host-side SpillQueue. A
ring-aware call builds its successor ring as new tensors and never writes
to the ring it was given, so a caller may discard a run and present the
same ring again.

``pack_payloads`` / ``fanout_sids`` are the per-channel convert and send
stages (one channel's result, scatter-formulated as in the reference);
the engine's ``drain_spilled`` re-delivers through them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import plans
from repro_torch.core.plans import ChannelResult
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import runs_plain

HEADER_WORDS = 4  # [row_id, target_idx, member_count, payload_words]
I32 = torch.int32


@dataclasses.dataclass
class BrokerRegistry:
    names: Dict[str, int]

    @staticmethod
    def create(*names: str) -> "BrokerRegistry":
        return BrokerRegistry({n: i for i, n in enumerate(names)})

    @property
    def num_brokers(self) -> int:
        return len(self.names)


@dataclasses.dataclass(frozen=True)
class DeliveryStats:
    """Broker delivery accounting for one executed channel (opt-in via
    ``deliver=True``): result pairs packed by the convert stage and end
    subscribers fanned out by the send stage, vs captured into the spill
    queue vs dropped outright (spill buffers full).

    Conservation, per stage: delivered + spilled + dropped == produced.
    ``overflow_*`` keeps the pre-spill-queue view (everything that missed the
    delivery buffer, recoverable or not). ``retried_*`` count retry-ring
    entries RE-presented this call (counted as spilled by an earlier call):
    produced == fresh + retried, so the identity telescopes across ticks.
    ``ranked_*`` count the pairs (and their member sIDs) that the enrichment
    stage (``core/enrich.py``) pruned past its budget before delivery: a
    subset of ``dropped_*``, 0 without a stage."""

    delivered_pairs: int
    spilled_pairs: int
    dropped_pairs: int
    delivered_sids: int
    spilled_sids: int
    dropped_sids: int
    delivered_pairs_broker: Tuple[int, ...] = ()
    retried_pairs: int = 0
    retried_sids: int = 0
    ranked_pairs: int = 0
    ranked_sids: int = 0

    @property
    def overflow_pairs(self) -> int:
        return self.spilled_pairs + self.dropped_pairs

    @property
    def overflow_sids(self) -> int:
        return self.spilled_sids + self.dropped_sids

    @property
    def overflow(self) -> int:
        return self.overflow_pairs + self.overflow_sids

    @property
    def produced_pairs(self) -> int:
        return self.delivered_pairs + self.overflow_pairs

    @property
    def produced_sids(self) -> int:
        return self.delivered_sids + self.overflow_sids

    def merged(self, other: "DeliveryStats") -> "DeliveryStats":
        return DeliveryStats(
            self.delivered_pairs + other.delivered_pairs,
            self.spilled_pairs + other.spilled_pairs,
            self.dropped_pairs + other.dropped_pairs,
            self.delivered_sids + other.delivered_sids,
            self.spilled_sids + other.spilled_sids,
            self.dropped_sids + other.dropped_sids,
            self.delivered_pairs_broker or other.delivered_pairs_broker,
            self.retried_pairs + other.retried_pairs,
            self.retried_sids + other.retried_sids,
            self.ranked_pairs + other.ranked_pairs,
            self.ranked_sids + other.ranked_sids)


def resolve_pair_sids(table: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Resolve spilled pair TARGETS to their member sID rows against the
    producing call's own sID table (host side, numpy).

    ``table`` is one channel's slice of the stacked delivery sID table:
    (tmax, cap) group tables resolve by row; the identity fanouts (0-width
    spatial / 1-wide flat) resolve to the target itself. Returns (n, w>=1)
    int32 rows, -1-padded."""
    targets = np.asarray(targets, np.int32)
    table = np.asarray(table)
    if table.ndim != 2 or table.shape[1] == 0:
        return targets[:, None].copy()
    if table.shape[0] == 0:
        return np.full((len(targets), 1), -1, np.int32)
    safe = np.clip(targets, 0, table.shape[0] - 1)
    return table[safe].astype(np.int32)


class PackedDelivery(NamedTuple):
    """Stacked convert-stage output (leading channel axis C). Channel c's
    wire lines are ``payload[c, :delivered[c]]``; the lines after them are
    zeros from the plain version and left as the buffer held them by the
    card's kernel, so no reader looks past them."""

    payload: torch.Tensor     # (C, max_pairs, width) int32 wire buffers
    delivered: torch.Tensor   # (C,) int32 pairs written
    produced: torch.Tensor    # (C,) int32 valid pairs (pre-cap)
    spill_mask: torch.Tensor  # (C, Rm*maxT) bool: valid pairs past the cap
    per_broker: torch.Tensor  # (C, B) int32 delivered pairs per broker


class FanoutDelivery(NamedTuple):
    """Stacked send-stage output (leading channel axis C)."""

    notify: torch.Tensor      # (C, max_notify) int32 flat sID dispatch
    delivered: torch.Tensor   # (C,) int32 sIDs written
    produced: torch.Tensor    # (C,) int32 member sIDs (pre-cap)


class RetryRing(NamedTuple):
    """Device-resident retry state for fused delivery: per-channel windows
    (C, W) of overflowed pairs -- with the subscription EPOCH each indexes,
    for staleness masking -- and overflowed sIDs (never stale). Entries are
    stored as compacted prefixes (``*_count`` gives each channel's live
    prefix). The ring is an INPUT and an OUTPUT of ``deliver_all``."""

    pair_rows: torch.Tensor      # (C, W) int32
    pair_targets: torch.Tensor   # (C, W) int32
    pair_epochs: torch.Tensor    # (C, W) int32
    pair_count: torch.Tensor     # (C,) int32
    sid_values: torch.Tensor     # (C, W) int32
    sid_count: torch.Tensor      # (C,) int32

    @property
    def window(self) -> int:
        return self.pair_rows.shape[1]


def empty_ring(num_channels: int, window: int,
               device: DeviceLike = "cuda") -> RetryRing:
    dev = resolve_device(device)

    def neg():
        return torch.full((num_channels, window), -1, dtype=I32, device=dev)

    def z1():
        return torch.zeros((num_channels,), dtype=I32, device=dev)

    return RetryRing(neg(), neg(), torch.zeros((num_channels, window),
                                               dtype=I32, device=dev),
                     z1(), neg(), z1())


class RingCounters(NamedTuple):
    """Per-channel (C,) ring accounting of one ring-aware delivery call."""

    retried_pairs: torch.Tensor   # ring pair entries re-presented (incl stale)
    stale_pairs: torch.Tensor     # of those, dropped for an epoch mismatch
    ring_pairs: torch.Tensor      # pairs resident in the OUTPUT ring
    retried_sids: torch.Tensor    # ring sid entries re-presented
    ring_sids: torch.Tensor       # sids resident in the OUTPUT ring


class FusedDelivery(NamedTuple):
    """Both stages plus the compacted flat spill streams (channel identity
    preserved) for the engine's SpillQueue. Ring-aware calls additionally
    carry the successor ``ring`` and its ``counters``; the spill streams
    then hold only what overflowed PAST the ring."""

    pack: PackedDelivery
    fan: FanoutDelivery
    pair_spill: plans.PairStream   # overflowed (row, channel, target) pairs
    sid_spill: plans.ValueStream   # overflowed (sid, channel) end subscribers
    ring: Optional[RetryRing] = None
    counters: Optional[RingCounters] = None


# ---------------------------------------------------------------------------
# single-channel stages (the drain path's re-delivery)
# ---------------------------------------------------------------------------


def pack_payloads(result: ChannelResult, group_sids: torch.Tensor,
                  payload_words: int, max_pairs: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Convert stage for ONE channel: compact the valid pairs, in ravel
    order, into a (max_pairs, HEADER + sid_cap + payload_words) wire
    buffer, one row per result pair. A 2-D ``group_sids`` is a group/flat
    table; any other selects the identity fanout. Returns (buffer,
    delivered, overflow): pairs beyond ``max_pairs`` are dropped and
    counted."""
    sid_cap = group_sids.shape[1] if group_sids.dim() == 2 else 1
    rows = result.pair_rows.reshape(-1)
    tgts = result.pair_targets.reshape(-1)
    valid = result.pair_valid.reshape(-1)
    pos = torch.cumsum(valid, dim=0, dtype=I32) - 1
    dest = torch.where(valid & (pos < max_pairs), pos, max_pairs)
    width = HEADER_WORDS + sid_cap + payload_words
    out = torch.zeros((max_pairs + 1, width), dtype=I32, device=rows.device)
    tgt_safe = torch.clamp(tgts, min=0)
    sids = (_take(group_sids, tgt_safe) if group_sids.dim() == 2
            else tgt_safe[:, None])
    members = (sids >= 0).sum(dim=-1, dtype=I32)
    header = torch.stack([rows, tgts, members,
                          torch.full_like(rows, payload_words)], dim=-1)
    payload = rows[:, None].expand(rows.shape[0], payload_words)
    line = torch.cat([header.to(I32), sids.to(I32), payload.to(I32)], dim=-1)
    # undelivered lines all land on the discarded spare row max_pairs
    out[dest.long()] = torch.where(valid[:, None], line, 0)
    produced = valid.sum(dtype=I32)
    delivered = torch.clamp(produced, max=max_pairs)
    return out[:max_pairs], delivered, produced - delivered


def fanout_sids(result: ChannelResult, group_sids: torch.Tensor,
                max_notify: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Send stage for ONE channel: the flat in-order list of end
    subscribers to notify, up to ``max_notify``. Returns (buffer,
    delivered, overflow)."""
    tgts = result.pair_targets.reshape(-1)
    valid = result.pair_valid.reshape(-1)
    tgt_safe = torch.clamp(tgts, min=0)
    sids = (_take(group_sids, tgt_safe) if group_sids.dim() == 2
            else tgt_safe[:, None])
    member_valid = (sids >= 0) & valid[:, None]
    flat = torch.where(member_valid, sids, -1).reshape(-1).to(I32)
    mask = flat >= 0
    pos = torch.cumsum(mask, dim=0, dtype=I32) - 1
    dest = torch.where(mask & (pos < max_notify), pos, max_notify)
    out = torch.full((max_notify + 1,), -1, dtype=I32, device=flat.device)
    out.scatter_(0, dest.long(), flat)
    produced = mask.sum(dtype=I32)
    delivered = torch.clamp(produced, max=max_notify)
    return out[:max_notify], delivered, produced - delivered


def payload_notifications(payload: np.ndarray, delivered: int,
                          payload_words: int) -> np.ndarray:
    """Expand a delivered wire buffer (host numpy) into its (row_id, sID)
    notification pairs: one per live member sID of each delivered line
    (the -1 padding is skipped). The partition-independent view of the
    convert stage."""
    buf = np.asarray(payload)[:int(delivered)]
    if buf.size == 0:
        return np.zeros((0, 2), np.int64)
    sid_cap = buf.shape[1] - HEADER_WORDS - payload_words
    sids = buf[:, HEADER_WORDS:HEADER_WORDS + sid_cap].astype(np.int64)
    rows = np.broadcast_to(buf[:, :1].astype(np.int64), sids.shape)
    live = sids >= 0
    return np.stack([rows[live], sids[live]], axis=1)


def clear_dead_lines(payload: np.ndarray, delivered) -> np.ndarray:
    """Zero, in place, each channel's wire lines past its delivered count
    in a host copy of ``PackedDelivery.payload`` ((C, max_pairs, width)),
    so that a buffer the card's kernel left there reads as the plain
    version's. Returns ``payload``."""
    for c, d in enumerate(np.asarray(delivered).reshape(-1).tolist()):
        payload[c, max(int(d), 0):] = 0
    return payload


def _take(table: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """``table[idx...]`` with the reference's clamping gather semantics; an
    empty axis reads zeros (every such read is masked by the caller)."""
    shape = torch.broadcast_shapes(*(i.shape for i in idx))
    if any(table.shape[d] == 0 for d in range(len(idx))):
        return torch.zeros(shape + table.shape[len(idx):], dtype=table.dtype,
                           device=table.device)
    return table[tuple(torch.clamp(i, 0, table.shape[d] - 1).long()
                       for d, i in enumerate(idx))]


def _ch(C: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(C, dtype=I32, device=like.device)[:, None]


def _pair_layout(result: ChannelResult):
    """Per-channel pair bookkeeping shared by the stacked delivery stages:
    (valid2, rows2, tgt2, cumv), all (C, P)-shaped. ``cumv`` is the
    inclusive per-channel prefix count of valid pairs (ravel order) — slot
    q's source pair is ``searchsorted(cumv[c], q, right=True)``. One
    delivery computes it once and hands it to every stage."""
    C = result.pair_valid.shape[0]
    valid2 = result.pair_valid.reshape(C, -1)
    rows2 = result.pair_rows.reshape(C, -1)
    tgt2 = result.pair_targets.reshape(C, -1)
    return valid2, rows2, tgt2, torch.cumsum(valid2, dim=1, dtype=I32)


def _caps(caps, cap_limit: int, like: torch.Tensor) -> torch.Tensor:
    """(C,) int32 per-channel delivery caps, at most ``cap_limit``."""
    if caps is None:
        return torch.full((like.shape[0],), cap_limit, dtype=I32,
                          device=like.device)
    return torch.clamp(torch.as_tensor(caps, dtype=I32, device=like.device),
                       max=cap_limit)


def _member_counts(group_sids: torch.Tensor, valid2: torch.Tensor,
                   tgt2: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, P) member count per pair. With ``counts`` (C, T) — the
    ``TargetArrays.counts`` the engine already maintains — the pass is one
    O(C*P) gather; without it the table is re-derived from ``group_sids``.
    Requires group rows to pack members as a -1-padded PREFIX."""
    if group_sids.shape[-1] == 0:       # identity fanout: 1 member per pair
        return (valid2 & (tgt2 >= 0)).to(I32)
    if counts is None:
        counts = (group_sids >= 0).sum(dim=-1, dtype=I32)
    ch = _ch(valid2.shape[0], valid2)
    return torch.where(valid2, _take(counts, ch, torch.clamp(tgt2, min=0)),
                       0).to(I32)


def _pack_lines(rows: torch.Tensor, tgts: torch.Tensor, ok: torch.Tensor,
                ch: torch.Tensor, group_sids: torch.Tensor, counts,
                payload_words: int, target_brokers,
                num_brokers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble the convert-stage wire lines + one-hot per-broker accounting
    for already-resolved (C, Q) output slots (``rows``/``tgts`` masked to 0
    where not ``ok``) — the single definition of the wire format."""
    tgt_safe = torch.where(ok, torch.clamp(tgts, min=0), 0)
    if group_sids.shape[-1] == 0:       # identity fanout
        members = ok.to(I32)
        sids = tgt_safe[..., None]
    else:
        m_table = (counts if counts is not None else
                   (group_sids >= 0).sum(dim=-1, dtype=I32))
        members = torch.where(ok, _take(m_table, ch, tgt_safe), 0).to(I32)
        sids = _take(group_sids, ch, tgt_safe)
    header = torch.stack([rows, tgts, members,
                          torch.where(ok, payload_words, 0).to(I32)], dim=-1)
    payload = rows[..., None].expand(rows.shape + (payload_words,))
    line = torch.cat([header.to(I32), torch.where(ok[..., None], sids, 0).to(I32),
                      payload.to(I32)], dim=-1)
    if target_brokers is None or num_brokers == 0:
        per_broker = torch.zeros((rows.shape[0], 0), dtype=I32,
                                 device=rows.device)
    else:
        bids = torch.where(ok, _take(target_brokers, ch, tgt_safe),
                           num_brokers)
        one_hot = bids[..., None] == torch.arange(num_brokers, dtype=I32,
                                                  device=rows.device)
        per_broker = one_hot.sum(dim=1, dtype=I32)
    return torch.where(ok[..., None], line, 0), per_broker


def _source_pair(cum: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-channel binary search: source index for each output rank. ``cum``
    (C, P) inclusive prefix counts, ``q`` (C, Q) target ranks -> (C, Q)."""
    return torch.searchsorted(cum.contiguous(), q.contiguous(),
                              right=True).to(I32)


def _gather(arr2: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr2, 1, p.long())


def _ranks(C: int, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device).expand(C, n)


def pack_payloads_all(result: ChannelResult, group_sids: torch.Tensor,
                      payload_words: int, max_pairs: int,
                      caps: Optional[torch.Tensor] = None,
                      target_brokers: Optional[torch.Tensor] = None,
                      num_brokers: int = 0,
                      counts: Optional[torch.Tensor] = None
                      ) -> PackedDelivery:
    """Convert stage for EVERY channel at once. ``result`` leaves carry a
    leading C axis; ``group_sids`` is (C, T, cap) for group/flat tables or
    (C, 0) to select the identity fanout (spatial channels). ``caps`` (C,)
    bounds delivery per channel (default: the shared buffer size);
    ``target_brokers`` (C, T) enables one-hot per-broker accounting of
    delivered pairs; ``counts`` (C, T) supplies the maintained member
    counts."""
    layout = _pair_layout(result)
    return _pack(layout, _caps(caps, max_pairs, layout[0]), group_sids,
                 payload_words, max_pairs, target_brokers, num_brokers, counts)


def _pack(layout, cap_p: torch.Tensor, group_sids: torch.Tensor,
          payload_words: int, max_pairs: int, target_brokers,
          num_brokers: int, counts) -> PackedDelivery:
    valid2, rows2, tgt2, cumv = layout
    C, P = valid2.shape
    ch = _ch(C, valid2)
    produced = cumv[:, -1]
    delivered = torch.minimum(produced, cap_p)
    q = _ranks(C, max_pairs, valid2)
    p = torch.clamp(_source_pair(cumv, q), max=P - 1)          # (C, max_pairs)
    ok = q < delivered[:, None]
    rows = torch.where(ok, _gather(rows2, p), 0)
    tgts = torch.where(ok, _gather(tgt2, p), 0)
    out, per_broker = _pack_lines(rows, tgts, ok, ch, group_sids, counts,
                                  payload_words, target_brokers, num_brokers)
    spill_mask = valid2 & (cumv - 1 >= cap_p[:, None])
    return PackedDelivery(out, delivered, produced, spill_mask, per_broker)


def _member_value(group_sids: torch.Tensor, ch, tgt_safe: torch.Tensor,
                  j: torch.Tensor) -> torch.Tensor:
    """sID of member ``j`` of the pair targeting ``tgt_safe``, per channel."""
    if group_sids.shape[-1] == 0:
        return tgt_safe                     # identity fanout, j is always 0
    return _take(group_sids, ch, tgt_safe,
                 torch.clamp(j, max=group_sids.shape[-1] - 1))


def fanout_sids_all(result: ChannelResult, group_sids: torch.Tensor,
                    max_notify: int,
                    caps: Optional[torch.Tensor] = None,
                    counts: Optional[torch.Tensor] = None) -> FanoutDelivery:
    """Send stage for EVERY channel at once, with per-channel caps. Each
    notify slot binary-searches its source pair in the per-channel member
    prefix sums and gathers the sID directly."""
    layout = _pair_layout(result)
    return _fanout_parts(layout, _caps(caps, max_notify, layout[0]),
                         group_sids, max_notify, counts)[0]


def _fanout_parts(layout, cap_n: torch.Tensor, group_sids: torch.Tensor,
                  max_notify: int, counts: Optional[torch.Tensor] = None):
    """The send stage plus its member counts and prefix sums, so
    ``deliver_all`` resolves spill slots against the same prefix sums."""
    valid2, _, tgt2, _ = layout
    C = valid2.shape[0]
    members = _member_counts(group_sids, valid2, tgt2, counts)  # (C, P)
    cumm = torch.cumsum(members, dim=1, dtype=I32)
    produced = cumm[:, -1]
    delivered = torch.minimum(produced, cap_n)
    k = _ranks(C, max_notify, valid2)
    notify = _member_lookup(group_sids, tgt2, members, cumm, k,
                            k < delivered[:, None])
    return FanoutDelivery(notify, delivered, produced), members, cumm


def _member_lookup(group_sids, tgt2, members, cumm, k, ok) -> torch.Tensor:
    """Resolve per-channel member ranks ``k`` (C, Q) to sIDs: binary-search
    the owning pair, derive the in-pair offset, gather. -1 where not ``ok``."""
    P = tgt2.shape[1]
    ch = _ch(tgt2.shape[0], tgt2)
    p = torch.clamp(_source_pair(cumm, k), max=P - 1)
    j = k - (_gather(cumm, p) - _gather(members, p))           # rank in pair
    tgt_safe = torch.clamp(_gather(tgt2, p), min=0)
    return torch.where(ok, _member_value(group_sids, ch, tgt_safe, j),
                       -1).to(I32)


def deliver_all(result: ChannelResult, group_sids: torch.Tensor,
                payload_words: int, max_pairs: int, max_notify: int,
                spill_cap: int,
                caps_pairs: Optional[torch.Tensor] = None,
                caps_notify: Optional[torch.Tensor] = None,
                target_brokers: Optional[torch.Tensor] = None,
                num_brokers: int = 0,
                counts: Optional[torch.Tensor] = None,
                ring: Optional[RetryRing] = None,
                epochs: Optional[torch.Tensor] = None) -> FusedDelivery:
    """The whole fused convert+send, plus spill capture: everything that
    missed a delivery buffer lands — with its channel identity — in a flat
    channel-major spill stream holding up to ``spill_cap`` entries PER
    CHANNEL per lane (the first ``spill_cap`` overflow entries of each
    channel are captured; the rest are truncated for the caller to count as
    drops). Spill slots gather their entry straight from the per-channel
    overflow windows, so spill work is O(C * spill_cap).

    With ``ring`` (+ ``epochs``, the (C,) current subscription epoch per
    channel) the call is RING-AWARE: resident ring entries whose epoch still
    matches are delivered FIRST (stale ones are dropped and counted), fresh
    result pairs follow, and the live overflow tail re-enters the output
    ring up to its window; only what overflows PAST the ring reaches the
    spill streams.

    A CUDA tensor launches the ``deliver`` kernel (``kernels/deliver``);
    a ``cpu`` or ``meta`` tensor runs the plain version, ``deliver_plain``.
    Both give the same ``FusedDelivery``, bit for bit, but for the wire
    lines past each channel's ``pack.delivered`` count: zeros from the plain
    version, left as the buffer held them by the kernel (``PackedDelivery``).
    """
    args = (result, group_sids, payload_words, max_pairs, max_notify,
            spill_cap, caps_pairs, caps_notify, target_brokers, num_brokers,
            counts, ring, epochs)
    if runs_plain(result.pair_valid):
        return deliver_plain(*args)
    from repro_torch.kernels.deliver import ops
    return ops.deliver(*args)


def deliver_plain(result: ChannelResult, group_sids: torch.Tensor,
                  payload_words: int, max_pairs: int, max_notify: int,
                  spill_cap: int,
                  caps_pairs: Optional[torch.Tensor] = None,
                  caps_notify: Optional[torch.Tensor] = None,
                  target_brokers: Optional[torch.Tensor] = None,
                  num_brokers: int = 0,
                  counts: Optional[torch.Tensor] = None,
                  ring: Optional[RetryRing] = None,
                  epochs: Optional[torch.Tensor] = None) -> FusedDelivery:
    """``deliver_all`` in PyTorch operations: the plain version of the
    ``deliver`` kernel."""
    if ring is not None:
        return _deliver_with_ring(result, group_sids, payload_words,
                                  max_pairs, max_notify, spill_cap, ring,
                                  epochs, caps_pairs, caps_notify,
                                  target_brokers, num_brokers, counts)
    layout = _pair_layout(result)
    valid2, rows2, tgt2, cumv = layout
    P = valid2.shape[1]
    cap_p = _caps(caps_pairs, max_pairs, valid2)
    pack = _pack(layout, cap_p, group_sids, payload_words, max_pairs,
                 target_brokers, num_brokers, counts)

    # pairs lane: spill slot (c, i) -> in-channel pair rank cap_c + i ->
    # source pair, by binary search + gather
    ov_p = pack.produced - pack.delivered                      # (C,)
    ch_r, k_r, valid_r, total_p = _spill_slots(ov_p, cap_p, spill_cap)
    pr = _row_search(cumv, P + 1, ch_r, k_r).long()
    chl = ch_r.long()

    def take(arr2):
        return torch.where(valid_r, arr2[chl, pr], -1).to(I32)

    pair_spill = plans.PairStream(take(rows2),
                                  torch.where(valid_r, ch_r, -1).to(I32),
                                  take(tgt2), valid_r, total_p)

    # sids lane: same scheme over the send stage's member prefix sums
    cap_n = _caps(caps_notify, max_notify, valid2)
    fan, members, cumm = _fanout_parts(layout, cap_n, group_sids, max_notify,
                                       counts)
    ov_s = fan.produced - fan.delivered
    ch_s, k_s, valid_s, total_s = _spill_slots(ov_s, cap_n, spill_cap)
    sid_cap = 1 if group_sids.shape[-1] == 0 else group_sids.shape[-1]
    p_s = _row_search(cumm, P * sid_cap + 1, ch_s, k_s).long()
    chs = ch_s.long()
    j_s = k_s - (cumm[chs, p_s] - members[chs, p_s])
    tgt_s = torch.clamp(tgt2[chs, p_s], min=0)
    vals = torch.where(valid_s, _member_value(group_sids, ch_s, tgt_s, j_s),
                       -1).to(I32)
    sid_spill = plans.ValueStream(vals, torch.where(valid_s, ch_s, -1).to(I32),
                                  valid_s, total_s)
    return FusedDelivery(pack, fan, pair_spill, sid_spill)


def _deliver_with_ring(result: ChannelResult, group_sids: torch.Tensor,
                       payload_words: int, max_pairs: int, max_notify: int,
                       spill_cap: int, ring: RetryRing, epochs,
                       caps_pairs, caps_notify, target_brokers,
                       num_brokers: int, counts) -> FusedDelivery:
    """Ring-aware fused delivery. Per channel, the delivery order is: live
    (epoch-matching) ring entries in residence order, then the fresh valid
    pairs in ravel order. The live overflow tail -- ranks past the cap --
    re-enters the output ring (first W entries), then the spill stream
    (next spill_cap), then truncates to counted drops. Everything is
    gather-formulated against the ring's live prefix sums and the fresh
    prefix sums; the successor ring is built from new tensors."""
    layout = _pair_layout(result)
    valid2, rows2, tgt2, cumv = layout
    C, P = valid2.shape
    W = ring.window
    dev = valid2.device
    epochs = torch.as_tensor(epochs, dtype=I32, device=dev)
    nfresh = cumv[:, -1]
    cap_p = _caps(caps_pairs, max_pairs, valid2)
    ch = _ch(C, valid2)
    identity = group_sids.shape[-1] == 0

    # ---- pairs lane -----------------------------------------------------
    iw = torch.arange(W, dtype=I32, device=dev)[None, :]
    in_ring = iw < ring.pair_count[:, None]
    live_r = in_ring & (ring.pair_epochs == epochs[:, None])
    cumr = torch.cumsum(live_r, dim=1, dtype=I32)              # (C, W)
    nring = cumr[:, -1]
    stale = ring.pair_count - nring
    produced = ring.pair_count + nfresh
    delivered = torch.minimum(nring + nfresh, cap_p)

    def comb_pairs(q, ok):
        """(rows, tgts) for combined-order ranks ``q`` (C, Q): ring entries
        first, fresh pairs after."""
        from_ring = q < nring[:, None]
        pr = torch.clamp(_source_pair(cumr, q), max=W - 1)
        qf = torch.clamp(q - nring[:, None], min=0)
        pf = torch.clamp(_source_pair(cumv, qf), max=P - 1)
        rows = torch.where(from_ring, _gather(ring.pair_rows, pr),
                           _gather(rows2, pf))
        tgts = torch.where(from_ring, _gather(ring.pair_targets, pr),
                           _gather(tgt2, pf))
        return (torch.where(ok, rows, -1).to(I32),
                torch.where(ok, tgts, -1).to(I32))

    q = _ranks(C, max_pairs, valid2)
    ok = q < delivered[:, None]
    rows_q, tgts_q = comb_pairs(q, ok)
    out, per_broker = _pack_lines(
        torch.where(ok, rows_q, 0), torch.where(ok, tgts_q, 0), ok, ch,
        group_sids, counts, payload_words, target_brokers, num_brokers)
    pack = PackedDelivery(out, delivered, produced, torch.zeros_like(valid2),
                          per_broker)

    # live overflow tail -> output ring window, then spill stream
    ov_live = nring + nfresh - delivered                       # (C,)
    i_new = _ranks(C, W, valid2)
    ok_new = i_new < torch.clamp(ov_live, max=W)[:, None]
    nrows, ntgts = comb_pairs(delivered[:, None] + i_new, ok_new)
    ring_p_count = torch.clamp(ov_live, max=W)
    r = torch.arange(C * spill_cap, dtype=I32, device=dev)
    ch_r = torch.div(r, spill_cap, rounding_mode="floor")
    i_r = r % spill_cap
    chl = ch_r.long()
    valid_r = (W + i_r) < ov_live[chl]
    # spill ranks start at delivered + W >= nring: always FRESH-sourced
    k_r = delivered[chl] + W + i_r                  # combined-order rank
    pf_r = _row_search(cumv, P + 1, ch_r, k_r - nring[chl]).long()
    total_p = torch.clamp(ov_live - W, min=0).sum(dtype=I32)
    pair_spill = plans.PairStream(
        torch.where(valid_r, rows2[chl, pf_r], -1).to(I32),
        torch.where(valid_r, ch_r, -1).to(I32),
        torch.where(valid_r, tgt2[chl, pf_r], -1).to(I32), valid_r, total_p)

    # ---- sids lane ------------------------------------------------------
    cap_n = _caps(caps_notify, max_notify, valid2)
    fan0, members, cumm = _fanout_parts(layout, cap_n, group_sids,
                                        max_notify, counts)
    rsc = ring.sid_count
    produced_s = rsc + fan0.produced
    delivered_s = torch.minimum(produced_s, cap_n)

    def comb_sids(k, ok):
        """sIDs for combined-order ranks ``k`` (C, Q): resident ring sids
        (a compacted prefix: direct index) first, fresh members after."""
        from_ring = k < rsc[:, None]
        r_val = _gather(ring.sid_values, torch.clamp(k, max=W - 1))
        kf = torch.clamp(k - rsc[:, None], min=0)
        f_val = _member_lookup(group_sids, tgt2, members, cumm, kf, ok)
        return torch.where(ok, torch.where(from_ring, r_val, f_val),
                           -1).to(I32)

    k = _ranks(C, max_notify, valid2)
    notify = comb_sids(k, k < delivered_s[:, None])
    fan = FanoutDelivery(notify, delivered_s, produced_s)
    ov_s = produced_s - delivered_s
    ok_snew = i_new < torch.clamp(ov_s, max=W)[:, None]
    nsids = comb_sids(delivered_s[:, None] + i_new, ok_snew)
    ring_s_count = torch.clamp(ov_s, max=W)
    valid_s = (W + i_r) < ov_s[chl]
    # same invariant as the pairs lane: spill slots are fresh member lookups
    kf_s = delivered_s[chl] + W + i_r - rsc[chl]
    sid_cap = 1 if identity else group_sids.shape[-1]
    p_s = _row_search(cumm, P * sid_cap + 1, ch_r, kf_s).long()
    j_s = kf_s - (cumm[chl, p_s] - members[chl, p_s])
    tgt_s = torch.clamp(tgt2[chl, p_s], min=0)
    vals = torch.where(valid_s, _member_value(group_sids, ch_r, tgt_s, j_s),
                       -1).to(I32)
    total_s = torch.clamp(ov_s - W, min=0).sum(dtype=I32)
    sid_spill = plans.ValueStream(vals, torch.where(valid_s, ch_r, -1).to(I32),
                                  valid_s, total_s)

    new_ring = RetryRing(nrows, ntgts, epochs[:, None].expand(C, W).clone(),
                         ring_p_count, nsids, ring_s_count)
    counters = RingCounters(ring.pair_count, stale, ring_p_count, rsc,
                            ring_s_count)
    return FusedDelivery(pack, fan, pair_spill, sid_spill, new_ring,
                         counters)


def _row_search(cum2: torch.Tensor, offset: int, ch: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """``searchsorted(cum2[ch_i], k_i, right=True)`` for per-slot channels,
    as ONE global search over the offset-flattened prefix array (``offset``
    > any row value makes it non-decreasing across row boundaries). The
    flattened keys are int64 so large offsets cannot wrap."""
    C, P = cum2.shape
    rows = torch.arange(C, dtype=torch.int64, device=cum2.device)[:, None]
    flat = (cum2.to(torch.int64) + offset * rows).reshape(-1)
    idx = torch.searchsorted(flat, k.to(torch.int64) + offset * ch.to(torch.int64),
                             right=True)
    return torch.clamp(idx - ch.to(torch.int64) * P, 0, P - 1).to(I32)


def _spill_slots(ov: torch.Tensor, cap, spill_cap: int):
    """Per-channel spill windows flattened channel-major: slot r = c *
    spill_cap + i holds channel c's i-th overflow entry (in-channel rank
    cap_c + i), valid while i < min(ov_c, spill_cap). ``total`` is the full
    (pre-truncation) overflow across channels."""
    C = ov.shape[0]
    r = torch.arange(C * spill_cap, dtype=I32, device=ov.device)
    ch = torch.div(r, spill_cap, rounding_mode="floor")
    i = r % spill_cap
    chl = ch.long()
    return (ch, cap[chl] + i, i < torch.clamp(ov, max=spill_cap)[chl],
            ov.sum(dtype=I32))


def broker_traffic_summary(result: ChannelResult,
                           delivery: Optional[DeliveryStats] = None
                           ) -> Dict[str, np.ndarray]:
    """Per-broker traffic view of one channel result. With ``delivery`` (the
    DeliveryStats of a deliver=True execution) the summary also carries the
    delivery accounting — delivered / spilled / dropped per stage and the
    per-broker delivered split."""
    def host(t):
        return t.cpu().numpy()

    out = {
        "bytes_per_broker": host(result.broker_bytes),
        "results_per_broker": host(result.broker_results),
        "total_bytes": host(result.broker_bytes.sum(dtype=I32)),
        "total_results": host(result.num_results),
        "total_notified": host(result.num_notified),
    }
    if delivery is not None:
        out.update({
            "delivered_pairs": np.asarray(delivery.delivered_pairs),
            "spilled_pairs": np.asarray(delivery.spilled_pairs),
            "dropped_pairs": np.asarray(delivery.dropped_pairs),
            "delivered_sids": np.asarray(delivery.delivered_sids),
            "spilled_sids": np.asarray(delivery.spilled_sids),
            "dropped_sids": np.asarray(delivery.dropped_sids),
            "delivered_pairs_per_broker":
                np.asarray(delivery.delivered_pairs_broker, dtype=np.int64),
        })
    return out
