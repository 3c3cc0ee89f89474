"""The BAD index (paper §4.3): a PK-only partial index fed at ingestion time.

Per channel we keep an append-only buffer of row ids (primary keys) of records
that satisfied *all* of the channel's fixed predicates when they were
ingested, plus a watermark: the buffer length at the previous channel
execution. Entries in ``[watermark, count)`` are exactly the "new since last
execution" records — the LSM time-filter realization of ``is_new``.

Buffers have a fixed capacity and are updated IN PLACE (``insert`` and the
watermark functions overwrite the state's tensors and return the same
state). The ingestion-side predicate evaluation lives in
``predicates.evaluate_conditions`` / ``kernels.predicate_filter``; this
module consumes the (N, C) match bitmap.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class BADIndexState:
    """Stacked per-channel index buffers.

    row_ids:    (C, cap) int32 -- appended PKs, -1 padded
    counts:     (C,) int32     -- live entries per channel
    watermarks: (C,) int32     -- counts at last execution (time filter)
    overflowed: (C,) bool      -- capacity exceeded since last execution
    """

    row_ids: torch.Tensor
    counts: torch.Tensor
    watermarks: torch.Tensor
    overflowed: torch.Tensor

    @property
    def num_channels(self) -> int:
        return int(self.row_ids.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.row_ids.shape[1])

    @staticmethod
    def create(num_channels: int, capacity: int,
               device: DeviceLike = "cuda") -> "BADIndexState":
        dev = resolve_device(device)
        return BADIndexState(
            row_ids=torch.full((num_channels, capacity), -1, dtype=torch.int32,
                               device=dev),
            counts=torch.zeros((num_channels,), dtype=torch.int32, device=dev),
            watermarks=torch.zeros((num_channels,), dtype=torch.int32,
                                   device=dev),
            overflowed=torch.zeros((num_channels,), dtype=torch.bool,
                                   device=dev),
        )


def insert(state: BADIndexState, row_ids: torch.Tensor,
           matches: torch.Tensor) -> BADIndexState:
    """Append matching row ids to every channel's buffer, in place
    (Algorithm 2): a stable per-channel compaction; entries past capacity
    are dropped and set the channel's sticky ``overflowed`` flag.

    row_ids: (N,) int32 of the just-ingested records
    matches: (N, C) bool from the conditionsList evaluation
    """
    cap = state.capacity
    mask = matches.T                                          # (C, N)
    pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    dest = state.counts[:, None] + pos                        # (C, N)
    n_new = mask.sum(dim=1, dtype=torch.int32)
    keep = mask & (dest < cap)        # the reference's scatter drops the rest
    with trace.span("read.index_insert"):
        # nonzero reads its count back before it can size the output
        ch, col = keep.nonzero(as_tuple=True)
    state.row_ids[ch, dest[ch, col].long()] = row_ids[col]
    state.overflowed |= state.counts + n_new > cap
    state.counts.copy_(torch.clamp(state.counts + n_new, max=cap))
    return state


def make_room(state: BADIndexState,
              matches: torch.Tensor) -> Tuple[int, np.ndarray]:
    """Before ``insert(state, ..., matches)``: move the live window
    ``[watermark, count)`` of every channel that the insert would carry
    past the capacity to the front of its buffer, in place on the device.
    The entries below a watermark are delivered (``compact`` drops them
    the same way), and every read of the index is relative to the
    watermark, so nothing a later execution sees changes. One host read
    (the counts, watermarks and new entries).

    Returns the largest count the insert leaves in a channel that it does
    not overflow, and the channels it overflows, as ``insert`` says: each
    holds watermark 0 (never executed, or its live window alone does not
    fit), so nothing here can make room in it until an execution moves
    its watermark."""
    cap = state.capacity
    with trace.span("read.index_counts"):
        counts, wms, n_new = torch.stack(
            [state.counts, state.watermarks,
             matches.sum(dim=0, dtype=torch.int32)]).cpu().numpy()
    for c in np.flatnonzero((counts + n_new > cap) & (wms > 0)):
        _to_front(state, c, int(wms[c]), int(counts[c]))
        counts[c] -= wms[c]
    after = counts + n_new
    full = np.flatnonzero(after > cap)
    return int(np.delete(after, full).max(initial=0)), full


def _to_front(state: BADIndexState, c: int, wm: int, count: int) -> None:
    """Channel ``c``'s live window ``[wm, count)`` to the front of its
    buffer, in place; its watermark to 0."""
    live = count - wm
    if live:
        state.row_ids[c, :live] = state.row_ids[c, wm:count].clone()
    state.row_ids[c, live:count].fill_(-1)
    # fill_ takes the value as a kernel argument: no host copy
    state.counts[c:c + 1].fill_(live)
    state.watermarks[c:c + 1].fill_(0)


def new_entries(state: BADIndexState, channel: int,
                max_new: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window of entries since the watermark for one channel.

    Returns (row_ids (max_new,) int32, valid (max_new,) bool). max_new is a
    static bound (the per-period ingest budget); excess entries beyond it are
    reported via count so callers can iterate.
    """
    wm = state.watermarks[channel]
    count = state.counts[channel]
    idx = wm + torch.arange(max_new, dtype=torch.int32,
                            device=state.row_ids.device)
    valid = idx < count
    safe = torch.clamp(idx, max=state.capacity - 1).long()
    rows = torch.where(valid, state.row_ids[channel][safe], -1)
    return rows, valid


def advance_watermark(state: BADIndexState, channel: int) -> BADIndexState:
    """Mark the channel as executed (in place): future reads see only newer
    entries."""
    state.watermarks[channel] = state.counts[channel]
    state.overflowed[channel] = False
    return state


def advance_watermarks(state: BADIndexState,
                       channels: torch.Tensor) -> BADIndexState:
    """Vectorized ``advance_watermark`` for a batch of executed channels."""
    channels = channels.long()
    state.watermarks[channels] = state.counts[channels]
    # the value as a kernel argument: assigning ``False`` by index copies a
    # host scalar to the device, which waits for the stream
    state.overflowed.index_fill_(0, channels, False)
    return state


def compact(state: BADIndexState) -> BADIndexState:
    """Drop already-delivered entries (host-side maintenance between periods).

    Shifts each channel's live window ``[watermark, count)`` to the front so
    the fixed-capacity buffer behaves like the paper's LSM merge of old
    components. Returns a new state on the same device.
    """
    new = BADIndexState(state.row_ids.clone(), state.counts.clone(),
                        state.watermarks.clone(), state.overflowed.clone())
    counts, wms = torch.stack([state.counts, state.watermarks]).cpu().numpy()
    for c in range(new.num_channels):
        _to_front(new, c, int(wms[c]), int(counts[c]))
    return new
