"""Plain version of the join_compact kernel: pair expansion over a compacted
candidate stream.

The compacted execution join ("compact"/"compact_pallas" backends,
``core/plans.py join_param_stream``) gathers, per stream entry, the owning
channel's join-map row and its member/broker tables; this expands those
per-entry gathers into the (S, maxT) pair grids: validity, member counts,
wire bytes, broker ids. Everything is int32 arithmetic (wrapping modulo
2^32), so the kernel and this version agree bit for bit.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def join_pairs(tgt: torch.Tensor, tgt_n: torch.Tensor, members: torch.Tensor,
               brokers: torch.Tensor, valid: torch.Tensor,
               payload: torch.Tensor, num_brokers: int, aggregated: bool):
    """tgt (S, maxT) int32 target slots (-1 padded), tgt_n (S,) live targets
    per entry, members/brokers (S, maxT) int32 per-target gathers, valid (S,)
    bool entry mask (post semi-join), payload (S,) int32 bytes per pair.

    Returns (pair_valid (S, maxT) bool, members (S, maxT) int32,
    pair_bytes (S, maxT) int32, bids (S, maxT) int32 with the sentinel
    ``num_brokers`` on invalid pairs). Aggregated pairs carry their member
    sID list on the wire (4 B each) -- paper §4.1.2."""
    max_t = tgt.shape[1]
    cols = torch.arange(max_t, dtype=I32, device=tgt.device)[None, :]
    pair_valid = valid[:, None] & (cols < tgt_n[:, None]) & (tgt >= 0)
    mem = torch.where(pair_valid, members, 0).to(I32)
    per = payload[:, None].to(I32) + (4 * mem if aggregated else 0)
    pair_bytes = torch.where(pair_valid, per, 0).to(I32)
    bids = torch.where(pair_valid, brokers, num_brokers).to(I32)
    return pair_valid, mem, pair_bytes, bids
