"""The yardstick of the rooflines: the card's published peaks and the
bytes each kernel must move on its own inputs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
full 700 W; a card set below that runs slower, so every result line
carries the card's power limit beside its shares.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12       # HBM3
BF16_OPS_PER_S = 989e12         # tensor cores, dense
F32_OPS_PER_S = 67e12           # CUDA cores


def join_compact_bytes(tgt, tgt_n, members, brokers, valid, payload) -> int:
    """The bytes ``join_compact`` must move on these inputs (a frozen copy
    of ``chip_smoke.join_compact_bytes``): its four outputs (13 B an
    entry), 9 B of ``valid``, ``tgt_n`` and ``payload`` a stream entry, and
    of the (S, maxT) inputs only what decides or fills a live pair, in 32-B
    sectors (8 entries of a row): ``tgt`` where ``valid[s]`` and
    ``t < tgt_n[s]``, ``members`` and ``brokers`` where the pair is live."""
    s_len, max_t = tgt.shape
    col = torch.arange(max_t, device=tgt.device)
    read = valid[:, None] & (col[None, :] < tgt_n[:, None])
    live = read & (tgt >= 0)

    def sectors(mask) -> int:
        pad = mask.new_zeros((s_len, -max_t % 8))
        return int(torch.cat([mask, pad], 1).view(s_len, -1, 8).any(-1).sum())

    return (13 * s_len * max_t + 9 * s_len + 32 * sectors(read)
            + 64 * sectors(live))


def predicate_filter_bytes(n: int, f: int, c: int) -> int:
    """``predicate_filter`` over (n, f) int32 fields for c channels: the
    fields once, the canonical (lo, hi, neq) tables and the (n, c) bool
    output (``chip_smoke.case_predicate_filter``'s bound)."""
    return n * f * 4 + 3 * c * f * 4 + n * c


def bound_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
