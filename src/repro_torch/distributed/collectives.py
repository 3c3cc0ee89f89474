"""Sequence-parallel flash-decode attention and the sharded BAD engine's
cross-shard notification shuffle, in one process.

The reference expresses both as ``shard_map`` collectives inside one
single-controller program: one process drives every shard's device. The
port keeps that design. ``torch.distributed`` would be one process per
rank, and NCCL refuses two ranks on one card, so the port uses no process
group: the single-process counterpart of an all-gather is a copy of each
source row to each owner's device (none when the devices are the same),
and a ``pmax`` / ``psum`` is a reduction over the partials moved to one
device.

``sp_decode_attention``: the KV cache splits on its SEQUENCE dimension into
``rules.model_size`` slices (any GQA geometry works: head counts never need
to divide the axis). Slice ``j`` on ``rules.model_devices[j]`` computes the
flash partials (acc, m, l) of its keys with the ``flash_decode`` kernel's
partial entry (its plain version on a CPU tensor); the merge is the exact
log-sum-exp combine of the reference (max of m, the ``isfinite`` guards, a
sum of the rescaled acc and l), then ``ref.normalize``.

``shuffle_notify``: each shard's fused delivery emits a notify buffer of
end-subscriber sIDs; the subscription lives on the shard its sID hashes to,
but its BROKER endpoint lives on ``partition.broker_owner(bid)``, another
shard for most (sID, broker) pairs. The shuffle regroups every shard's
delivered sIDs by owner shard, source-shard-major and in slot order, so the
result is exactly comparable with the host reference
``shuffle_notify_ref``. Unlike the reference, which falls back to that host
reference when the runtime has fewer devices than shards, the port always
runs the shuffle on the shards' devices, whatever their count: the
reference promises that both of its branches give the same bits, so the
result is the same, and a single card runs the device path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.partition import Rules
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref


def sp_decode_attention(rules: Optional[Rules], q: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        kv_len: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D); k/v (B, KH, S, D); kv_len (B,) int32 -> (B, H, D) in
    q's dtype, on q's device. S must divide into ``rules.model_size``
    slices; without a model axis this is one ``decode_attention`` call."""
    if rules is None or rules.model_axis is None:
        return fd_ops.decode_attention(q, k, v, kv_len, scale)
    n = rules.model_size
    s = k.shape[2]
    if s % n:
        raise ValueError(f"sp_decode_attention: cache length {s} does not "
                         f"split into {n} slices")
    shard = s // n
    home = q.device
    parts = []
    for j, dev in enumerate(rules.model_devices):
        lo = j * shard
        # the slice's live keys: absolute positions [lo, lo + shard)
        local_len = torch.clamp(kv_len.to(dev) - lo, 0, shard)
        acc, m, l = fd_ops.decode_attention_partial(
            q.to(dev).contiguous(), k[:, :, lo:lo + shard].to(dev).contiguous(),
            v[:, :, lo:lo + shard].to(dev).contiguous(),
            local_len.to(torch.int32), scale)
        parts.append((acc.to(home), m.to(home), l.to(home)))
    m_g = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    m_safe = torch.where(torch.isfinite(m_g), m_g, 0.0)
    acc_sum = l_sum = 0.0
    for acc, m, l in parts:
        c = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        acc_sum = acc_sum + acc * c[..., None]
        l_sum = l_sum + l * c
    return fd_ref.normalize(acc_sum, l_sum, q.dtype)


def shuffle_notify_ref(sids: np.ndarray, owners: np.ndarray,
                       num_shards: int) -> np.ndarray:
    """Host reference for ``shuffle_notify``: sids/owners are (S, cap) with
    -1 padding; returns (num_shards, S*cap) where row o holds the sIDs owned
    by shard o in source-shard-major order, -1 padded."""
    sids = np.asarray(sids)
    owners = np.asarray(owners)
    s, cap = sids.shape
    out = np.full((num_shards, s * cap), -1, np.int32)
    for o in range(num_shards):
        picked = sids[(owners == o) & (sids >= 0)]
        out[o, :picked.size] = picked
    return out


def shuffle_notify(devices: Sequence, sids: torch.Tensor,
                   owners: torch.Tensor) -> torch.Tensor:
    """Route delivered sIDs to their owner shards. ``sids`` / ``owners`` are
    (S, cap) int32, -1 padded, one row per source shard; shard o lives on
    ``devices[o % len(devices)]``. Returns (S, S*cap) int32 on shard 0's
    device, row o = shard o's inbound sIDs (source-shard-major, slot order,
    -1 padded), bit-identical to ``shuffle_notify_ref``.

    The gathered buffer is copied once to each distinct owner device; each
    owner's row is computed there by the reference's per-shard body: keep
    ``(owner == o) & (sid >= 0)``, positions by a running count, and a
    scatter into ``S*cap + 1`` slots whose last slot takes every dropped
    entry."""
    s, cap = sids.shape
    out_cap = s * cap
    devs = [torch.device(d) for d in devices]
    where = [devs[o % len(devs)] for o in range(s)]
    by_dev: Dict[torch.device, List[int]] = {}
    for o, d in enumerate(where):
        by_dev.setdefault(d, []).append(o)
    blocks = []
    for d, mine_owners in by_dev.items():
        sid_all = sids.to(d, torch.int32).reshape(-1)
        owner_all = owners.to(d, torch.int32).reshape(-1)
        live = sid_all >= 0
        drop = torch.full_like(sid_all, -1)
        out = torch.full((len(mine_owners), out_cap + 1), -1,
                         dtype=torch.int32, device=d)
        for r, o in enumerate(mine_owners):
            mine = (owner_all == o) & live
            pos = torch.cumsum(mine, 0, dtype=torch.int32) - 1
            out[r].scatter_(0, torch.where(mine, pos, out_cap).long(),
                            torch.where(mine, sid_all, drop))
        blocks.append((mine_owners, out[:, :out_cap]))
    if len(blocks) == 1:
        return blocks[0][1]
    home = where[0]
    result = torch.empty((s, out_cap), dtype=torch.int32, device=home)
    for mine_owners, block in blocks:
        result[mine_owners] = block.to(home)
    return result
