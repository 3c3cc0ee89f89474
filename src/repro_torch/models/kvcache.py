"""KV cache containers for serving."""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, without the tensor (the reference's
    ``jax.ShapeDtypeStruct``); a leaf of ``repro_torch.tree``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    tree_leaf = True


def create_kv_cache(batch: int, kv_heads: int, max_len: int, head_dim: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> Dict[str, torch.Tensor]:
    shape = (batch, kv_heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_shapes(batch: int, kv_heads: int, max_len: int, head_dim: int,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, TensorSpec]:
    shape = (batch, kv_heads, max_len, head_dim)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}


def update_kv(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
              v_new: torch.Tensor, pos: int) -> Dict[str, torch.Tensor]:
    """Write one new token's K/V at position ``pos`` (the same for every
    batch row), IN PLACE: k_new / v_new (B, KH, 1, D). The reference's
    ``dynamic_update_slice`` on a donated cache becomes a copy into the
    cache's own storage here; the same dict is returned."""
    pos = int(pos)
    cache["k"][:, :, pos:pos + 1].copy_(k_new)
    cache["v"][:, :, pos:pos + 1].copy_(v_new)
    return cache
