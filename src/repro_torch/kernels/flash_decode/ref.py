"""Plain PyTorch version of flash_decode: one-token GQA decode attention
over a ``kv_len``-masked cache, as unnormalised partials that merge exactly
across disjoint slices of the cache (log-sum-exp algebra), as in the
reference's ``repro/kernels/flash_decode/ref.py``. Everything is float32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D), k/v (B, KH, S, D), kv_len (B,) -> (B, H, D)."""
    acc, _, l = decode_attention_partial(q, k, v, kv_len, scale)
    return normalize(acc, l, q.dtype)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len: torch.Tensor,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Unnormalised partials: acc (B, H, D) f32 = sum_j e^{s_j - m} v_j,
    m (B, H) f32 the max logit (-inf where no key is live), l (B, H) f32 =
    sum_j e^{s_j - m}. Keys at or past ``kv_len[b]`` take no part."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, kh, g, d)
    logits = torch.einsum("bkgd,bkld->bkgl", qf, k.float()) * scale
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])                      # (B, S)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1)                                      # (B, KH, G)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(mask[:, None, None, :], p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgl,bkld->bkgd", p, v.float())
    m_out = torch.where(torch.isfinite(m), m, float("-inf"))
    return acc.reshape(b, h, d), m_out.reshape(b, h), l.reshape(b, h)


def merge_partials(acc_a, m_a, l_a, acc_b, m_b, l_b):
    """Exact merge of two partials over disjoint slices of the cache."""
    m = torch.maximum(m_a, m_b)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    ca = torch.where(torch.isfinite(m_a), torch.exp(m_a - m_safe), 0.0)
    cb = torch.where(torch.isfinite(m_b), torch.exp(m_b - m_safe), 0.0)
    return (acc_a * ca[..., None] + acc_b * cb[..., None], m,
            l_a * ca + l_b * cb)


def normalize(acc: torch.Tensor, l: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """acc / l, with 0 where no key was live (l == 0), in ``dtype``."""
    return (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(dtype)
