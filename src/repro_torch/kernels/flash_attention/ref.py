"""Plain PyTorch version of flash_attention: causal or full GQA attention.

The reference's oracle (``repro/kernels/flash_attention/ref.py``) on torch
tensors: KV broadcast to every head, logits from the input dtype with float32
accumulation (computed here as a float32 product of the upcast operands,
which is exact for bf16 inputs), a float32 softmax, the weights rounded to
V's dtype before the PV product (float32 accumulation), the output in q's
dtype. The CUDA kernel keeps the probabilities in float32 instead, so on bf16
inputs the two differ by bf16 rounding (held at 2e-2, as the reference's
kernel test holds its TPU kernel).
"""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, KH, Sk, D), H % KH == 0 -> (B, H, Sq, D).
    Sk is k's own length (the reference's ``l``); the causal mask takes
    Sk = Sq."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kf = torch.repeat_interleave(k, g, dim=1)
    vf = torch.repeat_interleave(v, g, dim=1)
    logits = torch.einsum("bhqd,bhld->bhql", q.float(), kf.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhql,bhld->bhqd", w.to(v.dtype).float(), vf.float())
    return out.to(q.dtype)
