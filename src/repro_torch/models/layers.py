"""Shared layers: RMSNorm, RoPE, the SwiGLU MLP, the init helper and
``remat``.

The reference's sharding hook ``shard()`` is left out: eager PyTorch in one
process has no compiler to constrain, so the port's
``distributed.partition.shard`` only checks a spec name. Weights keep the
reference's (in, out) layout, so ``x @ W`` reads the same.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def init_dense(shape, dtype: torch.dtype, generator: Optional[torch.Generator],
               device, scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in float32 from ``generator``, cast to
    ``dtype``; the scale defaults to fan_in ** -0.5."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def rope_frequencies(head_dim: int, max_pos: int, theta: float,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, each (max_pos, head_dim / 2) float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    pos = torch.arange(max_pos, dtype=torch.float32, device=device)
    ang = torch.outer(pos, inv)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., S, D); cos/sin (Smax, D/2); positions (..., S) optional.

    Rotates the two halves of the head dimension (not interleaved pairs), in
    float32, and casts back to ``x``'s dtype."""
    if positions is not None:
        cos, sin = cos[positions], sin[positions]
    else:
        cos, sin = cos[: x.shape[-2]], sin[: x.shape[-2]]
    while cos.dim() < x.dim():
        cos, sin = cos[None], sin[None]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_init(d_model: int, d_ff: int, dtype: torch.dtype,
             generator: Optional[torch.Generator], device) -> dict:
    return {name: init_dense(shape, dtype, generator, device)
            for name, shape in (("gate", (d_model, d_ff)),
                                ("up", (d_model, d_ff)),
                                ("down", (d_ff, d_model)))}


def mlp_apply(p: dict, x: torch.Tensor, compute_dtype: torch.dtype
              ) -> torch.Tensor:
    """silu(x @ gate) * (x @ up) @ down in ``compute_dtype``. The two
    (tokens, d_ff) intermediates are combined in place, so at most two of
    them are alive at once."""
    x = x.to(compute_dtype)
    h = F.silu(x @ p["gate"].to(compute_dtype), inplace=True)
    h.mul_(x @ p["up"].to(compute_dtype))
    return h @ p["down"].to(compute_dtype)


def remat(fn: Callable, enabled: bool) -> Callable:
    """``fn`` under activation checkpointing when ``enabled`` and autograd is
    recording (the reference's ``jax.checkpoint`` around each scanned
    layer): only its inputs are kept, and the backward runs it again, kernel
    launches included. Nothing in a layer draws random numbers, so the RNG
    state is not stashed."""
    if not (enabled and torch.is_grad_enabled()):
        return fn

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return run
