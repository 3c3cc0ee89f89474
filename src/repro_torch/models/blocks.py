"""Block registry and the superlayer.

A superlayer applies ``cfg.block_pattern`` in order; the model runs
``cfg.superlayer_repeat`` superlayers in a loop (the reference scans them
over parameters stacked on axis 0). The port builds the ``"dense"`` block;
``moe``, ``mamba``, ``mlstm``, ``slstm`` and ``shared_attn`` raise
``NotImplementedError`` naming ROADMAP Queue 1, item 17.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention
from repro_torch.models.config import ModelConfig, not_ported
from repro_torch.models.kvcache import kv_cache_shapes
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm


def _dense_only(kind: str) -> None:
    if kind in ("moe", "mamba", "mlstm", "slstm", "shared_attn"):
        raise not_ported(f"the {kind!r} block")
    if kind != "dense":
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# per-block init / train / prefill / decode / state shape
# ---------------------------------------------------------------------------


def block_init(kind: str, cfg: ModelConfig,
               generator: Optional[torch.Generator], device) -> Dict[str, Any]:
    _dense_only(kind)
    return {"norm1": torch.ones((cfg.d_model,), device=device),
            "attn": attention.attn_init(cfg, generator, device),
            "norm2": torch.ones((cfg.d_model,), device=device),
            "mlp": mlp_init(cfg.d_model, cfg.d_ff, cfg.param_dtype,
                            generator, device)}


def block_train(p, kind: str, x: torch.Tensor, cfg: ModelConfig, cos, sin
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (x, aux loss)."""
    _dense_only(kind)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attention.attn_apply(p["attn"], h, cfg, cos, sin, causal=True)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h, cfg.compute_dtype)
    return x, torch.zeros((), device=x.device)


def block_prefill(p, kind: str, x: torch.Tensor, cfg: ModelConfig, cos, sin,
                  max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence forward that also fills the serving state: K/V in
    a zeroed (B, KH, max_len, hd) cache in the compute dtype."""
    _dense_only(kind)
    s = x.shape[1]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, kv = attention.attn_prefill(p["attn"], h, cfg, cos, sin)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h, cfg.compute_dtype)
    cache = {}
    for name in ("k", "v"):
        t = kv[name]
        c = torch.zeros(t.shape[:2] + (max_len, t.shape[3]),
                        dtype=cfg.compute_dtype, device=t.device)
        c[:, :, :s] = t
        cache[name] = c
    return x, cache


def block_decode(p, kind: str, x: torch.Tensor, cfg: ModelConfig, cos, sin,
                 state, pos: int, kv_len: torch.Tensor):
    """One-token decode. x (B, D); ``state`` is updated in place."""
    _dense_only(kind)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    out, state = attention.attn_decode(p["attn"], h, cfg, cos, sin, state,
                                       pos, kv_len)
    x = x + out
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h, cfg.compute_dtype), state


def block_state_shapes(kind: str, cfg: ModelConfig, batch: int, max_len: int):
    _dense_only(kind)
    return kv_cache_shapes(batch, cfg.n_kv_heads, max_len,
                           cfg.resolved_head_dim, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# superlayer
# ---------------------------------------------------------------------------


def superlayer_init(cfg: ModelConfig, generator: Optional[torch.Generator],
                    device) -> Dict[str, Any]:
    return {f"b{i}": block_init(kind, cfg, generator, device)
            for i, kind in enumerate(cfg.block_pattern)}


def superlayer_train(layer_p, shared_p, x, cfg: ModelConfig, cos, sin):
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(cfg.block_pattern):
        x, a = block_train(layer_p[f"b{i}"], kind, x, cfg, cos, sin)
        aux = aux + a
    return x, aux


def superlayer_prefill(layer_p, shared_p, x, cfg: ModelConfig, cos, sin,
                       max_len: int):
    states = {}
    for i, kind in enumerate(cfg.block_pattern):
        x, states[f"b{i}"] = block_prefill(layer_p[f"b{i}"], kind, x, cfg,
                                           cos, sin, max_len)
    return x, states


def superlayer_decode(layer_p, shared_p, x, states, cfg: ModelConfig,
                      cos, sin, pos: int, kv_len: torch.Tensor):
    for i, kind in enumerate(cfg.block_pattern):
        x, states[f"b{i}"] = block_decode(layer_p[f"b{i}"], kind, x, cfg,
                                          cos, sin, states[f"b{i}"], pos,
                                          kv_len)
    return x, states


def superlayer_state_shapes(cfg: ModelConfig, batch: int, max_len: int):
    return {f"b{i}": block_state_shapes(kind, cfg, batch, max_len)
            for i, kind in enumerate(cfg.block_pattern)}
