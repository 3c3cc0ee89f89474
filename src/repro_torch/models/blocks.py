"""Block registry and the superlayer.

A superlayer applies ``cfg.block_pattern`` in order; the model runs
``cfg.superlayer_repeat`` superlayers in a loop (the reference scans them
over parameters stacked on axis 0). ``"shared_attn"`` blocks (zamba2) take
the one un-stacked parameter set ``params["shared"]`` at every depth, each
depth keeping its own KV cache, so a superlayer's parameters leave that
index out. Decode updates every state in place, each new state cast to its
cache's dtype (the reference's "carry" loop): the float32 SSM states stay
float32, the conv and KV caches take the compute dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import kv_cache_shapes
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm

ATTENTION_KINDS = ("dense", "shared_attn", "moe")
# the recurrent kinds: (module prefix, parameter key) in ``ssm``
RECURRENT = {"mamba": ("mamba2", "mamba"), "mlstm": ("mlstm", "mlstm"),
             "slstm": ("slstm", "slstm")}


def _ssm_fn(kind: str, what: str):
    return getattr(ssm, f"{RECURRENT[kind][0]}_{what}")


# ---------------------------------------------------------------------------
# per-block init / train / prefill / decode / state shape
# ---------------------------------------------------------------------------


def block_init(kind: str, cfg: ModelConfig,
               generator: Optional[torch.Generator], device) -> Dict[str, Any]:
    ones = torch.ones((cfg.d_model,), device=device)
    if kind in ATTENTION_KINDS:
        p = {"norm1": ones, "attn": attention.attn_init(cfg, generator, device),
             "norm2": ones.clone()}
        if kind == "moe":
            p["moe"] = moe.moe_init(cfg, generator, device)
        else:
            p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, cfg.param_dtype,
                                generator, device)
        return p
    if kind in RECURRENT:
        return {"norm": ones,
                RECURRENT[kind][1]: _ssm_fn(kind, "init")(cfg, generator,
                                                           device)}
    raise ValueError(kind)


def _ffn(p, kind: str, h: torch.Tensor, cfg: ModelConfig):
    """The block's second half on (B, S, D): (out, aux loss)."""
    if kind == "moe":
        return moe.moe_apply(p["moe"], h, cfg)
    return (mlp_apply(p["mlp"], h, cfg.compute_dtype),
            torch.zeros((), device=h.device))


def block_train(p, kind: str, x: torch.Tensor, cfg: ModelConfig, cos, sin
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (x, aux loss)."""
    if kind in ATTENTION_KINDS:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention.attn_apply(p["attn"], h, cfg, cos, sin, causal=True)
        out, aux = _ffn(p, kind, rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
        return x + out, aux
    if kind in RECURRENT:
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        out, _ = _ssm_fn(kind, "apply")(p[RECURRENT[kind][1]], h, cfg)
        return x + out, torch.zeros((), device=x.device)
    raise ValueError(kind)


def block_prefill(p, kind: str, x: torch.Tensor, cfg: ModelConfig, cos, sin,
                  max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence forward that also fills the serving state: K/V in
    a zeroed (B, KH, max_len, hd) cache in the compute dtype, or the
    recurrent block's final state."""
    if kind in ATTENTION_KINDS:
        s = x.shape[1]
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        out, kv = attention.attn_prefill(p["attn"], h, cfg, cos, sin)
        x = x + out
        out, _ = _ffn(p, kind, rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
        cache = {}
        for name in ("k", "v"):
            t = kv[name]
            c = torch.zeros(t.shape[:2] + (max_len, t.shape[3]),
                            dtype=cfg.compute_dtype, device=t.device)
            c[:, :, :s] = t
            cache[name] = c
        return x + out, cache
    if kind in RECURRENT:
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        out, st = _ssm_fn(kind, "apply")(p[RECURRENT[kind][1]], h, cfg)
        return x + out, st
    raise ValueError(kind)


def block_decode(p, kind: str, x: torch.Tensor, cfg: ModelConfig, cos, sin,
                 state, pos: int, kv_len: torch.Tensor):
    """One-token decode. x (B, D); ``state`` is updated in place."""
    if kind in ATTENTION_KINDS:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        out, state = attention.attn_decode(p["attn"], h, cfg, cos, sin, state,
                                           pos, kv_len)
        x = x + out
        out, _ = _ffn(p, kind, rms_norm(x, p["norm2"], cfg.norm_eps)[:, None],
                      cfg)
        return x + out[:, 0], state
    if kind in RECURRENT:
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        out, new = _ssm_fn(kind, "decode")(p[RECURRENT[kind][1]], h, cfg,
                                           state)
        for name, t in new.items():
            state[name].copy_(t)
        return x + out, state
    raise ValueError(kind)


def block_state_shapes(kind: str, cfg: ModelConfig, batch: int, max_len: int):
    if kind in ATTENTION_KINDS:
        return kv_cache_shapes(batch, cfg.n_kv_heads, max_len,
                               cfg.resolved_head_dim, cfg.compute_dtype)
    if kind in RECURRENT:
        return _ssm_fn(kind, "state_shapes")(cfg, batch)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# superlayer
# ---------------------------------------------------------------------------


def _stacked_kinds(cfg: ModelConfig):
    return [(i, k) for i, k in enumerate(cfg.block_pattern)
            if k != "shared_attn"]


def _params(layer_p, shared_p, i: int, kind: str):
    return shared_p if kind == "shared_attn" else layer_p[f"b{i}"]


def superlayer_init(cfg: ModelConfig, generator: Optional[torch.Generator],
                    device) -> Dict[str, Any]:
    return {f"b{i}": block_init(kind, cfg, generator, device)
            for i, kind in _stacked_kinds(cfg)}


def superlayer_train(layer_p, shared_p, x, cfg: ModelConfig, cos, sin):
    aux = torch.zeros((), device=x.device)
    for i, kind in enumerate(cfg.block_pattern):
        x, a = block_train(_params(layer_p, shared_p, i, kind), kind, x, cfg,
                           cos, sin)
        aux = aux + a
    return x, aux


def superlayer_prefill(layer_p, shared_p, x, cfg: ModelConfig, cos, sin,
                       max_len: int):
    states = {}
    for i, kind in enumerate(cfg.block_pattern):
        x, states[f"b{i}"] = block_prefill(_params(layer_p, shared_p, i, kind),
                                           kind, x, cfg, cos, sin, max_len)
    return x, states


def superlayer_decode(layer_p, shared_p, x, states, cfg: ModelConfig,
                      cos, sin, pos: int, kv_len: torch.Tensor):
    for i, kind in enumerate(cfg.block_pattern):
        x, states[f"b{i}"] = block_decode(_params(layer_p, shared_p, i, kind),
                                          kind, x, cfg, cos, sin,
                                          states[f"b{i}"], pos, kv_len)
    return x, states


def superlayer_state_shapes(cfg: ModelConfig, batch: int, max_len: int):
    return {f"b{i}": block_state_shapes(kind, cfg, batch, max_len)
            for i, kind in enumerate(cfg.block_pattern)}
