"""Encoder-decoder transformer (the seamless-m4t backbone), as the
reference's ``models/encdec.py``.

Encoder: bidirectional dense layers over precomputed frame embeddings (the
audio frontend is a stub, as in the reference). Decoder: causal
self-attention, cross-attention over the encoder's output and the SwiGLU
MLP, with self KV caches and each layer's cross K/V computed once at
prefill. Cross-attention applies no RoPE, to q or to k, in prefill and in
decode. In the training forward each encoder and decoder layer runs under
``layers.remat`` when ``cfg.remat``, as the reference's scan bodies run
under ``jax.checkpoint``. Parameters: ``embed``, ``enc_layers`` and ``dec_layers`` (lists
with one tree per layer; the reference stacks them on axis 0 and scans),
``enc_norm``, ``final_norm`` and ``head``. The serving caches are a list
with one dict per decoder layer, ``{k, v, ck, cv}``, each (B, KH, S, hd)
and contiguous; the encoder's length is ``ck.shape[2]``. On the card the
encoder and the cross-attention launch ``flash_attention`` (non-causal,
the cross with its own key length), the decode's self and cross steps
``flash_decode``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import TensorSpec, kv_cache_shapes
from repro_torch.models.layers import (init_dense, mlp_apply, mlp_init,
                                       remat, rms_norm, rope_frequencies)
from repro_torch.models.lm import token_nll


def _norm(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.ones((cfg.d_model,), device=device)


def _enc_layer_init(cfg: ModelConfig, generator, device):
    return {"norm1": _norm(cfg, device),
            "attn": attention.attn_init(cfg, generator, device),
            "norm2": _norm(cfg, device),
            "mlp": mlp_init(cfg.d_model, cfg.d_ff, cfg.param_dtype,
                            generator, device)}


def _dec_layer_init(cfg: ModelConfig, generator, device):
    return {"norm1": _norm(cfg, device),
            "self_attn": attention.attn_init(cfg, generator, device),
            "norm_c": _norm(cfg, device),
            "cross_attn": attention.attn_init(cfg, generator, device),
            "norm2": _norm(cfg, device),
            "mlp": mlp_init(cfg.d_model, cfg.d_ff, cfg.param_dtype,
                            generator, device)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> Dict[str, Any]:
    """Parameters drawn from ``generator`` on its device (or ``device``;
    ``generator=None`` with ``device="meta"`` gives shapes only)."""
    device = device if device is not None else generator.device
    return {
        "embed": init_dense((cfg.padded_vocab, cfg.d_model), cfg.param_dtype,
                            generator, device, scale=1.0),
        "enc_layers": [_enc_layer_init(cfg, generator, device)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_dec_layer_init(cfg, generator, device)
                       for _ in range(cfg.superlayer_repeat)],
        "enc_norm": _norm(cfg, device),
        "final_norm": _norm(cfg, device),
        "head": init_dense((cfg.d_model, cfg.padded_vocab), cfg.param_dtype,
                           generator, device),
    }


def _rope(cfg: ModelConfig, length: int, device):
    return rope_frequencies(cfg.resolved_head_dim, length, cfg.rope_theta,
                            device)


def encode(params, cfg: ModelConfig, embeds: torch.Tensor) -> torch.Tensor:
    """(B, Se, D) frame embeddings -> the encoder's output (B, Se, D)."""
    x = embeds.to(cfg.compute_dtype)
    cos, sin = _rope(cfg, x.shape[1], x.device)
    body = remat(_enc_layer, cfg.remat)
    for p in params["enc_layers"]:
        x = body(p, x, cfg, cos, sin)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_layer(p, x: torch.Tensor, cfg: ModelConfig, cos, sin):
    x = x + attention.attn_apply(
        p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, cos, sin,
        causal=False)
    return x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                         cfg.compute_dtype)


def _cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """Project the encoder's output to this layer's cross K/V, each
    (B, KH, Se, hd) and contiguous."""
    cdtype = cfg.compute_dtype
    b, s, _ = enc_out.shape
    hd, kh = cfg.resolved_head_dim, cfg.n_kv_heads
    k = (enc_out @ p["wk"].to(cdtype)).reshape(b, s, kh, hd)
    v = (enc_out @ p["wv"].to(cdtype)).reshape(b, s, kh, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].to(cdtype).reshape(kh, hd)
        v = v + p["bv"].to(cdtype).reshape(kh, hd)
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def _cross(p, h: torch.Tensor, cfg: ModelConfig, cos, sin, ck, cv):
    return attention.attn_apply(
        p["cross_attn"], rms_norm(h, p["norm_c"], cfg.norm_eps), cfg, cos,
        sin, causal=False, kv_override=(ck, cv))


def _mlp(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return mlp_apply(p["mlp"], rms_norm(h, p["norm2"], cfg.norm_eps),
                     cfg.compute_dtype)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["head"].to(cfg.compute_dtype)


def forward(params, cfg: ModelConfig, src_embeds: torch.Tensor,
            tgt_tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced forward -> logits (B, St, padded vocab)."""
    enc_out = encode(params, cfg, src_embeds)
    x = params["embed"][tgt_tokens].to(cfg.compute_dtype)
    cos, sin = _rope(cfg, x.shape[1], x.device)
    body = remat(_dec_layer, cfg.remat)
    for p in params["dec_layers"]:
        x = body(p, x, cfg, cos, sin, enc_out)
    return _logits(params, cfg, x)


def _dec_layer(p, x: torch.Tensor, cfg: ModelConfig, cos, sin,
               enc_out: torch.Tensor) -> torch.Tensor:
    x = x + attention.attn_apply(
        p["self_attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, cos,
        sin, causal=True)
    x = x + _cross(p, x, cfg, cos, sin, *_cross_kv(p["cross_attn"], enc_out,
                                                   cfg))
    return x + _mlp(p, x, cfg)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Teacher-forced loss over ``batch`` (``embeds`` frames, decoder
    ``tokens``, ``labels``): the mean over every label, (loss, {"loss",
    "aux" (0), "ntokens" (labels.numel())}), float32 0-d tensors."""
    logits = forward(params, cfg, batch["embeds"], batch["tokens"])
    labels = batch["labels"]
    loss = torch.mean(token_nll(logits, labels, cfg))
    return loss, {"loss": loss,
                  "aux": torch.zeros((), device=loss.device),
                  "ntokens": torch.full((), float(labels.numel()),
                                        device=loss.device)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, src_embeds: torch.Tensor,
            tgt_tokens: torch.Tensor, max_len: int):
    """Encode and prefill the decoder. Returns (last-token logits
    (B, vocab), caches, pos): ``caches`` one ``{k, v, ck, cv}`` per decoder
    layer (self K/V zero past the prompt up to ``max_len``), ``pos`` the
    decoder prompt's length."""
    enc_out = encode(params, cfg, src_embeds)
    x = params["embed"][tgt_tokens].to(cfg.compute_dtype)
    s = x.shape[1]
    cos, sin = _rope(cfg, s, x.device)
    caches = []
    for p in params["dec_layers"]:
        a, self_kv = attention.attn_prefill(
            p["self_attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, cos,
            sin)
        x = x + a
        ck, cv = _cross_kv(p["cross_attn"], enc_out, cfg)
        x = x + _cross(p, x, cfg, cos, sin, ck, cv)
        x = x + _mlp(p, x, cfg)
        cache = {}
        for name in ("k", "v"):
            t = self_kv[name]
            c = torch.zeros(t.shape[:2] + (max_len, t.shape[3]),
                            dtype=t.dtype, device=t.device)
            c[:, :, :s] = t
            cache[name] = c
        cache.update(ck=ck, cv=cv)      # cache_shapes' order
        caches.append(cache)
    logits = _logits(params, cfg, x[:, -1:])[:, 0, :cfg.vocab_size]
    return logits, caches, s


def decode_step(params, cfg: ModelConfig, caches: List, pos: int,
                token: torch.Tensor):
    """One decoder step at ``pos`` (the same for every row); the self
    caches are written in place. Returns (logits (B, vocab), caches)."""
    cdtype = cfg.compute_dtype
    x = params["embed"][token].to(cdtype)
    b = x.shape[0]
    cos, sin = _rope(cfg, caches[0]["k"].shape[2], x.device)
    kv_len = torch.full((b,), int(pos) + 1, dtype=torch.int32,
                        device=x.device)
    enc_len = torch.full((b,), caches[0]["ck"].shape[2], dtype=torch.int32,
                         device=x.device)
    for p, cache in zip(params["dec_layers"], caches):
        a, _ = attention.attn_decode(
            p["self_attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, cos,
            sin, cache, pos, kv_len)
        x = x + a
        # cross attention against the fixed encoder memory, no RoPE
        pc = p["cross_attn"]
        q = rms_norm(x, p["norm_c"], cfg.norm_eps) @ pc["wq"].to(cdtype)
        if cfg.qkv_bias:
            q = q + pc["bq"].to(cdtype)
        q = q.reshape(b, cfg.n_heads, cfg.resolved_head_dim)
        c = fd_ops.decode_attention(q, cache["ck"], cache["cv"], enc_len)
        x = x + c.reshape(b, -1) @ pc["wo"].to(cdtype)
        x = x + _mlp(p, x, cfg)
    logits = _logits(params, cfg, x[:, None])[:, 0, :cfg.vocab_size]
    return logits, caches


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int, enc_len: int):
    """The reference's stacked view of the serving state: ``{k, v, ck,
    cv}``, each (decoder layers, B, KH, length, hd)."""
    hd, kh, cd = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.compute_dtype
    self_kv = kv_cache_shapes(batch, kh, max_len, hd, cd)
    cross = kv_cache_shapes(batch, kh, enc_len, hd, cd)
    shapes = {"k": self_kv["k"], "v": self_kv["v"], "ck": cross["k"],
              "cv": cross["v"]}
    return {name: TensorSpec((cfg.superlayer_repeat,) + spec.shape,
                             spec.dtype)
            for name, spec in shapes.items()}
