"""Decoder-only causal LM: the training loss, forward, prefill and cached
decode.

Parameters are a plain tensor tree: ``embed`` (padded vocab, d_model),
``layers`` (a list with one superlayer tree per depth; the reference stacks
them on axis 0 and scans), ``final_norm`` and, untied, ``head``. The
reference's scan over superlayers is a Python loop here, each superlayer
under ``layers.remat`` when ``cfg.remat`` (the reference's
``jax.checkpoint`` around the scan body); its two decode loops
(``decode_loop`` "carry" and "scan") are the same in-place loop, with the
caches updated where they lie. With a ``"shared_attn"`` block in the
pattern, ``shared`` holds that block's one parameter set.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import TensorSpec
from repro_torch.models.layers import (init_dense, remat, rms_norm,
                                       rope_frequencies)

AUX_WEIGHT = 0.01


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> Dict[str, Any]:
    """Parameters drawn from ``generator`` on its device (or ``device``);
    ``generator=None`` with ``device="meta"`` gives shapes only."""
    device = device if device is not None else generator.device
    params = {
        "embed": init_dense((cfg.padded_vocab, cfg.d_model), cfg.param_dtype,
                            generator, device, scale=1.0),
        "layers": [blocks.superlayer_init(cfg, generator, device)
                   for _ in range(cfg.superlayer_repeat)],
        "final_norm": torch.ones((cfg.d_model,), device=device),
    }
    if "shared_attn" in cfg.block_pattern:
        params["shared"] = blocks.block_init("shared_attn", cfg, generator,
                                             device)
    if not cfg.tie_embeddings:
        params["head"] = init_dense((cfg.d_model, cfg.padded_vocab),
                                    cfg.param_dtype, generator, device)
    return params


def _rope(cfg: ModelConfig, max_pos: int, device):
    return rope_frequencies(cfg.resolved_head_dim, max_pos, cfg.rope_theta,
                            device)


def _embed_in(params, cfg: ModelConfig, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(cfg.compute_dtype)
    return params["embed"][tokens].to(cfg.compute_dtype)


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """The (d_model, padded vocab) output projection (a view of ``embed``
    when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def head_out(params, cfg: ModelConfig, x: torch.Tensor,
             cols: Optional[int] = None) -> torch.Tensor:
    """Final norm and head; ``cols`` keeps only the first vocab columns
    (each logit depends on its own column alone)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        x = x * cfg.d_model ** -0.5           # tied head: rescale
    head = head_weight(params, cfg)
    if cols is not None:
        head = head[:, :cols]
    return x @ head.to(cfg.compute_dtype)


def hidden(params, cfg: ModelConfig, tokens=None, embeds=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual stream after the last superlayer, (B, S, d_model), and
    the mean aux loss."""
    x = _embed_in(params, cfg, tokens, embeds)
    cos, sin = _rope(cfg, x.shape[1], x.device)
    aux = torch.zeros((), device=x.device)
    body = remat(blocks.superlayer_train, cfg.remat)
    for layer_p in params["layers"]:
        x, a = body(layer_p, params.get("shared"), x, cfg, cos, sin)
        aux = aux + a
    return x, aux / max(1, cfg.superlayer_repeat)


def forward(params, cfg: ModelConfig, tokens=None, embeds=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, padded vocab), aux ())."""
    x, aux = hidden(params, cfg, tokens, embeds)
    return head_out(params, cfg, x), aux


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Per-position negative log-likelihood, float32: the logits in float32
    with the vocab padding at -1e30, logsumexp minus the label's logit."""
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:     # mask vocab padding
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - tgt


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss over ``batch`` (``tokens`` or ``embeds``,
    ``labels``, optional ``loss_mask``): (loss + AUX_WEIGHT * aux,
    {"loss", "aux", "ntokens"}), all float32 0-d tensors."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"))
    nll = token_nll(logits, batch["labels"], cfg)
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    ntokens = torch.sum(mask)
    loss = torch.sum(nll * mask) / torch.clamp(ntokens, min=1.0)
    total = loss + AUX_WEIGHT * aux
    return total, {"loss": loss, "aux": aux, "ntokens": ntokens}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, tokens=None, embeds=None,
            max_len: Optional[int] = None):
    """Process the prompt; returns (last-token logits (B, vocab), caches,
    pos). ``caches`` holds one state tree per superlayer, each K/V a
    (B, KH, max_len, hd) tensor; ``pos`` is the prompt length."""
    x = _embed_in(params, cfg, tokens, embeds)
    s = x.shape[1]
    max_len = max_len or s
    cos, sin = _rope(cfg, s, x.device)
    caches = []
    for layer_p in params["layers"]:
        x, states = blocks.superlayer_prefill(layer_p, params.get("shared"),
                                              x, cfg, cos, sin, max_len)
        caches.append(states)
    logits = head_out(params, cfg, x[:, -1:, :])[:, 0, :cfg.vocab_size]
    return logits, caches, s


def decode_step(params, cfg: ModelConfig, caches: List, pos: int,
                token=None, embed=None):
    """One decode step at position ``pos`` (the same for every row); the
    caches are updated in place. token (B,) or embed (B, D). Returns
    (logits (B, vocab), caches)."""
    if embed is not None:
        x = embed.to(cfg.compute_dtype)
    else:
        x = params["embed"][token].to(cfg.compute_dtype)
    b = x.shape[0]
    cos, sin = _rope(cfg, _cache_max_len(cfg, caches), x.device)
    kv_len = torch.full((b,), int(pos) + 1, dtype=torch.int32,
                        device=x.device)
    for layer_p, states in zip(params["layers"], caches):
        x, _ = blocks.superlayer_decode(layer_p, params.get("shared"), x,
                                        states, cfg, cos, sin, pos, kv_len)
    logits = head_out(params, cfg, x[:, None, :])[:, 0, :cfg.vocab_size]
    return logits, caches


def _cache_max_len(cfg: ModelConfig, caches: List) -> int:
    """The RoPE table's length in decode: the length of the first attention
    block's (B, KH, S, D) cache, else 2 (a pattern without attention, such
    as xlstm's, has no RoPE)."""
    for i, kind in enumerate(cfg.block_pattern):
        if kind in blocks.ATTENTION_KINDS:
            return caches[0][f"b{i}"]["k"].shape[2]
    return 2


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> List:
    """Zeroed serving state: one state tree per superlayer."""
    shapes = blocks.superlayer_state_shapes(cfg, batch, max_len)
    return [{blk: {name: torch.zeros(spec.shape, dtype=spec.dtype,
                                     device=device)
                   for name, spec in tree.items()}
             for blk, tree in shapes.items()}
            for _ in range(cfg.superlayer_repeat)]


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    """The reference's stacked view of the serving state: each leaf
    (superlayers, B, KH, max_len, hd)."""
    shapes = blocks.superlayer_state_shapes(cfg, batch, max_len)
    return {blk: {name: TensorSpec((cfg.superlayer_repeat,) + spec.shape,
                                   spec.dtype)
                  for name, spec in tree.items()}
            for blk, tree in shapes.items()}
