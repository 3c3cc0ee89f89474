"""Parameter, batch and cache partition-spec trees (TP over ``model``, FSDP
over ``data``), as the reference's ``distributed/param_specs.py``.

Every 2-D weight is sharded on both mesh axes: the "parallel" dim (heads /
ffn hidden / vocab / experts) over ``model`` (Megatron TP) and the other dim
over ``data`` (FSDP). Axes that do not divide are dropped per tensor by
``partition.sanitize_spec``, so these trees hold for every architecture.

The reference stacks each ``layers`` parameter over the depth and prefixes
its spec with the scan's ``None``. The port keeps one tree a layer
(``tree.stacks``), so a layer's leaf takes the stacked spec with that
leading ``None`` dropped: the per-layer spec itself. The serving state is
the same: ``cache_specs`` decides each per-layer cache leaf's spec on the
reference's stacked (depth, ...) shape, as the reference does, then drops
the leading entry.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List

from repro_torch import tree
from repro_torch.distributed.partition import P
from repro_torch.models.config import ModelConfig

# FSDP axis spans all data-parallel replicas (pod x data); ``pod`` is
# dropped by sanitize_spec on the single-pod mesh. TP axis is ``model``.
D, M = ("pod", "data"), "model"
BATCH = ("pod", "data")


def _attn_specs(cfg: ModelConfig) -> Dict[str, P]:
    s = {"wq": P(D, M), "wk": P(D, M), "wv": P(D, M), "wo": P(M, D)}
    if cfg.qkv_bias:
        s.update({"bq": P(M), "bk": P(M), "bv": P(M)})
    return s


def _mlp_specs() -> Dict[str, P]:
    return {"gate": P(D, M), "up": P(D, M), "down": P(M, D)}


def _block_specs(kind: str, cfg: ModelConfig) -> Dict[str, Any]:
    if kind in ("dense", "shared_attn"):
        return {"norm1": P(None), "attn": _attn_specs(cfg),
                "norm2": P(None), "mlp": _mlp_specs()}
    if kind == "moe":
        return {"norm1": P(None), "attn": _attn_specs(cfg), "norm2": P(None),
                "moe": {"router": P(None, None),
                        "gate": P(M, D, None), "up": P(M, D, None),
                        "down": P(M, None, D)}}
    if kind == "mamba":
        return {"norm": P(None),
                "mamba": {"in_proj": P(D, M), "conv_w": P(None, M),
                          "conv_b": P(M), "a_log": P(None), "dt_bias": P(None),
                          "d_skip": P(None), "out_proj": P(M, D),
                          "norm_w": P(None)}}
    if kind == "mlstm":
        return {"norm": P(None),
                "mlstm": {"up": P(D, M), "wqkv": P(D, M), "wgates": P(D, None),
                          "gate_b": P(None), "down": P(M, D),
                          "norm_w": P(None)}}
    if kind == "slstm":
        return {"norm": P(None),
                "slstm": {"wx": P(D, M), "r": P(None, None, None),
                          "b": P(None), "out": P(None, D), "norm_w": P(None)}}
    raise ValueError(kind)


def _layers(layer, depth: int) -> List[Any]:
    """One copy of a layer's tree a layer."""
    return [copy.deepcopy(layer) for _ in range(depth)]


def lm_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    layer = {f"b{i}": _block_specs(kind, cfg)
             for i, kind in enumerate(cfg.block_pattern)
             if kind != "shared_attn"}
    specs: Dict[str, Any] = {
        "embed": P(M, D),
        "layers": _layers(layer, cfg.superlayer_repeat),
        "final_norm": P(None),
    }
    if "shared_attn" in cfg.block_pattern:
        specs["shared"] = _block_specs("shared_attn", cfg)
    if not cfg.tie_embeddings:
        specs["head"] = P(D, M)
    return specs


def encdec_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    enc = {"norm1": P(None), "attn": _attn_specs(cfg),
           "norm2": P(None), "mlp": _mlp_specs()}
    dec = {"norm1": P(None), "self_attn": _attn_specs(cfg),
           "norm_c": P(None), "cross_attn": _attn_specs(cfg),
           "norm2": P(None), "mlp": _mlp_specs()}
    return {
        "embed": P(M, D),
        "enc_layers": _layers(enc, cfg.n_enc_layers),
        "dec_layers": _layers(dec, cfg.superlayer_repeat),
        "enc_norm": P(None),
        "final_norm": P(None),
        "head": P(D, M),
    }


def batch_specs(batch: Dict[str, Any]) -> Dict[str, P]:
    """Each input's leading (batch) dim over the batch axes."""
    return {k: P(*((BATCH,) + (None,) * (len(v.shape) - 1)))
            for k, v in batch.items()}


def _stacked_cache_spec(shape) -> P:
    """The reference's spec of a stacked (depth, B, ...) serving-state
    leaf: a (R, B, KH, S, hd) KV cache (S > KH) has its sequence over
    ``model``, a (R, B, H, dk, dv) state its heads."""
    if len(shape) == 5 and shape[3] > shape[2]:
        return P(None, BATCH, None, M, None)
    if len(shape) == 5:
        return P(None, BATCH, M, None, None)
    if len(shape) == 4:
        return P(None, BATCH, M, None)
    if len(shape) == 3:
        return P(None, BATCH, None)
    return P(*((None,) * len(shape)))


def cache_specs(layer_shapes: List[Any]) -> List[Any]:
    """Per-layer serving-state specs shaped like ``layer_shapes``
    (``ModelApi.layer_cache_shapes``: one ``TensorSpec`` tree a layer):
    each leaf's spec is decided on the reference's stacked (depth, ...)
    shape, then its leading entry is dropped."""
    depth = len(layer_shapes)
    return tree.tree_map(
        lambda s: P(*_stacked_cache_spec((depth,) + tuple(s.shape))[1:]),
        layer_shapes)
