"""ModelConfig: the dataclass that describes a model, with torch dtypes.

The same fields as the reference's ``models/config.py`` (so a config reads
the same in both packages), with ``torch`` dtypes in place of ``jnp`` ones. A
model is ``superlayer_repeat`` superlayers, each applying ``block_pattern``
in order. ``remat`` recomputes each layer's activations in the backward
(``layers.remat``), which changes memory and time, not results. Fields that
steer the reference's mesh and compiler (``seq_shard_activations``,
``weight_stationary_decode``, ``decode_loop``) are kept for parity and do not
change what the port computes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

BLOCK_TYPES = ("dense", "moe", "mamba", "mlstm", "slstm", "shared_attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...]   # blocks per superlayer
    superlayer_repeat: int           # number of superlayers
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # enc-dec
    is_encdec: bool = False
    n_enc_layers: int = 0
    # frontends: "token" (ids -> embed), "embed" (precomputed embeddings)
    frontend: str = "token"
    sub_quadratic: bool = False
    # numerics / memory plan
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    grad_accum: int = 1
    optimizer: str = "adamw"
    adafactor_beta1: float = 0.9
    # attention implementation on a CPU tensor: "ref" (plain), "ref_full"
    # (plain, never chunked) or "flash" (the kernel's wrapper); on a CUDA
    # tensor the port always launches its kernels (models/attention.py)
    attn_impl: str = "ref"
    seq_shard_activations: bool = False
    weight_stationary_decode: bool = False
    # "carry" and "scan" are both one in-place loop over the layers here
    decode_loop: str = "carry"
    max_target_len: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple; decode slices the padding off."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> "ModelConfig":
        assert self.n_heads % self.n_kv_heads == 0
        for b in self.block_pattern:
            assert b in BLOCK_TYPES, b
        if "moe" in self.block_pattern:
            assert self.n_experts > 0 and self.moe_top_k > 0
        return self


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Same-family tiny config for CPU tests: the reference's ``reduced``."""
    small = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        superlayer_repeat=2,
        n_layers=2 * len(cfg.block_pattern),
        head_dim=16,
        n_experts=4 if cfg.n_experts else 0,
        ssm_state=16,
        ssm_chunk=32,
        ssm_expand=2,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        n_enc_layers=2 if cfg.is_encdec else 0,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        grad_accum=1,
        remat=False,
        max_target_len=32,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small).validate()
