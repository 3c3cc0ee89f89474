"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072. pixtral-ViT + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Backbone only per the task spec: the vision frontend is a stub —
``input_specs()`` supplies precomputed patch embeddings (frontend="embed").
"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab_size=131072, head_dim=128, qkv_bias=False, rope_theta=1e9,
        block_pattern=("dense",), superlayer_repeat=40,
        frontend="embed",
        param_dtype=torch.bfloat16, grad_accum=16, optimizer="adafactor",
        sub_quadratic=False,
    ).validate()
