"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240,
vocab=32000, ssm_state=64. Mamba2 backbone + ONE shared attention block
applied every 6 mamba layers (9 applications, weight-shared).
[arXiv:2411.15242; hf]. Mamba2 state + small shared-attn KV -> runs long_500k.
"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
        vocab_size=32000, head_dim=80, qkv_bias=False, rope_theta=1e4,
        block_pattern=("shared_attn", "mamba", "mamba", "mamba",
                       "mamba", "mamba", "mamba"),
        superlayer_repeat=9,
        ssm_state=64, ssm_expand=2, ssm_chunk=256,
        param_dtype=torch.bfloat16, grad_accum=8, optimizer="adamw",
        sub_quadratic=True,
    ).validate()
