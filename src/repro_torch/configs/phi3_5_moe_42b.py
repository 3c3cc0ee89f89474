"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]

16 experts == the 16-way `model` axis: one expert per chip (EP).
"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
        vocab_size=32064, head_dim=128, qkv_bias=False, rope_theta=1e4,
        n_experts=16, moe_top_k=2,
        block_pattern=("moe",), superlayer_repeat=32,
        param_dtype=torch.bfloat16, grad_accum=16, optimizer="adafactor",
        sub_quadratic=False, weight_stationary_decode=True,
    ).validate()
