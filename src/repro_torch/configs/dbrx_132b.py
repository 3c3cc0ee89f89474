"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
        vocab_size=100352, head_dim=128, qkv_bias=False, rope_theta=5e5,
        n_experts=16, moe_top_k=4,
        block_pattern=("moe",), superlayer_repeat=40,
        param_dtype=torch.bfloat16, grad_accum=16, optimizer="adafactor",
        sub_quadratic=False, weight_stationary_decode=True,
    ).validate()
