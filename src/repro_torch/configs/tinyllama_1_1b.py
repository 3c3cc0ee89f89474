"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000. llama2-arch small. [arXiv:2401.02385; hf]"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
        vocab_size=32000, head_dim=64, qkv_bias=False, rope_theta=1e4,
        block_pattern=("dense",), superlayer_repeat=22,
        param_dtype=torch.bfloat16, grad_accum=8, optimizer="adamw",
        sub_quadratic=False,
    ).validate()
