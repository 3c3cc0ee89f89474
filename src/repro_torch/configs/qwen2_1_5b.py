"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
GQA with QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
        vocab_size=151936, head_dim=128, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True,
        block_pattern=("dense",), superlayer_repeat=28,
        param_dtype=torch.bfloat16, grad_accum=16, optimizer="adamw",
        sub_quadratic=False,
    ).validate()
