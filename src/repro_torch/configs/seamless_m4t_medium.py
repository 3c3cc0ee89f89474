"""seamless-m4t-medium [audio] — enc-dec 12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206. [arXiv:2308.11596; hf]

Backbone only: the speech frontend is a stub — ``input_specs()`` supplies
precomputed frame embeddings for the encoder; the decoder is a standard
causal transformer with cross-attention. Decoder target length = frames/4.
"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab_size=256206, head_dim=64, qkv_bias=False, rope_theta=1e4,
        block_pattern=("dense",), superlayer_repeat=12,   # decoder layers
        is_encdec=True, n_enc_layers=12, frontend="embed",
        max_target_len=1024,
        param_dtype=torch.bfloat16, grad_accum=16, optimizer="adamw",
        sub_quadratic=False,
    ).validate()
