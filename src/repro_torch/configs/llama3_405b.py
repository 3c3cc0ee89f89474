"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
        vocab_size=128256, head_dim=128, qkv_bias=False, rope_theta=5e5,
        block_pattern=("dense",), superlayer_repeat=126,
        param_dtype=torch.bfloat16, grad_accum=16, optimizer="adafactor",
        adafactor_beta1=0.0,
        remat=True, sub_quadratic=False, seq_shard_activations=True,
    ).validate()
