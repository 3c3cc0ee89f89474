"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304. sLSTM + mLSTM
blocks (xLSTM[3:1] interleave: 1 sLSTM per 3 mLSTM). [arXiv:2405.04517;
unverified]. Constant-state recurrence -> runs long_500k."""
import torch

from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab_size=50304, qkv_bias=False,
        block_pattern=("slstm", "mlstm", "mlstm", "mlstm"),
        superlayer_repeat=3,
        ssm_expand=2, ssm_chunk=256,
        param_dtype=torch.float32, grad_accum=8, optimizer="adamw",
        sub_quadratic=True,
    ).validate()
