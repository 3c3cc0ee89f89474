"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The same ids and configurations as the reference's registry: the dense
decoder-only LMs, the MoE, SSM, hybrid and VLM decoders, and the
encoder-decoder."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "llama3-405b": "llama3_405b",
    "qwen2-7b": "qwen2_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "dbrx-132b": "dbrx_132b",
    "xlstm-125m": "xlstm_125m",
    "pixtral-12b": "pixtral_12b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.get_config()


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
