"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The same ids as the reference's registry. The port builds the dense
decoder-only LMs; the other families (MoE, SSM, hybrid, enc-dec, the
``embed`` frontend) raise ``NotImplementedError`` naming ROADMAP Queue 1,
item 17.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, not_ported, reduced

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "llama3-405b": "llama3_405b",
    "qwen2-7b": "qwen2_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
}
# registered in the reference, built by a later slice of the port
_LATER = ("phi3.5-moe-42b-a6.6b", "dbrx-132b", "xlstm-125m", "pixtral-12b",
          "zamba2-2.7b", "seamless-m4t-medium")

ARCH_IDS: List[str] = list(_MODULES) + list(_LATER)
PORTED_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _LATER:
        raise not_ported(f"architecture {arch!r} (only the dense LMs "
                         f"{PORTED_IDS} are)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.get_config()


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in PORTED_IDS}
