"""The port's device rule: an explicit device on every constructor.

The default is ``"cuda"``. A caller that wants the CPU says so
(``device="cpu"``); asking for CUDA on a machine without a card raises
instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
