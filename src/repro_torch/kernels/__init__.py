"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

``<name>/ops.py`` picks by the tensor's device: a CUDA tensor goes to the
CUDA kernel (or raises), a tensor on one of ``PLAIN_DEVICES`` to the plain
version. There is no fallback from one to the other. ``meta`` is there as
the dry run's device (``launch/dryrun.py``): its tensors hold shapes only,
so the plain version computes the output's shape and lets
``FlopCounterMode`` count its products; it never builds a library, launches
or counts a launch.
"""
from __future__ import annotations

import torch

PLAIN_DEVICES = ("cpu", "meta")


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version."""
    return t.device.type in PLAIN_DEVICES
