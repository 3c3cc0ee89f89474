"""Error-feedback int8 gradient compression for the cross-pod reduction,
as the reference's ``distributed/compression.py``.

Pod-to-pod links are the scarcest bandwidth at 1000+-node scale; the
gradient all-reduce on a chosen mesh axis moves int8 with a per-tensor
scale and keeps the quantization residual as error feedback (Seide et al.
2014 / 1-bit Adam lineage: the residual is added back before the next
quantization, so the *accumulated* gradient signal is unbiased). 4x less
traffic than a bf16 all-reduce, 8x less than float32.

The reference's ``compressed_psum_tree`` is a ``shard_map`` collective. The
port drives the axis's positions from one process (ROADMAP conventions):
each position's device quantizes its copy of the leaf, the int8 blocks and
scales are copied to the leaf's device and summed there (int32 and float32,
in position order), and the mean goes back to the caller. A device may fill
several positions, so one card runs the whole reduction; it quantizes once
for all the positions it fills, as they hold the same leaf and residual.

The arithmetic follows the reference's two compiled forms bit for bit:

- ``quantize_int8`` / ``ef_compress`` are the reference's eager functions:
  ``scale = max|x| / 127`` (a float32 division), ``q = clip(round_half_even
  (x / scale), -127, 127)``, residual ``target - q * scale``.
- ``compressed_psum_tree`` follows the XLA program the reference compiles
  for its ``shard_map`` body, which rewrites each division by a constant as
  a product: ``scale = max|x| * float32(1/127)`` (a different float32 in
  about 4% of tensors), the same ``x / scale`` for ``q``, the residual
  ``target - q * scale`` as one fused multiply-add (one rounding), and
  ``out = (float(sum q) * (sum scale * (1/n))) * (1/n)``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree

_INV_127 = 1.0 / 127.0          # a Python float: rounded to float32 on use


def _quantize(x: torch.Tensor, scale: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 0-d scale) with ``x ~= q * scale``."""
    return _quantize(x, torch.amax(torch.abs(x)) / 127.0)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(x: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback quantization: returns (q, scale, new_residual)."""
    target = x + residual
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def _ef_compress_compiled(x: torch.Tensor, residual: torch.Tensor):
    """``ef_compress`` as the reference's compiled collective computes it:
    the scale a product with float32(1/127)."""
    target = x + residual
    one_127 = torch.tensor(_INV_127, dtype=torch.float32, device=x.device)
    q, scale = _quantize(target, torch.amax(torch.abs(target)) * one_127)
    # XLA fuses the residual's product and difference into one FMA: one
    # rounding, which float64 gives (q * scale and the difference are
    # exact there)
    res = target.double() - q.double() * scale.double()
    return q, scale, res.to(torch.float32)


def compressed_psum_tree(tree_: Any, residuals: Any, mesh, axis: str
                         ) -> Tuple[Any, Any]:
    """Mean-reduce a tree over ``axis`` of ``mesh`` with int8 EF
    compression. Every leaf is replicated over the axis: each position
    quantizes it with its residual on its own device, and the sums of the
    int8 blocks and of the scales are formed on the leaf's device. Returns
    (reduced tree in the leaves' dtypes, new float32 residuals), on the
    leaves' devices."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32)

    def reduce_leaf(x: torch.Tensor, r: torch.Tensor):
        home = x.device
        qsum = ssum = new_r = None
        blocks = {}                     # device -> its (q, scale) at home
        for dev in devices:
            # every position quantizes the same leaf and residual, so a
            # device that fills several positions quantizes once
            if dev not in blocks:
                q, scale, res = _ef_compress_compiled(
                    x.to(dev).to(torch.float32), r.to(dev))
                blocks[dev] = q.to(home).to(torch.int32), scale.to(home)
                if new_r is None:       # every position's is the same
                    new_r = res.to(home)
                del q, scale, res
            q, scale = blocks[dev]
            qsum = q if qsum is None else qsum + q
            ssum = scale if ssum is None else ssum + scale
        k = inv_n.to(home)
        out = (qsum.to(torch.float32) * (ssum * k)) * k
        return out.to(x.dtype), new_r

    pairs = [reduce_leaf(x, r) for x, r in zip(
        tree.leaves(tree_), tree.leaves(residuals), strict=True)]
    return (tree.unflatten(tree_, [p[0] for p in pairs]),
            tree.unflatten(tree_, [p[1] for p in pairs]))


def init_residuals(tree_: Any) -> Any:
    """Float32 zeros shaped like each leaf, on its device."""
    return tree.tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                               device=x.device), tree_)
