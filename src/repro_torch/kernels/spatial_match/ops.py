"""Public wrapper for the spatial_match kernel.

``spatial_match`` picks the version by the tensor's device: a CPU tensor
runs ``spatial_match_plain`` below, a CUDA tensor launches
``csrc/spatial_match.cu`` (or raises). Both compute the TPU kernel's
expansion form |t|^2 + |u|^2 - 2 t.u in the same fixed float32 order, so
they agree bit for bit; the euclidean oracle is ``ref.spatial_match``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

# Far sentinel for padded rows/users: coordinates so distant that dist^2
# overflows float32 to +inf, which is never < radius^2.
FAR = 1e30

# launches of the CUDA kernel in this process (never the plain version)
LAUNCHES = 0


def radius2(radius) -> float:
    """radius^2 rounded to float32, as the kernel compares it."""
    return float(np.float32(radius) ** 2)


def spatial_match(tweet_locs: torch.Tensor, user_locs: torch.Tensor,
                  radius) -> torch.Tensor:
    """(R, 2) x (U, 2) float32 -> (R, U) bool hit map, dist^2 < radius^2."""
    if tweet_locs.device.type == "cpu":
        return spatial_match_plain(tweet_locs, user_locs, radius)
    return _launch(tweet_locs, user_locs, radius2(radius))


def spatial_match_plain(tweet_locs: torch.Tensor, user_locs: torch.Tensor,
                        radius) -> torch.Tensor:
    """The kernel's arithmetic as plain elementwise float32 PyTorch: every
    product and sum rounds on its own (eager PyTorch never fuses them into an
    FMA), in the kernel's order; no matrix product for the cross term."""
    t0, t1 = tweet_locs[:, 0:1], tweet_locs[:, 1:2]          # (R, 1)
    u0, u1 = user_locs[None, :, 0], user_locs[None, :, 1]   # (1, U)
    t2 = t0 * t0 + t1 * t1
    u2 = u0 * u0 + u1 * u1
    cross = t0 * u0 + t1 * u1                                # (R, U)
    dist2 = (t2 + u2) - 2.0 * cross
    r2 = torch.tensor(radius2(radius), dtype=torch.float32,
                      device=tweet_locs.device)
    return dist2 < r2


def _launch(tweet_locs, user_locs, r2: float) -> torch.Tensor:
    global LAUNCHES
    from repro_torch.kernels import _build
    r, u = tweet_locs.shape[0], user_locs.shape[0]
    for name, t, n in (("tweet_locs", tweet_locs, r),
                       ("user_locs", user_locs, u)):
        if (t.device != tweet_locs.device or t.dtype != torch.float32
                or tuple(t.shape) != (n, 2) or not t.is_contiguous()):
            raise ValueError(f"spatial_match: {name} must be a contiguous "
                             f"float32 ({n}, 2) tensor on {tweet_locs.device},"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((r, u), dtype=torch.bool, device=tweet_locs.device)
    if r == 0 or u == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(tweet_locs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spatial_match_launch(
            tweet_locs.data_ptr(), user_locs.data_ptr(), out.data_ptr(), r, u,
            r2, ctypes.c_void_p(stream))
    _build.check(code, "spatial_match")
    LAUNCHES += 1
    return out
