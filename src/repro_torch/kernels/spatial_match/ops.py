"""Public wrapper for the spatial_match kernel.

``spatial_match`` picks the version by the tensor's device: a CPU tensor
runs ``spatial_match_plain`` below, and so does a ``meta`` tensor, the dry
run's device and not a fallback (shapes only; nothing is built, launched or
counted); a CUDA tensor launches ``csrc/spatial_match.cu`` (or raises).
Both compute the TPU kernel's expansion form |t|^2 + |u|^2 - 2 t.u in the
same fixed float32 order, so they agree bit for bit; the euclidean oracle
is ``ref.spatial_match``.
Stacked (C, R, 2) x (C, U, 2) inputs with a (C,) radius (or one radius for
all) take the kernel's batched entry, one launch for every channel, counted
in ``STACKED_LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import runs_plain

# Far sentinel for padded rows/users: coordinates so distant that dist^2
# overflows float32 to +inf, which is never < radius^2.
FAR = 1e30

# launches of the CUDA kernel in this process (never the plain version):
# the (R, U) entry and the stacked (C, R, U) entry; beside each, the largest
# (R, U) and (C, R, U) it launched
LAUNCHES = 0
STACKED_LAUNCHES = 0
SHAPE = None
STACKED_SHAPE = None


def radius2(radius) -> float:
    """radius^2 rounded to float32, as the kernel compares it."""
    return float(np.float32(radius) ** 2)


def spatial_match(tweet_locs: torch.Tensor, user_locs: torch.Tensor,
                  radius) -> torch.Tensor:
    """(R, 2) x (U, 2) float32 -> (R, U) bool hit map, dist^2 < radius^2;
    stacked (C, R, 2) x (C, U, 2) with (C,) radii -> (C, R, U)."""
    if runs_plain(tweet_locs):
        return spatial_match_plain(tweet_locs, user_locs, radius)
    if tweet_locs.dim() == 3:
        return _launch_stacked(tweet_locs, user_locs,
                               stacked_radius2(radius, tweet_locs))
    return _launch(tweet_locs, user_locs, radius2(radius))


def stacked_radius2(radius, like: torch.Tensor) -> torch.Tensor:
    """(C,) float32 radius^2 on ``like``'s device, one per channel (a scalar
    radius serves every channel); squared in float32, as the kernel
    compares it."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=like.device)
    r = r.expand(like.shape[0]).contiguous()
    return r * r


def spatial_dist2_plain(tweet_locs: torch.Tensor,
                        user_locs: torch.Tensor) -> torch.Tensor:
    """The kernel's dist^2 as plain elementwise float32 PyTorch: every
    product and sum rounds on its own (eager PyTorch never fuses them into an
    FMA), in the kernel's order; no matrix product for the cross term.
    (R, 2) x (U, 2) -> (R, U), or stacked (C, R, 2) x (C, U, 2) -> (C, R, U)."""
    t0, t1 = tweet_locs[..., 0:1], tweet_locs[..., 1:2]               # (.., R, 1)
    u0, u1 = user_locs[..., None, :, 0], user_locs[..., None, :, 1]   # (.., 1, U)
    t2 = t0 * t0 + t1 * t1
    u2 = u0 * u0 + u1 * u1
    cross = t0 * u0 + t1 * u1                                          # (.., R, U)
    return (t2 + u2) - 2.0 * cross


def spatial_match_plain(tweet_locs: torch.Tensor, user_locs: torch.Tensor,
                        radius) -> torch.Tensor:
    """``spatial_dist2_plain < radius^2``, in the kernel's float32 order."""
    dist2 = spatial_dist2_plain(tweet_locs, user_locs)
    if tweet_locs.dim() == 3:
        return dist2 < stacked_radius2(radius, tweet_locs)[:, None, None]
    r2 = torch.tensor(radius2(radius), dtype=torch.float32,
                      device=tweet_locs.device)
    return dist2 < r2


def _launch(tweet_locs, user_locs, r2: float) -> torch.Tensor:
    global LAUNCHES, SHAPE
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
    SHAPE = _build.larger(SHAPE, (r, u))
    return out


def _launch_stacked(tweet_locs, user_locs, r2s) -> torch.Tensor:
    global STACKED_LAUNCHES, STACKED_SHAPE
    from repro_torch.kernels import _build
    c, r = tweet_locs.shape[:2]
    u = user_locs.shape[1]
    for name, t, shape in (("tweet_locs", tweet_locs, (c, r, 2)),
                           ("user_locs", user_locs, (c, u, 2)),
                           ("radius^2", r2s, (c,))):
        if (t.device != tweet_locs.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"spatial_match: {name} must be a contiguous "
                             f"float32 {shape} tensor on {tweet_locs.device},"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((c, r, u), dtype=torch.bool, device=tweet_locs.device)
    if c == 0 or r == 0 or u == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(tweet_locs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.spatial_match_stacked_launch(
            tweet_locs.data_ptr(), user_locs.data_ptr(), out.data_ptr(),
            r2s.data_ptr(), c, r, u, ctypes.c_void_p(stream))
    _build.check(code, "spatial_match_stacked")
    STACKED_LAUNCHES += 1
    STACKED_SHAPE = _build.larger(STACKED_SHAPE, (c, r, u))
    return out
