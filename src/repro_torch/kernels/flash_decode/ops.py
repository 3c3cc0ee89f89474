"""Public wrappers for the flash_decode kernel: ``models/attention.py
attn_decode`` calls ``decode_attention``.

``decode_attention_partial`` picks the version by the tensor's device: a CPU
tensor runs the plain version in ``ref.py``, a CUDA tensor launches
``csrc/flash_decode.cu`` (or raises): split-KV partials, then their merge,
two kernels counted as one launch of this entry. Both return the
reference's unnormalised ``(acc, m, l)`` over the whole cache;
``decode_attention`` normalises them with ``ref.normalize``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_decode import ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32          # keys per tile in the kernel; a split is a multiple of it
SMS = 132          # H100 SXM streaming multiprocessors

# launches of this entry on the card in this process (never the plain
# version), and the largest (B, H, KH, S, D) it launched
LAUNCHES = 0
SHAPE = None


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len: torch.Tensor,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Same contract as ``ref.decode_attention_partial``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention_partial(q, k, v, kv_len, scale)
    return _launch(q, k, v, kv_len, float(scale))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Normalised decode attention, (B, H, D) in q's dtype."""
    acc, _, l = decode_attention_partial(q, k, v, kv_len, scale)
    return ref.normalize(acc, l, q.dtype)


def splits(batch: int, kv_heads: int, s_len: int) -> Tuple[int, int]:
    """(keys per split, number of splits): enough blocks of (b, KV head,
    split) to give each of the card's SMs about two, in whole tiles."""
    tiles = -(-s_len // TILE)
    want = max(1, -(-2 * SMS // max(1, batch * kv_heads)))
    split = TILE * -(-tiles // min(tiles, want))
    return split, -(-s_len // split)


def _launch(q, k, v, kv_len, scale: float):
    global LAUNCHES, SHAPE
    from repro_torch.kernels import _build
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"flash_decode: q must be 3-d and k 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if (q.dtype not in DTYPES or d not in HEAD_DIMS or kh == 0 or h % kh
            or h // kh > 32):
        raise ValueError(f"flash_decode: q must be float32 or bfloat16 with "
                         f"D in {HEAD_DIMS} and 1 <= H / KH <= 32, got "
                         f"{q.dtype} {tuple(q.shape)}, KH={kh}")
    for name, t, dtype, shape in (
            ("q", q, q.dtype, (b, h, d)), ("k", k, q.dtype, (b, kh, s, d)),
            ("v", v, q.dtype, (b, kh, s, d)),
            ("kv_len", kv_len, torch.int32, (b,))):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"flash_decode: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dev = q.device
    if b == 0 or h == 0 or s == 0:       # no key anywhere: the empty partial
        return (torch.zeros((b, h, d), dtype=torch.float32, device=dev),
                torch.full((b, h), float("-inf"), device=dev),
                torch.zeros((b, h), dtype=torch.float32, device=dev))
    acc = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    m, l = (torch.empty((b, h), dtype=torch.float32, device=dev)
            for _ in range(2))
    split, n_split = splits(b, kh, s)
    acc_part = torch.empty((b, h, n_split, d), dtype=torch.float32,
                           device=dev)
    m_part, l_part = (torch.empty((b, h, n_split), dtype=torch.float32,
                                  device=dev) for _ in range(2))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            acc_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, kh, s, d,
            DTYPES[q.dtype], scale, split, n_split, ctypes.c_void_p(stream))
    _build.check(code, "flash_decode")
    LAUNCHES += 1
    SHAPE = _build.larger(SHAPE, (b, h, kh, s, d))
    return acc, m, l
