"""Public wrappers for the flash_decode kernel: ``models/attention.py
attn_decode`` calls ``decode_attention``.

Both entries pick the version by the tensor's device: a CPU tensor runs the
plain version in ``ref.py``, a CUDA tensor launches ``csrc/flash_decode.cu``
(or raises). On the card each call is one clustered kernel that splits the
cache over a cluster's blocks and merges the splits in distributed shared
memory (QK^T on the tensor cores in bf16, on the CUDA cores in float32):
``decode_attention_partial`` returns the reference's unnormalised
``(acc, m, l)`` over the whole cache, ``decode_attention`` the normalised
output in q's dtype, written by the same kernel. The wrapper allocates only
the outputs and never reads ``kv_len`` on the host, so a call can be
captured in a CUDA graph. ``cluster_size`` picks the blocks a cluster from
the card's SM count, and ``plan`` returns the size a call on a device takes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_decode import ref

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32              # keys per tile; a block's share is whole tiles
CLUSTERS = (1, 2, 4, 8, 16)   # blocks a cluster; 16 only where the card takes it
MAX_GROUP = 32         # query heads per KV head
ALIGN = 16             # bytes: the bulk copies' rule for k and v
PER_SM = 2             # blocks an SM the cluster size aims at
MIN_TILES = 2          # tiles a block at least, where the cache has them

# launches of either entry on the card in this process (never the plain
# version) and the largest (B, H, KH, S, D) launched
LAUNCHES = 0
SHAPE = None

_SMS: Dict[int, int] = {}
_FITS: Dict[Tuple, int] = {}


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len: torch.Tensor,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Same contract as ``ref.decode_attention_partial``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention_partial(q, k, v, kv_len, scale)
    return _launch(q, k, v, kv_len, float(scale), normalized=False)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Normalised decode attention, (B, H, D) in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, kv_len, scale)
    return _launch(q, k, v, kv_len, float(scale), normalized=True)


def cluster_size(batch: int, kv_heads: int, s_len: int, sms: int,
                 most: int = 16) -> int:
    """Blocks a cluster (one cluster per (b, KV head)): the largest size in
    ``CLUSTERS`` up to ``most`` that keeps B * KH * size within ``PER_SM``
    blocks an SM and gives each block at least ``MIN_TILES`` of the cache's
    tiles (at least 1). Two blocks an SM even out the SMs that a cluster
    shares; two tiles a block keep a short cache's merge small."""
    tiles = -(-s_len // TILE)
    n = 1
    while (2 * n <= most and batch * kv_heads * 2 * n <= PER_SM * sms
           and MIN_TILES * 2 * n <= tiles):
        n *= 2
    return n


def check_inputs(q, k, v, kv_len) -> tuple:
    """Raise ValueError unless the kernel takes (q, k, v, kv_len); return
    (B, H, KH, S, D). It takes float32 or bfloat16 q, k, v of one dtype,
    D in ``HEAD_DIMS``, 1 <= H / KH <= 32, an int32 (B,) kv_len, contiguous
    tensors on one device, and k and v starting on a 16-byte boundary (the
    bulk copies need it; q keeps the same rule)."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"flash_decode: q must be 3-d and k 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if (q.dtype not in DTYPES or d not in HEAD_DIMS or kh == 0 or h % kh
            or h // kh > MAX_GROUP):
        raise ValueError(f"flash_decode: q must be float32 or bfloat16 with "
                         f"D in {HEAD_DIMS} and 1 <= H / KH <= {MAX_GROUP}, "
                         f"got {q.dtype} {tuple(q.shape)}, KH={kh}")
    for name, t, dtype, shape in (
            ("q", q, q.dtype, (b, h, d)), ("k", k, q.dtype, (b, kh, s, d)),
            ("v", v, q.dtype, (b, kh, s, d)),
            ("kv_len", kv_len, torch.int32, (b,))):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"flash_decode: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if name != "kv_len" and t.data_ptr() % ALIGN:
            raise ValueError(f"flash_decode: {name} must start on a "
                             f"{ALIGN}-byte boundary, got address "
                             f"{t.data_ptr():#x}")
    return b, h, kh, s, d


def _fits(lib, dev: torch.device, dtype: int, d: int, g: int,
          n_split: int) -> int:
    """Clusters of ``n_split`` blocks that fit on ``dev`` at once (0 where
    the size is refused); asked once per device and configuration."""
    key = (dev.index, dtype, d, g, n_split)
    if key not in _FITS:
        from repro_torch.kernels import _build
        count = ctypes.c_int(0)
        with torch.cuda.device(dev):
            code = lib.flash_decode_clusters(d, dtype, g, n_split,
                                             ctypes.byref(count))
        if n_split <= 8:            # portable sizes must be taken
            _build.check(code, "flash_decode_clusters")
        _FITS[key] = count.value
    return _FITS[key]


def plan(lib, dev: torch.device, b: int, h: int, kh: int, s: int, d: int,
         dtype: torch.dtype) -> int:
    """The cluster size for this call on ``dev``: ``cluster_size`` from the
    device's SM count, 16 only if the card takes it; raises if the chosen
    cluster does not fit at its shared memory."""
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    code, g = DTYPES[dtype], h // kh
    most = 16 if _fits(lib, dev, code, d, g, 16) > 0 else 8
    n = cluster_size(b, kh, s, _SMS[dev.index], most)
    if _fits(lib, dev, code, d, g, n) < 1:
        raise RuntimeError(f"flash_decode: a cluster of {n} blocks of {g} "
                           f"warps does not fit on {dev}")
    return n


def _launch(q, k, v, kv_len, scale: float, normalized: bool,
            out: Optional[torch.Tensor] = None):
    """One launch; ``out`` (the card-only tests pass a view whose
    neighbours hold a sentinel) is the normalised output or the partial
    ``acc``, a new tensor unless given."""
    global LAUNCHES, SHAPE
    from repro_torch.kernels import _build
    b, h, kh, s, d = check_inputs(q, k, v, kv_len)
    dev = q.device
    want = q.dtype if normalized else torch.float32
    if out is None:
        out = torch.empty((b, h, d), dtype=want, device=dev)
    elif (out.device != dev or out.dtype != want or out.shape != q.shape
          or not out.is_contiguous()):
        raise ValueError(f"flash_decode: out must be a contiguous {want} "
                         f"{tuple(q.shape)} tensor on {dev}")
    m = l = None
    if not normalized:
        m, l = (torch.empty((b, h), dtype=torch.float32, device=dev)
                for _ in range(2))
    if b == 0 or h == 0 or s == 0:       # no key anywhere: the empty partial
        out.zero_()
        if not normalized:
            m.fill_(float("-inf"))
            l.zero_()
    else:
        lib = _build.library()
        n_split = plan(lib, dev, b, h, kh, s, d, q.dtype)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.flash_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                out.data_ptr(), 0 if m is None else m.data_ptr(),
                0 if l is None else l.data_ptr(), b, h, kh, s, d,
                DTYPES[q.dtype], scale, n_split, int(normalized),
                ctypes.c_void_p(stream))
        _build.check(code, "flash_decode")
        LAUNCHES += 1
        SHAPE = _build.larger(SHAPE, (b, h, kh, s, d))
    return out if normalized else (out, m, l)
