"""Public wrapper for the join_compact kernel: the ``join_fn`` hook of
``core/plans.py join_param_stream`` under the "compact_pallas" backend.

``join_pairs`` picks the version by the tensor's device: a CPU tensor runs
the plain version in ``ref.py``, and so does a ``meta`` tensor, the dry
run's device and not a fallback (shapes only; nothing is built, launched or
counted); a CUDA tensor launches ``csrc/join_compact.cu`` (or raises). The
kernel masks the ragged edges itself and reads ``valid`` as the caller's
bool tensor, so nothing is padded or cast here. It has two paths in one source: 16-byte quads of 4 columns a
thread where ``vector_ok`` holds, a pair a thread otherwise.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import runs_plain
from repro_torch.kernels.join_compact import ref

# launches of the CUDA kernel in this process (never the plain version),
# of them those on the vector (quad) path, and the largest (S, maxT) launched
LAUNCHES = 0
VECTOR_LAUNCHES = 0
SHAPE = None
ALIGN = 16          # bytes: the quad path's int4 loads and stores
QUAD = 4            # columns a thread on the quad path
THREADS = 256       # threads a block (csrc/join_compact.cu kThreads)
MAX_BLOCKS = 2 ** 31 - 1    # gridDim.x's limit; a grid-stride loop takes more


def join_pairs(tgt: torch.Tensor, tgt_n: torch.Tensor, members: torch.Tensor,
               brokers: torch.Tensor, valid: torch.Tensor,
               payload: torch.Tensor, num_brokers: int, aggregated: bool):
    """Same contract as ``ref.join_pairs`` (bit-identical: all-integer)."""
    if runs_plain(tgt):
        return ref.join_pairs(tgt, tgt_n, members, brokers, valid, payload,
                              num_brokers, aggregated)
    return _launch(tgt, tgt_n, members, brokers, valid, payload, num_brokers,
                   aggregated)


def vector_ok(tensors: Sequence[torch.Tensor], max_t: int) -> bool:
    """Whether the quad path takes a launch: maxT a multiple of 4 and every
    tensor given (the six inputs, and the four outputs where the caller
    gives them) starting on a 16-byte boundary."""
    return max_t % QUAD == 0 and all(t.data_ptr() % ALIGN == 0
                                     for t in tensors)


def grid(s_len: int, max_t: int, vector: bool) -> Tuple[int, int]:
    """(blocks, threads a block) of a launch, as the C entry sizes it: one
    quad (vector path) or one pair a thread."""
    units = s_len * max_t // (QUAD if vector else 1)
    return min(-(-units // THREADS), MAX_BLOCKS), THREADS


def _launch(tgt, tgt_n, members, brokers, valid, payload, num_brokers,
            aggregated, out: Optional[Sequence[torch.Tensor]] = None):
    """One launch into ``out`` (pair_valid, members, pair_bytes, bids), new
    tensors unless given: the card-only tests pass views whose neighbours
    hold a sentinel."""
    global LAUNCHES, VECTOR_LAUNCHES, SHAPE
    from repro_torch.kernels import _build
    s, max_t = tgt.shape
    dev = tgt.device
    checks = [("tgt", tgt, torch.int32, (s, max_t)),
              ("tgt_n", tgt_n, torch.int32, (s,)),
              ("members", members, torch.int32, (s, max_t)),
              ("brokers", brokers, torch.int32, (s, max_t)),
              ("valid", valid, torch.bool, (s,)),
              ("payload", payload, torch.int32, (s,))]
    # new outputs are right by construction and start on a 16-byte
    # boundary (the caching allocator's blocks): only given ones are checked
    if out is None:
        out = [torch.empty((s, max_t), dtype=dtype, device=dev) for dtype in
               (torch.bool, torch.int32, torch.int32, torch.int32)]
    else:
        checks += [(name, t, dtype, (s, max_t)) for name, t, dtype in zip(
            ("out pair_valid", "out members", "out pair_bytes", "out bids"),
            out, (torch.bool, torch.int32, torch.int32, torch.int32))]
    for name, t, dtype, shape in checks:
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"join_compact: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    pv, mem, by, bids = out
    if s == 0 or max_t == 0:
        return tuple(out)
    vector = vector_ok([t for _, t, _, _ in checks], max_t)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.join_compact_launch(
            tgt.data_ptr(), tgt_n.data_ptr(), members.data_ptr(),
            brokers.data_ptr(), valid.data_ptr(), payload.data_ptr(),
            pv.data_ptr(), mem.data_ptr(), by.data_ptr(), bids.data_ptr(),
            s, max_t, int(num_brokers), int(bool(aggregated)), int(vector),
            ctypes.c_void_p(stream))
    _build.check(code, "join_compact")
    LAUNCHES += 1
    VECTOR_LAUNCHES += vector
    SHAPE = _build.larger(SHAPE, (s, max_t))
    return tuple(out)
