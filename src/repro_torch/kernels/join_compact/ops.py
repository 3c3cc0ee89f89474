"""Public wrapper for the join_compact kernel: the ``join_fn`` hook of
``core/plans.py join_param_stream`` under the "compact_pallas" backend.

``join_pairs`` picks the version by the tensor's device: a CPU tensor runs
the plain version in ``ref.py``, a CUDA tensor launches
``csrc/join_compact.cu`` (or raises). The kernel masks the ragged edges
itself and reads ``valid`` as the caller's bool tensor, so nothing is padded
or cast here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.join_compact import ref

# launches of the CUDA kernel in this process (never the plain version),
# and the largest (S, maxT) it launched
LAUNCHES = 0
SHAPE = None


def join_pairs(tgt: torch.Tensor, tgt_n: torch.Tensor, members: torch.Tensor,
               brokers: torch.Tensor, valid: torch.Tensor,
               payload: torch.Tensor, num_brokers: int, aggregated: bool):
    """Same contract as ``ref.join_pairs`` (bit-identical: all-integer)."""
    if tgt.device.type == "cpu":
        return ref.join_pairs(tgt, tgt_n, members, brokers, valid, payload,
                              num_brokers, aggregated)
    return _launch(tgt, tgt_n, members, brokers, valid, payload, num_brokers,
                   aggregated)


def _launch(tgt, tgt_n, members, brokers, valid, payload, num_brokers,
            aggregated):
    global LAUNCHES, SHAPE
    from repro_torch.kernels import _build
    s, max_t = tgt.shape
    for name, t, dtype, shape in (
            ("tgt", tgt, torch.int32, (s, max_t)),
            ("tgt_n", tgt_n, torch.int32, (s,)),
            ("members", members, torch.int32, (s, max_t)),
            ("brokers", brokers, torch.int32, (s, max_t)),
            ("valid", valid, torch.bool, (s,)),
            ("payload", payload, torch.int32, (s,))):
        if (t.device != tgt.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"join_compact: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {tgt.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dev = tgt.device
    pv = torch.empty((s, max_t), dtype=torch.bool, device=dev)
    mem, by, bids = (torch.empty((s, max_t), dtype=torch.int32, device=dev)
                     for _ in range(3))
    if s == 0 or max_t == 0:
        return pv, mem, by, bids
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.join_compact_launch(
            tgt.data_ptr(), tgt_n.data_ptr(), members.data_ptr(),
            brokers.data_ptr(), valid.data_ptr(), payload.data_ptr(),
            pv.data_ptr(), mem.data_ptr(), by.data_ptr(), bids.data_ptr(),
            s, max_t, int(num_brokers), int(bool(aggregated)),
            ctypes.c_void_p(stream))
    _build.check(code, "join_compact")
    LAUNCHES += 1
    SHAPE = _build.larger(SHAPE, (s, max_t))
    return pv, mem, by, bids
