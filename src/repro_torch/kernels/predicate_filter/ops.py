"""Public wrapper for the predicate_filter kernel.

Handles the cached conditionsList canonicalization and picks the version by
the tensor's device: a CPU tensor runs the plain version in ``ref.py``, a
CUDA tensor launches ``csrc/predicate_filter.cu`` (or raises). The kernel
masks the ragged tail itself, so no padding happens here; it reads the
records with 16-byte loads, so ``_check`` refuses a base off a 16-byte
boundary.
``predicate_filter_rows`` is the stacked (C, N, F) -> (C, N) form of the
fused discovery, with its own entry in the same source and its own launch
count.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.predicates import CompiledConditions
from repro_torch.kernels.predicate_filter import ref

ALIGN = 16          # bytes: the kernel's loads of the records

# launches of the CUDA kernels in this process (never the plain versions):
# the (N, F) -> (N, C) entry and the stacked rows entry; beside each, the
# largest shape it launched, (N, F, C) and (C, N, F)
LAUNCHES = 0
ROWS_LAUNCHES = 0
SHAPE = None
ROWS_SHAPE = None

_CANON_CACHE: Dict[Tuple, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
_TABLE_CACHE: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def _key(conds: CompiledConditions, num_fields: int) -> Tuple:
    return (conds.field_idx.tobytes(), conds.op.tobytes(), conds.value.tobytes(),
            conds.npreds.tobytes(), conds.field_idx.shape, num_fields)


def canonical_arrays(conds: CompiledConditions, num_fields: int):
    """Cached interval canonicalization as host numpy (lo, hi, neq)."""
    key = _key(conds, num_fields)
    if key not in _CANON_CACHE:
        ic = ref.canonicalize(conds, num_fields)
        _CANON_CACHE[key] = (ic.lo, ic.hi, ic.neq)
    return _CANON_CACHE[key]


def _device_tables(conds: CompiledConditions, num_fields: int,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``canonical_arrays`` uploaded once per device (a few KB)."""
    key = (_key(conds, num_fields), str(device))
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = tuple(torch.as_tensor(a, device=device)
                                  for a in canonical_arrays(conds, num_fields))
    return _TABLE_CACHE[key]


def predicate_filter(fields: torch.Tensor,
                     conds: CompiledConditions) -> torch.Tensor:
    """(N, F) int32 records x conditionsList -> (N, C) bool match bitmap."""
    lo, hi, neq = _device_tables(conds, int(fields.shape[1]), fields.device)
    return predicate_filter_padded(fields, lo, hi, neq)


def predicate_filter_padded(fields: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor, neq: torch.Tensor) -> torch.Tensor:
    """Canonical-table form: (N, F) x (C, F) lo/hi/neq -> (N, C) bool."""
    if fields.device.type == "cpu":
        return ref.predicate_filter(fields, lo, hi, neq)
    return _launch(fields, lo, hi, neq)


def predicate_filter_rows(fields: torch.Tensor,
                          conds: CompiledConditions) -> torch.Tensor:
    """(C, N, F) stacked row blocks -> (C, N) bool: channel c's conjunction
    evaluated on its own block only (the fused window / candidate-recheck
    shape, where each channel gathers a different row window)."""
    lo, hi, neq = _device_tables(conds, int(fields.shape[-1]), fields.device)
    if fields.device.type == "cpu":
        return ref.predicate_filter_rows(fields, lo, hi, neq)
    return _launch_rows(fields, lo, hi, neq)


def predicate_filter_ref(fields: torch.Tensor,
                         conds: CompiledConditions) -> torch.Tensor:
    """The oracle: (N, F) x conditionsList -> (N, C) bool through the plain
    version with the wrapper's canonicalization, on ``fields``' device. It
    never launches the kernel, a CUDA tensor included: tests hold the
    kernel against it."""
    lo, hi, neq = _device_tables(conds, int(fields.shape[1]), fields.device)
    return ref.predicate_filter(fields, lo, hi, neq)


def _check(name: str, fields, tables, shapes) -> None:
    """What the kernel takes: contiguous int32 records and tables on one
    device, the records starting on a 16-byte boundary (the kernel reads
    them with 16-byte loads)."""
    for tname, t, shape in zip(("fields", "lo", "hi", "neq"), tables, shapes):
        if (t.device != fields.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: {tname} must be a contiguous int32 "
                             f"{shape} tensor on {fields.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if fields.data_ptr() % ALIGN:
        raise ValueError(f"{name}: fields must start on a {ALIGN}-byte "
                         f"boundary, got address {fields.data_ptr():#x}")


def _launch_rows(fields, lo, hi, neq) -> torch.Tensor:
    global ROWS_LAUNCHES, ROWS_SHAPE
    from repro_torch.kernels import _build
    c, n, f = fields.shape
    _check("predicate_filter_rows", fields, (fields, lo, hi, neq),
           ((c, n, f), (c, f), (c, f), (c, f)))
    out = torch.empty((c, n), dtype=torch.bool, device=fields.device)
    if n == 0 or c == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.predicate_filter_rows_launch(
            fields.data_ptr(), lo.data_ptr(), hi.data_ptr(), neq.data_ptr(),
            out.data_ptr(), c, n, f, ctypes.c_void_p(stream))
    _build.check(code, "predicate_filter_rows")
    ROWS_LAUNCHES += 1
    ROWS_SHAPE = _build.larger(ROWS_SHAPE, (c, n, f))
    return out


def _launch(fields, lo, hi, neq) -> torch.Tensor:
    global LAUNCHES, SHAPE
    from repro_torch.kernels import _build
    n, f = fields.shape
    c = lo.shape[0]
    _check("predicate_filter", fields, (fields, lo, hi, neq),
           ((n, f), (c, f), (c, f), (c, f)))
    out = torch.empty((n, c), dtype=torch.bool, device=fields.device)
    if n == 0 or c == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.predicate_filter_launch(
            fields.data_ptr(), lo.data_ptr(), hi.data_ptr(), neq.data_ptr(),
            out.data_ptr(), n, f, c, ctypes.c_void_p(stream))
    _build.check(code, "predicate_filter")
    LAUNCHES += 1
    SHAPE = _build.larger(SHAPE, (n, f, c))
    return out
