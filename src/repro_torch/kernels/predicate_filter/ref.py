"""Plain version of the predicate_filter kernel + the host canonicalization.

The kernel consumes *canonicalized* interval conditions: each channel's fixed
conjunction is rewritten per field as  lo[c,f] <= x <= hi[c,f]  plus at most
one  x != neq[c,f]  (sentinel NEQ_NONE = INT32_MIN means "no exclusion").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.predicates import EQ, GE, GT, LE, LT, NE, CompiledConditions

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1
NEQ_NONE = INT32_MIN


@dataclasses.dataclass(frozen=True)
class IntervalConditions:
    lo: np.ndarray    # (C, F) int32
    hi: np.ndarray    # (C, F) int32
    neq: np.ndarray   # (C, F) int32, NEQ_NONE = unused

    @property
    def num_channels(self) -> int:
        return self.lo.shape[0]


def canonicalize(conds: CompiledConditions, num_fields: int) -> IntervalConditions:
    C = conds.num_channels
    lo = np.full((C, num_fields), INT32_MIN, dtype=np.int64)
    hi = np.full((C, num_fields), INT32_MAX, dtype=np.int64)
    neq = np.full((C, num_fields), NEQ_NONE, dtype=np.int64)
    for c in range(C):
        for p in range(int(conds.npreds[c])):
            f = int(conds.field_idx[c, p])
            op = int(conds.op[c, p])
            v = int(conds.value[c, p])
            if op == EQ:
                lo[c, f] = max(lo[c, f], v)
                hi[c, f] = min(hi[c, f], v)
            elif op == GE:
                lo[c, f] = max(lo[c, f], v)
            elif op == GT:
                lo[c, f] = max(lo[c, f], v + 1)
            elif op == LE:
                hi[c, f] = min(hi[c, f], v)
            elif op == LT:
                hi[c, f] = min(hi[c, f], v - 1)
            elif op == NE:
                if neq[c, f] != NEQ_NONE and neq[c, f] != v:
                    raise ValueError("at most one != predicate per (channel, field)")
                neq[c, f] = v
            else:
                raise ValueError(f"unknown op {op}")
    lo = np.clip(lo, INT32_MIN, INT32_MAX).astype(np.int32)
    hi = np.clip(hi, INT32_MIN, INT32_MAX).astype(np.int32)
    return IntervalConditions(lo, hi, neq.astype(np.int32))


def predicate_filter(fields: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     neq: torch.Tensor) -> torch.Tensor:
    """(N, F) int32 x (C, F) intervals -> (N, C) bool. Plain version."""
    x = fields[:, None, :]                      # (N, 1, F)
    ok = (x >= lo[None]) & (x <= hi[None])      # (N, C, F)
    ok &= (x != neq[None]) | (neq[None] == NEQ_NONE)
    return ok.all(dim=-1)


def predicate_filter_rows(fields: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, neq: torch.Tensor) -> torch.Tensor:
    """(C, N, F) int32 row blocks x (C, F) intervals -> (C, N) bool: block
    c against table row c only. Plain version."""
    lo, hi, neq = lo[:, None, :], hi[:, None, :], neq[:, None, :]
    ok = (fields >= lo) & (fields <= hi)        # (C, N, F)
    ok &= (fields != neq) | (neq == NEQ_NONE)
    return ok.all(dim=-1)
