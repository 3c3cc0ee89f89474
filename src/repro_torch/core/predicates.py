"""Predicate algebra + the per-dataset conditionsList (paper §4.3.1).

A channel's *fixed* predicates form a conjunction over int32 record fields.
All channels registered on a dataset are compiled together, on the host,
into a dense padded ``CompiledConditions`` table so that ingestion-time
evaluation is one vectorized pass (the ``predicate_filter`` kernel consumes
its canonical interval form; ``evaluate_conditions`` below is the plain
PyTorch oracle).

Padding uses an always-true predicate (op=GE, value=INT32_MIN on field 0).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# Comparison ops.
EQ, NE, LT, LE, GT, GE = range(6)
_OP_NAMES = {"==": EQ, "!=": NE, "<": LT, "<=": LE, ">": GT, ">=": GE}

_INT32_MIN = np.int32(-(2 ** 31))


@dataclasses.dataclass(frozen=True)
class Predicate:
    """``field <op> value`` over an int32 column."""

    field: int
    op: int
    value: int

    @staticmethod
    def parse(field: int, op: str, value: int) -> "Predicate":
        return Predicate(field, _OP_NAMES[op], int(value))


@dataclasses.dataclass(frozen=True)
class CompiledConditions:
    """conditionsList for one dataset: (num_channels, max_preds) padded,
    host numpy.

    field_idx, op, value: (C, P) int32; npreds: (C,) int32.
    """

    field_idx: np.ndarray
    op: np.ndarray
    value: np.ndarray
    npreds: np.ndarray

    @property
    def num_channels(self) -> int:
        return self.field_idx.shape[0]

    @property
    def max_preds(self) -> int:
        return self.field_idx.shape[1]


def compile_conditions(channels: Sequence[Sequence[Predicate]],
                       min_preds: int = 1) -> CompiledConditions:
    """Stack per-channel fixed-predicate conjunctions into one padded table."""
    num_c = len(channels)
    max_p = max(min_preds, max((len(c) for c in channels), default=1), 1)
    field_idx = np.zeros((num_c, max_p), dtype=np.int32)
    op = np.full((num_c, max_p), GE, dtype=np.int32)
    value = np.full((num_c, max_p), _INT32_MIN, dtype=np.int32)
    npreds = np.zeros((num_c,), dtype=np.int32)
    for ci, preds in enumerate(channels):
        npreds[ci] = len(preds)
        for pi, p in enumerate(preds):
            field_idx[ci, pi] = p.field
            op[ci, pi] = p.op
            value[ci, pi] = p.value
    return CompiledConditions(field_idx, op, value, npreds)


IntLike = Union[int, np.integer, torch.Tensor]


def apply_op(lhs: torch.Tensor, op: IntLike, rhs: IntLike) -> torch.Tensor:
    """Vectorized comparator dispatch; shapes broadcast together. An
    unknown op compares true (the reference's ``select`` default)."""
    op = torch.as_tensor(op, dtype=torch.int32, device=lhs.device)
    rhs = torch.as_tensor(rhs, dtype=lhs.dtype, device=lhs.device)
    cases = ((EQ, lhs == rhs), (NE, lhs != rhs), (LT, lhs < rhs),
             (LE, lhs <= rhs), (GT, lhs > rhs), (GE, lhs >= rhs))
    out = torch.ones(torch.broadcast_shapes(lhs.shape, op.shape, rhs.shape),
                     dtype=torch.bool, device=lhs.device)
    for code, hit in cases:       # the codes are exclusive: order is moot
        out = torch.where(op == code, hit, out)
    return out


def evaluate_conditions(fields: torch.Tensor,
                        conds: CompiledConditions) -> torch.Tensor:
    """Plain oracle: (N, F) records x conditionsList -> (N, C) bool matches.

    A record matches channel c iff it satisfies *all* of the channel's fixed
    predicates (paper Algorithm 2).
    """
    dev = fields.device
    field_idx = torch.as_tensor(conds.field_idx, device=dev).long()  # (C, P)
    op = torch.as_tensor(conds.op, device=dev)                       # (C, P)
    value = torch.as_tensor(conds.value, device=dev)                 # (C, P)
    vals = fields[:, field_idx]                                      # (N, C, P)
    ok = apply_op(vals, op[None], value[None])                       # (N, C, P)
    return ok.all(dim=-1)                                            # (N, C)


def evaluate_single(fields: torch.Tensor,
                    preds: Sequence[Predicate]) -> torch.Tensor:
    """(N, F) x conjunction -> (N,) bool. Convenience for one channel."""
    conds = compile_conditions([list(preds)])
    return evaluate_conditions(fields, conds)[:, 0]


def selectivity(fields, preds: Sequence[Predicate],
                device: DeviceLike = "cuda") -> float:
    """The share of records matching the conjunction (0.0 for no records):
    a tensor is evaluated where it lies, numpy records on ``device``."""
    if not isinstance(fields, torch.Tensor):
        fields = torch.tensor(np.asarray(fields),
                              device=resolve_device(device))
    n = int(fields.shape[0])
    if n == 0:
        return 0.0
    return int(evaluate_single(fields, preds).sum()) / n
