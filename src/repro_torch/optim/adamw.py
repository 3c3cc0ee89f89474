"""AdamW (decoupled weight decay) over a tree of tensors, as the reference's
``optim/adamw.py``.

The reference returns new parameters and state (its train step donates the
old buffers); here ``update`` writes them in place under ``torch.no_grad()``
and returns the same objects, so no second copy of the parameters or of the
moments is alive. The arithmetic is the reference's, in float32 and in its
order; the count is an int32 0-d tensor on the parameters' device, so the
step needs no read by the host. Only leaves with two or more dimensions are
decayed, counted as the reference counts them: it stacks each parameter of
``layers`` over the depth (``tree.stacks``), so a per-layer norm weight,
one dimension here, has two there and is decayed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed.partition import P


class AdamWState(NamedTuple):
    count: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32

    def init(self, params) -> AdamWState:
        first = tree.leaves(params)[0]
        zeros = lambda p: torch.zeros(p.shape, dtype=self.moment_dtype,
                                      device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32,
                                      device=first.device),
                          tree.tree_map(zeros, params),
                          tree.tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        state.count.add_(1)
        cf = state.count.float()
        b1, b2 = self.b1, self.b2
        lr = self.lr(state.count)
        bc1 = 1 - torch.pow(b1, cf)
        bc2 = 1 - torch.pow(b2, cf)
        stacked = {i: st for pos, st in tree.stacks(params) for i in pos}
        for i, (g, m, v, p) in enumerate(zip(
                tree.leaves(grads), tree.leaves(state.m),
                tree.leaves(state.v), tree.leaves(params))):
            gf = g.float()
            m32 = m.float() * b1 + gf * (1 - b1)
            v32 = v.float() * b2 + gf * gf * (1 - b2)
            step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
            if p.dim() + stacked[i] >= 2:
                step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m32)
            v.copy_(v32)
        return params, state

    def state_pspecs(self, param_pspecs) -> AdamWState:
        """The state's specs: the count replicated, each moment as its
        parameter."""
        return AdamWState(P(), param_pspecs, param_pspecs)
