"""Adafactor (Shazeer & Stern 2018): factored second moment and a bf16
first moment, as the reference's ``optim/adafactor.py``.

For an (..., R, C) weight the second moment keeps float32 row and column
factors (R + C numbers in place of R * C); a leaf of one dimension keeps its
full second moment in ``v_row`` and a (1,) placeholder in ``v_col``. The
first moment is bf16, or a (1,) placeholder a leaf when ``b1 == 0`` (the
T5 setting). Updates are clipped to an RMS of ``clip_threshold``;
``beta2 = 1 - count ** -decay`` (0 on the first step). As ``AdamW``, the
update is written in place under ``torch.no_grad()`` in the reference's
float32 arithmetic.

The reference holds each parameter of ``layers`` as one leaf stacked over
the depth, and its factors, RMS clip and weight decay see that stacked
leaf. The port keeps a list with one tree a layer and groups the same
leaves (``tree.stacks``). Of the reference's arithmetic on a stacked leaf
only the RMS clip spans the layers, so ``update`` walks a group twice,
layer by layer and in place: the float32 temporaries are one layer's at a
time, never the whole depth's. The per-layer state is the stacked state
cut along the depth, except for a parameter of one dimension a layer,
(D,): stacked it is (L, D), factored, with a row factor a layer (a 0-d
``v_row`` here) and one column factor for all layers, which each layer's
``v_col`` holds a copy of; such a group, L x D numbers, is updated as a
stacked temporary.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed.partition import P


class AdafactorState(NamedTuple):
    count: torch.Tensor
    m: Any        # bf16 first moments, or (1,) placeholders when b1 == 0
    v_row: Any    # factored second moments (2-d and up), or the full v (1-d)
    v_col: Any


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    moment_dtype: torch.dtype = torch.bfloat16

    def init(self, params) -> AdafactorState:
        flat = tree.leaves(params)
        shapes = [None] * len(flat)         # (v_row, v_col) shape a leaf
        for pos, stacked in tree.stacks(params):
            for i in pos:
                s = tuple(flat[i].shape)
                if len(s) >= 2:
                    shapes[i] = (s[:-1], s[:-2] + s[-1:])
                elif stacked:               # (L, D) in the reference
                    shapes[i] = ((), s)
                else:
                    shapes[i] = (s, (1,))

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=flat[0].device)

        m = [zeros(p.shape if self.b1 > 0 else (1,), self.moment_dtype)
             for p in flat]
        return AdafactorState(
            zeros((), torch.int32), tree.unflatten(params, m),
            tree.unflatten(params, [zeros(r, torch.float32)
                                    for r, _ in shapes]),
            tree.unflatten(params, [zeros(c, torch.float32)
                                    for _, c in shapes]))

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params
               ) -> Tuple[Any, AdafactorState]:
        state.count.add_(1)
        beta2 = 1.0 - state.count.float() ** (-self.decay)
        lr = self.lr(state.count)
        g, m, vr, vc, p = (tree.leaves(t) for t in (
            grads, state.m, state.v_row, state.v_col, params))
        for pos, stacked in tree.stacks(params):
            if not (stacked and p[pos[0]].dim() == 1):
                self._update(
                    [(g[i], m[i], vr[i], vc[i], p[i]) for i in pos], lr,
                    beta2)
                continue
            # (L, D) in the reference: its column factor spans the layers,
            # so the group is updated as that small stack and written back
            stack = [torch.stack([t[i] for i in pos]) for t in (g, m, vr, p)]
            col = vc[pos[0]].clone()
            self._update([(stack[0], stack[1], stack[2], col, stack[3])], lr,
                         beta2)
            for k, i in enumerate(pos):
                for dst, new in zip((m[i], vr[i], p[i]), stack[1:]):
                    dst.copy_(new[k])
                vc[i].copy_(col)
        return params, state

    def state_pspecs(self, param_pspecs) -> AdafactorState:
        """The state's specs, leaf for leaf of ``init``'s tree: the count
        replicated; ``m`` as its parameter (``P(None)`` for the (1,)
        placeholder when ``b1 == 0``); a factor of a leaf of two or more
        dimensions its parameter's spec without the last (row) or the
        second-to-last (column) entry; a 1-d leaf outside ``layers`` keeps
        its full ``v_row`` as the parameter and a replicated placeholder
        column. A 1-d leaf of ``layers`` is (L, D) in the reference, whose
        row factor (L,) is specced ``P(None)`` and column factor (D,)
        ``P(None)``: here its 0-d ``v_row`` takes ``P()`` (the scan entry
        dropped) and its copy of the shared column ``P(None)``."""
        flat = tree.leaves(param_pspecs)
        m, vr, vc = [None] * len(flat), [None] * len(flat), [None] * len(flat)
        for pos, stacked in tree.stacks(param_pspecs):
            for i in pos:
                s = tuple(flat[i])
                m[i] = flat[i] if self.b1 > 0 else P(None)
                if len(s) >= 2:
                    vr[i], vc[i] = P(*s[:-1]), P(*(s[:-2] + s[-1:]))
                elif stacked:
                    vr[i], vc[i] = P(), P(None)
                else:
                    vr[i], vc[i] = flat[i], P(None)
        return AdafactorState(P(), *(tree.unflatten(param_pspecs, x)
                                     for x in (m, vr, vc)))

    def _update(self, leaves, lr, beta2):
        """The reference's update of one stacked leaf, given as its layers
        (g, m, v_row, v_col, p), each written in place. Everything but the
        RMS clip is a layer's own, so a first pass writes each layer's
        second moment and sums its squared steps over the stack, and a
        second recomputes each step from them, clips it and writes the
        moment and the parameter; the float32 temporaries are one layer's
        at a time."""
        squares = torch.zeros((), dtype=torch.float32,
                              device=leaves[0][0].device)
        numel = 0
        for g, _, vr, vc, p in leaves:
            self._second_moment(g, vr, vc, p, beta2)
            step = self._step(g, vr, vc, p)
            squares += torch.sum(step * step)
            numel += step.numel()
        rms = torch.sqrt(squares / numel + self.eps)
        scale = torch.clamp(rms / self.clip_threshold, min=1.0)
        for g, m, vr, vc, p in leaves:
            step = self._step(g, vr, vc, p) / scale
            if self.b1 > 0:
                step = m.float() * self.b1 + step * (1 - self.b1)
                m.copy_(step)
            if p.dim() >= 2 and self.weight_decay:
                step = step + self.weight_decay * p.float()
            p.copy_(p.float() - lr * step)

    def _second_moment(self, g, vr, vc, p, beta2):
        """The float32 row and column factors (or the full v of a 1-d
        leaf), updated in place."""
        gf = g.float()
        g2 = gf * gf + self.eps
        if p.dim() >= 2:
            vr.copy_(vr * beta2 + torch.mean(g2, dim=-1) * (1 - beta2))
            vc.copy_(vc * beta2 + torch.mean(g2, dim=-2) * (1 - beta2))
        else:
            vr.copy_(vr * beta2 + g2 * (1 - beta2))

    def _step(self, g, vr, vc, p):
        """The unclipped float32 step from the updated second moment."""
        eps = self.eps
        if p.dim() >= 2:
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=eps)
            return g.float() * torch.rsqrt(r[..., None] * vc[..., None, :]
                                           + eps)
        return g.float() * torch.rsqrt(vr + eps)
