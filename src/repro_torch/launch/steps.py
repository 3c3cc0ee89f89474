"""Step builders: train (with gradient accumulation over microbatches),
prefill and decode. PyTorch runs eagerly, so a step is the ModelApi call
itself, and the train step updates the parameters and optimizer state in
place (the reference donates their buffers to its jitted step)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.models.model import ModelApi
from repro_torch.optim import make_optimizer


def default_optimizer(cfg):
    if cfg.optimizer == "adafactor":
        return make_optimizer("adafactor", b1=cfg.adafactor_beta1)
    return make_optimizer(cfg.optimizer)


def value_and_grad(api: ModelApi, params, batch):
    """(total loss, its gradient as a list in ``tree.leaves(params)``'s
    order). The parameters are read through detached aliases that require
    a gradient, so the caller's tensors are left as they are; a leaf the
    loss does not use (the token table under the ``embed`` frontend) gets
    zeros, as ``jax.grad`` gives it."""
    flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss, _ = api.loss(tree.unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def _fold(x: torch.Tensor, accum: int) -> torch.Tensor:
    """(B, ...) -> (accum, B / accum, ...)."""
    if x.shape[0] % accum:
        raise ValueError(f"a batch of {x.shape[0]} rows does not divide "
                         f"into {accum} microbatches")
    return x.reshape(accum, x.shape[0] // accum, *x.shape[1:])


def build_train_step(api: ModelApi, optimizer=None,
                     accum: Optional[int] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    grad_accum > 1 runs the microbatches in turn (the batch dim folded to
    (A, B/A, ...), microbatch i the rows [i B/A, (i+1) B/A); a batch that A
    does not divide raises ``ValueError``, as the reference's reshape
    refuses it); gradients accumulate in the parameter dtype (bf16 for the
    large-model memory plans), are divided by A, and the loss is the mean
    of the microbatches'.
    ``accum`` overrides cfg.grad_accum. Metrics: ``loss`` (the total, aux
    term included) and ``grad_norm`` (the square root of the sum of float32
    squares), float32 0-d tensors on the device: nothing is read by the
    host."""
    cfg = api.cfg
    optimizer = optimizer or default_optimizer(cfg)
    accum = max(1, accum if accum is not None else cfg.grad_accum)

    def train_step(params, opt_state, batch):
        if accum > 1:
            micro = {k: _fold(v, accum) for k, v in batch.items()}
            gsum = [torch.zeros_like(p) for p in tree.leaves(params)]
            lsum = torch.zeros((), device=gsum[0].device)
            for i in range(accum):
                mb = {k: v[i] for k, v in micro.items()}
                loss, g = value_and_grad(api, params, mb)
                for a, b in zip(gsum, g):
                    a.add_(b.to(a.dtype))
                del g
                lsum = lsum + loss
            grads = [g.div_(accum) for g in gsum]
            loss = lsum / accum
        else:
            loss, grads = value_and_grad(api, params, batch)
        params, opt_state = optimizer.update(tree.unflatten(params, grads),
                                             opt_state, params)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def build_prefill_step(api: ModelApi) -> Callable:
    def prefill_step(params, batch):
        return api.prefill(params, batch)

    return prefill_step


def build_decode_step(api: ModelApi) -> Callable:
    def decode_step(params, caches, pos, batch):
        return api.decode(params, caches, pos, batch)

    return decode_step
