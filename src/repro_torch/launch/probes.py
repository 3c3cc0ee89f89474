"""Single-superlayer probe functions for the dry run's cost accounting, as
the reference's ``launch/probes.py``.

The reference compiles (a) the full step, whose XLA cost counts each scan
body once (one superlayer, one microbatch), and (b) these one-superlayer
probes; a step's total is full + (repeats - 1) x probe (x accum
microbatches for training). The port's dry run (``launch/dryrun.py``) runs
the same split on the ``meta`` device: the full step cut to one superlayer
and one microbatch, and these probes, each counted by ``FlopCounterMode``.

A probe takes one layer's parameter tree (one entry of ``params["layers"]``
or of the enc-dec's layer lists: the port keeps a tree a layer where the
reference slices ``[0]`` off its stacked leaves). The training probes
return the gradients ``jax.grad`` returns, through
``torch.autograd.grad`` over detached leaves that require a gradient (as
``launch/steps.value_and_grad`` reads the parameters), under
``layers.remat`` when ``cfg.remat`` (the reference's ``jax.checkpoint``),
so the backward's recompute runs, and is counted, as in the real step. On
a CUDA tensor the attention runs the port's kernels, as in the real step.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import attention, blocks, encdec
from repro_torch.models.layers import mlp_apply, remat, rms_norm
from repro_torch.models.model import ModelApi


def _grad(f: Callable, recompute: bool, *args):
    """The gradient of the scalar ``f(*args)`` w.r.t. each argument (a
    tensor tree each), as trees shaped like the arguments, with ``f`` under
    ``layers.remat`` when ``recompute``; a leaf ``f`` does not use gets
    zeros, as ``jax.grad`` gives it."""
    flat = [[t.detach().requires_grad_() for t in tree.leaves(a)]
            for a in args]
    with torch.enable_grad():
        out = remat(f, recompute)(
            *(tree.unflatten(a, leaves) for a, leaves in zip(args, flat)))
        every = [t for leaves in flat for t in leaves]
        grads = torch.autograd.grad(out, every, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(every, grads)]
    result, i = [], 0
    for a, leaves in zip(args, flat):
        result.append(tree.unflatten(a, grads[i:i + len(leaves)]))
        i += len(leaves)
    return tuple(result)


def train_body_fn(api: ModelApi) -> Callable:
    """grad through one superlayer on one microbatch of activations:
    (layer, shared, x) gradients with a shared block, else (layer, x)."""
    cfg = api.cfg

    def probe(layer_p, shared_p, x, cos, sin):
        def f(lp, sp, xx):
            out, aux = blocks.superlayer_train(lp, sp, xx, cfg, cos, sin)
            return torch.sum(out.float()) + aux

        # the remat recompute runs, and is counted, as in the real step
        if shared_p is not None:
            return _grad(f, cfg.remat, layer_p, shared_p, x)
        return _grad(lambda lp, xx: f(lp, None, xx), cfg.remat, layer_p, x)

    return probe


def encdec_train_bodies(api: ModelApi):
    """(encoder layer, decoder layer) gradient probes: (layer, x) and
    (layer, x, enc_out)."""
    cfg = api.cfg

    def enc_probe(layer_p, x, cos, sin):
        def f(lp, xx):
            return torch.sum(encdec._enc_layer(lp, xx, cfg, cos, sin).float())

        return _grad(f, cfg.remat, layer_p, x)

    def dec_probe(layer_p, x, enc_out, cos, sin):
        def f(lp, xx, eo):
            return torch.sum(encdec._dec_layer(lp, xx, cfg, cos, sin, eo)
                             .float())

        return _grad(f, cfg.remat, layer_p, x, enc_out)

    return enc_probe, dec_probe


def prefill_body_fn(api: ModelApi, max_len: int) -> Callable:
    cfg = api.cfg

    def probe(layer_p, shared_p, x, cos, sin):
        return blocks.superlayer_prefill(layer_p, shared_p, x, cfg, cos, sin,
                                         max_len)

    return probe


def decode_body_fn(api: ModelApi) -> Callable:
    """One superlayer's decode step; ``states`` are updated in place."""
    cfg = api.cfg

    def probe(layer_p, shared_p, x, states, cos, sin, pos, kv_len):
        return blocks.superlayer_decode(layer_p, shared_p, x, states, cfg,
                                        cos, sin, pos, kv_len)

    return probe


def encdec_dec_decode_body(api: ModelApi) -> Callable:
    """One enc-dec decoder layer's decode step (self-cached + cross
    attention), as one layer of ``encdec.decode_step``: the cache's self
    K/V are updated in place, and (output, {"k", "v"}) returned."""
    cfg = api.cfg

    def probe(p, x, cache, pos, kv_len, enc_len, cos, sin):
        cdtype = cfg.compute_dtype
        b = x.shape[0]
        a, new_kv = attention.attn_decode(
            p["self_attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, cos,
            sin, {"k": cache["k"], "v": cache["v"]}, pos, kv_len)
        h = x + a
        pc = p["cross_attn"]
        q = rms_norm(h, p["norm_c"], cfg.norm_eps) @ pc["wq"].to(cdtype)
        if cfg.qkv_bias:
            q = q + pc["bq"].to(cdtype)
        q = q.reshape(b, cfg.n_heads, cfg.resolved_head_dim)
        c = fd_ops.decode_attention(q, cache["ck"], cache["cv"], enc_len)
        h = h + c.reshape(b, -1) @ pc["wo"].to(cdtype)
        m = mlp_apply(p["mlp"], rms_norm(h, p["norm2"], cfg.norm_eps), cdtype)
        return h + m, new_kv

    return probe


def encdec_prefill_bodies(api: ModelApi):
    """(encoder layer forward, decoder layer prefill forward) for the
    enc-dec prefill's scaling."""
    cfg = api.cfg

    def enc_probe(lp, x, cos, sin):
        return encdec._enc_layer(lp, x, cfg, cos, sin)

    def dec_probe(lp, x, enc_out, cos, sin):
        return encdec._dec_layer(lp, x, cfg, cos, sin, enc_out)

    return enc_probe, dec_probe
