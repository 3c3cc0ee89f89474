"""Recurrent / state-space blocks: Mamba2 (SSD), mLSTM, sLSTM, as the
reference's ``models/ssm.py``.

Mamba2 and mLSTM share ``chunked_gla``: chunked gated linear attention with
a scalar decay per head,

  o_t = q_t . S_t,   S_t = sum_{j<=t} exp(L_t - L_j) k_j v_j^T,
  L_t = cumsum(log a),  log a <= 0.

Within a chunk the products are dense and batched over the chunks, as the
reference's; across chunks a loop of elementwise steps carries the
(Dk, Dv) state (the reference combines the chunk summaries with
``lax.associative_scan``: the same sum in another order). A last chunk
shorter than ``chunk`` is taken, padded with zero keys and values and no
decay (the reference asserts T % chunk == 0).

Every decay factor is formed as exp of a difference that is <= 0: the
intra-chunk weights as exp(L_i - L_j) masked to j <= i before the exp, the
chunk summaries as exp(L_last - L_j), the state carried in as exp(L_i), so
no factor exceeds 1. This is the formula above and the reference's one-token
recurrence ``gla_step``. The reference's chunked form multiplies
q exp(L) by k exp(-L) instead: with decays of 0.5-0.7 a token, -L passes 88
after about 128 tokens, exp(-L) overflows float32 and its output is NaN
(at T = 256 with the published chunk of 256). The port stays finite there,
and equals the reference within float32 rounding where the reference is
finite.

- Mamba2/SSD: q=C_t, k=B_t, v=dt*x_t, log a = -softplus(dt)*exp(A_log).
- mLSTM: q/k/v projections, log a = logsigmoid(f), input gate folded into
  v; the normaliser is an appended all-ones value channel.
- sLSTM: strictly sequential (recurrent gate matrices R), exponential
  gating with the stabiliser state m (initially -1e30); the reference's
  ``lax.scan`` over time is a Python loop over T here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import TensorSpec
from repro_torch.models.layers import init_dense, rms_norm


# ---------------------------------------------------------------------------
# chunked gated linear attention
# ---------------------------------------------------------------------------


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_a: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k (B, H, T, Dk), v (B, H, T, Dv), log_a (B, H, T) <= 0, float32.

    Returns (o (B, H, T, Dv), final_state (B, H, Dk, Dv)). The products are
    the reference's four, each batched over every chunk: the intra-chunk
    scores and outputs, the chunk summaries, and the outputs against the
    state entering each chunk (the first chunk's the initial state, zeros
    unless given), so the backward computes the same products too."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    n = -(-t // chunk)
    pad = n * chunk - t
    if pad:         # a ragged last chunk: zero keys and values, no decay
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, pad))
    qc = q.reshape(b, h, n, chunk, dk)
    kc = k.reshape(b, h, n, chunk, dk)
    vc = v.reshape(b, h, n, chunk, dv)
    L = torch.cumsum(log_a.reshape(b, h, n, chunk), dim=-1)   # within-chunk
    last = L[..., -1:]                                        # (B, H, N, 1)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()
    # intra-chunk: A[i, j] = exp(L_i - L_j) (q_i . k_j), j <= i
    diff = (L[..., :, None] - L[..., None, :]).masked_fill(~causal,
                                                           float("-inf"))
    att = torch.einsum("bhnid,bhnjd->bhnij", qc, kc) * torch.exp(diff)
    o = torch.einsum("bhnij,bhnjv->bhniv", att, vc)
    # chunk summaries: S_n = sum_j exp(L_last - L_j) k_j v_j^T
    kw = kc * torch.exp(last - L)[..., None]
    summary = torch.einsum("bhnjd,bhnjv->bhndv", kw, vc)
    # the state after chunk n: exp(L_last) (the state after n - 1) + S_n
    decay = torch.exp(last)[..., None]                        # (B, H, N, 1, 1)
    init = initial_state
    if init is None:
        init = torch.zeros((b, h, dk, dv), dtype=v.dtype, device=v.device)
    run, state = [], init
    for i in range(n):
        state = state * decay[:, :, i] + summary[:, :, i]
        run.append(state)
    run = torch.stack(run, dim=2)
    entering = torch.cat([init[:, :, None], run[:, :, :-1]], dim=2)
    # the state entering each chunk, decayed to each position
    o = o + torch.einsum("bhnid,bhndv->bhniv", qc * torch.exp(L)[..., None],
                         entering)
    return o.reshape(b, h, n * chunk, dv)[:, :, :t], run[:, :, -1]


def gla_step(q, k, v, log_a, state):
    """Single-token recurrence: state (B, H, Dk, Dv); q/k (B, H, Dk);
    v (B, H, Dv); log_a (B, H). Returns (o (B, H, Dv), new state)."""
    a = torch.exp(log_a)[..., None, None]
    state = state * a + k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhd,bhdv->bhv", q, state)
    return o, state


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    head_dim = 64
    n_heads = max(1, d_in // head_dim)
    if d_in % head_dim:
        head_dim = d_in // n_heads
    return d_in, n_heads, head_dim


def mamba2_init(cfg: ModelConfig, generator: Optional[torch.Generator],
                device, dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.param_dtype
    d, ds = cfg.d_model, cfg.ssm_state
    d_in, h, _ = mamba2_dims(cfg)
    conv_ch = d_in + 2 * ds
    f32 = torch.float32
    return {
        "in_proj": init_dense((d, 2 * d_in + 2 * ds + h), dtype, generator,
                              device),
        "conv_w": init_dense((cfg.ssm_conv, conv_ch), dtype, generator,
                             device, scale=0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros((h,), dtype=f32, device=device),
        "dt_bias": torch.zeros((h,), dtype=f32, device=device),
        "d_skip": torch.ones((h,), dtype=f32, device=device),
        "out_proj": init_dense((d_in, d), dtype, generator, device),
        "norm_w": torch.ones((d_in,), dtype=f32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, T, C), w (W, C), b (C,)."""
    width, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i: i + t] * w[i][None, None] for i in range(width))
    return out + b[None, None]


def _mamba2_split(proj: torch.Tensor, cfg: ModelConfig):
    d_in, h, _ = mamba2_dims(cfg)
    ds = cfg.ssm_state
    return torch.split(proj, [d_in, d_in, ds, ds, h], dim=-1)


def mamba2_apply(p, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[Dict[str, torch.Tensor]] = None):
    """x (B, T, D) -> (y (B, T, D), final state {'ssm', 'conv'}).

    The conv state is the last W - 1 rows of the conv's input
    (``conv_in[:, T-(W-1):]``, the reference's) for T >= W - 1. Below that
    the reference's slice is shorter than W - 1 rows and its decode fails on
    the shape; the port pads the rows before position 0 with the zeros that
    the causal conv pads with, so decode goes on as the forward would."""
    cdtype = cfg.compute_dtype
    b, t, _ = x.shape
    ds, width = cfg.ssm_state, cfg.ssm_conv
    d_in, h, hd = mamba2_dims(cfg)
    proj = x.to(cdtype) @ p["in_proj"].to(cdtype)
    z, xc, B, C, dt = _mamba2_split(proj, cfg)
    conv_in = torch.cat([xc, B, C], dim=-1)
    conv = F.silu(_causal_conv(conv_in, p["conv_w"].to(cdtype),
                               p["conv_b"].to(cdtype)))
    xc, B, C = torch.split(conv, [d_in, ds, ds], dim=-1)
    dtf = F.softplus(dt.float() + p["dt_bias"])               # (B, T, H)
    log_a = (-dtf * torch.exp(p["a_log"])).transpose(1, 2)    # (B, H, T)
    xh = xc.reshape(b, t, h, hd).transpose(1, 2)              # (B, H, T, hd)
    v = xh * dtf.transpose(1, 2)[..., None].to(cdtype)
    k = B[:, None].expand(b, h, t, ds)
    q = C[:, None].expand(b, h, t, ds)
    init = state["ssm"] if state is not None else None
    o, s_fin = chunked_gla(q.float(), k.float(), v.float(), log_a,
                           min(cfg.ssm_chunk, t), init)
    y = o + xh.float() * p["d_skip"][None, :, None, None]
    y = y.transpose(1, 2).reshape(b, t, d_in).to(cdtype)
    y = rms_norm(y, p["norm_w"], cfg.norm_eps) * F.silu(z)
    out = y @ p["out_proj"].to(cdtype)
    hist = F.pad(conv_in, (0, 0, max(0, width - 1 - t), 0))
    new_state = {"ssm": s_fin,
                 "conv": hist[:, hist.shape[1] - (width - 1):].to(cdtype)}
    return out, new_state


def mamba2_decode(p, x: torch.Tensor, cfg: ModelConfig,
                  state: Dict[str, torch.Tensor]):
    """x (B, D) one token; state {'ssm' (B, H, ds, hd), 'conv' (B, W-1, C)}.
    Returns (y (B, D), new state)."""
    cdtype = cfg.compute_dtype
    b, _ = x.shape
    ds = cfg.ssm_state
    d_in, h, hd = mamba2_dims(cfg)
    proj = x.to(cdtype) @ p["in_proj"].to(cdtype)
    z, xc, B, C, dt = _mamba2_split(proj, cfg)
    conv_in = torch.cat([xc, B, C], dim=-1)                   # (B, C)
    hist = torch.cat([state["conv"], conv_in[:, None]], dim=1)  # (B, W, C)
    w = p["conv_w"].to(cdtype)
    conv = F.silu(torch.einsum("bwc,wc->bc", hist, w)
                  + p["conv_b"].to(cdtype))
    xc, B, C = torch.split(conv, [d_in, ds, ds], dim=-1)
    dtf = F.softplus(dt.float() + p["dt_bias"])               # (B, H)
    log_a = -dtf * torch.exp(p["a_log"])
    xh = xc.reshape(b, h, hd)
    v = xh.float() * dtf[..., None]
    k = B[:, None].expand(b, h, ds).float()
    q = C[:, None].expand(b, h, ds).float()
    o, s_new = gla_step(q, k, v, log_a, state["ssm"])
    y = o + xh.float() * p["d_skip"][None, :, None]
    y = y.reshape(b, d_in).to(cdtype)
    y = rms_norm(y, p["norm_w"], cfg.norm_eps) * F.silu(z)
    out = y @ p["out_proj"].to(cdtype)
    return out, {"ssm": s_new, "conv": hist[:, 1:]}


def mamba2_state_shapes(cfg: ModelConfig, batch: int):
    d_in, h, hd = mamba2_dims(cfg)
    conv_ch = d_in + 2 * cfg.ssm_state
    return {
        "ssm": TensorSpec((batch, h, cfg.ssm_state, hd), torch.float32),
        "conv": TensorSpec((batch, cfg.ssm_conv - 1, conv_ch),
                           cfg.compute_dtype),
    }


# ---------------------------------------------------------------------------
# mLSTM block (parallel chunked form)
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    return d_in, h, d_in // h


def mlstm_init(cfg: ModelConfig, generator: Optional[torch.Generator],
               device, dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.param_dtype
    d = cfg.d_model
    d_in, h, _ = mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "up": init_dense((d, 2 * d_in), dtype, generator, device),
        "wqkv": init_dense((d_in, 3 * d_in), dtype, generator, device),
        "wgates": init_dense((d_in, 2 * h), dtype, generator, device),
        "gate_b": torch.zeros((2 * h,), dtype=f32, device=device),
        "down": init_dense((d_in, d), dtype, generator, device),
        "norm_w": torch.ones((d_in,), dtype=f32, device=device),
    }


def _mlstm_qkvg(p, xp: torch.Tensor):
    """q, k, v in xp's dtype; the input gate sigmoid(i) and the log forget
    gate logsigmoid(f), float32, (..., H) each."""
    qkv = xp @ p["wqkv"].to(xp.dtype)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    gates = xp.float() @ p["wgates"].float() + p["gate_b"]
    ig, fg = torch.chunk(gates, 2, dim=-1)
    return q, k, v, torch.sigmoid(ig), F.logsigmoid(fg)


def mlstm_apply(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None):
    cdtype = cfg.compute_dtype
    b, t, _ = x.shape
    d_in, h, hd = mlstm_dims(cfg)
    up = x.to(cdtype) @ p["up"].to(cdtype)
    xp, z = torch.chunk(up, 2, dim=-1)
    q, k, v, i_g, logf = _mlstm_qkvg(p, xp)

    def to_h(a):
        return a.reshape(b, t, h, hd).transpose(1, 2).float()

    q, k, v = to_h(q) * hd ** -0.5, to_h(k), to_h(v)
    v = v * i_g.transpose(1, 2)[..., None]                     # input gate
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    init = state["ssm"] if state is not None else None
    o_aug, s_fin = chunked_gla(q, k, v_aug, logf.transpose(1, 2),
                               min(cfg.ssm_chunk, t), init)
    o, denom = o_aug[..., :hd], o_aug[..., hd:]
    o = o / torch.clamp(torch.abs(denom), min=1.0)
    o = o.transpose(1, 2).reshape(b, t, d_in).to(cdtype)
    o = rms_norm(o, p["norm_w"], cfg.norm_eps) * F.silu(z)
    return o @ p["down"].to(cdtype), {"ssm": s_fin}


def mlstm_decode(p, x: torch.Tensor, cfg: ModelConfig,
                 state: Dict[str, torch.Tensor]):
    cdtype = cfg.compute_dtype
    b, _ = x.shape
    d_in, h, hd = mlstm_dims(cfg)
    up = x.to(cdtype) @ p["up"].to(cdtype)
    xp, z = torch.chunk(up, 2, dim=-1)
    q, k, v, i_g, logf = _mlstm_qkvg(p, xp)

    def to_h(a):
        return a.reshape(b, h, hd).float()

    q, k, v = to_h(q) * hd ** -0.5, to_h(k), to_h(v)
    v = v * i_g[..., None]
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    o_aug, s_new = gla_step(q, k, v_aug, logf, state["ssm"])
    o, denom = o_aug[..., :hd], o_aug[..., hd:]
    o = (o / torch.clamp(torch.abs(denom), min=1.0)).reshape(b, d_in)
    o = rms_norm(o.to(cdtype), p["norm_w"], cfg.norm_eps) * F.silu(z)
    return o @ p["down"].to(cdtype), {"ssm": s_new}


def mlstm_state_shapes(cfg: ModelConfig, batch: int):
    _, h, hd = mlstm_dims(cfg)
    return {"ssm": TensorSpec((batch, h, hd, hd + 1), torch.float32)}


# ---------------------------------------------------------------------------
# sLSTM block (sequential, exponential gating with stabiliser: xLSTM eq.
# 14-24)
# ---------------------------------------------------------------------------


def slstm_init(cfg: ModelConfig, generator: Optional[torch.Generator],
               device, dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.param_dtype
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    f32 = torch.float32
    return {
        "wx": init_dense((d, 4 * d), dtype, generator, device),  # i, f, z, o
        "r": init_dense((h, hd, 4 * hd), dtype, generator, device,
                        scale=hd ** -0.5),
        "b": torch.zeros((4 * d,), dtype=f32, device=device),
        "out": init_dense((d, d), dtype, generator, device),
        "norm_w": torch.ones((d,), dtype=f32, device=device),
    }


def _slstm_cell(gates, c, n, m):
    """gates (B, H, hd, 4) float32 preactivations -> new (c, n, m, h)."""
    ig, fg, zg, og = gates.unbind(-1)
    log_i = ig                                      # exponential input gate
    log_f = F.logsigmoid(fg)
    m_new = torch.maximum(log_f + m, log_i)         # stabiliser state
    keep = torch.exp(log_f + m - m_new)
    write = torch.exp(log_i - m_new)
    c_new = keep * c + write * torch.tanh(zg)
    n_new = keep * n + write
    h = torch.sigmoid(og) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, m_new, h


class _ZeroCarry(torch.autograd.Function):
    """The sLSTM's zero initial state, (B, H, hd) float32 on x's device,
    that autograd takes for a function of x (its gradient to x is None).
    The reference's ``lax.scan`` differentiates its carry at every step, so
    its backward forms step 0's recurrent gradient w.r.t. the zero state
    (and drops it); through this node the port's backward forms the same
    product, and a dry run counts the reference's products."""

    @staticmethod
    def forward(ctx, x, shape):
        return torch.zeros(shape, device=x.device)

    @staticmethod
    def backward(ctx, grad):
        return None, None


def slstm_apply(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None):
    cdtype = cfg.compute_dtype
    b, t, d = x.shape
    heads = cfg.n_heads
    hd = d // heads
    wx = (x.to(cdtype) @ p["wx"].to(cdtype)).float() + p["b"]
    wx = wx.reshape(b, t, heads, 4, hd).permute(1, 0, 2, 4, 3)  # T,B,H,hd,4
    r = p["r"].float()                                          # H, hd, 4hd
    if state is None:
        zeros = _ZeroCarry.apply(x, (b, heads, hd))
        c, n, m, h = zeros, zeros, zeros - 1e30, zeros
    else:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for step in range(t):
        rec = torch.einsum("bhd,hdk->bhk", h, r).reshape(b, heads, hd, 4)
        c, n, m, h = _slstm_cell(wx[step] + rec, c, n, m)
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(b, t, d).to(cdtype)
    out = rms_norm(out, p["norm_w"], cfg.norm_eps)
    return out @ p["out"].to(cdtype), {"c": c, "n": n, "m": m, "h": h}


def slstm_decode(p, x: torch.Tensor, cfg: ModelConfig,
                 state: Dict[str, torch.Tensor]):
    out, st = slstm_apply(p, x[:, None, :], cfg, state)
    return out[:, 0], st


def slstm_state_shapes(cfg: ModelConfig, batch: int):
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    s = TensorSpec((batch, h, hd), torch.float32)
    return {"c": s, "n": s, "m": s, "h": s}
