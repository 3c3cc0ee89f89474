"""Top-k MoE layer with capacity-based scatter dispatch (GShard semantics,
scatter/gather realization, no (T, E, C) one-hot tensors), as the
reference's ``models/moe.py``.

Routing is a float32 product (``xt.float() @ router``); the port never
enables TF32 for it, because one flipped expert choice changes a token's
output by O(1). Each (token, slot) gets its position in its expert from an
int32 exclusive cumsum over the (T*k, E) one-hot; slots at or past the
capacity C are dropped to the dump row ``E*C`` of an ``E*C + 1``-row buffer
(in range, so no index is masked), and gather back from a zero row there.
The top-k is a stable descending sort, so ties go to the lower expert index
as in ``lax.top_k``. The expert GEMMs are plain batched products
(``torch.bmm``); the router uses softmax-after-top-k normalization
(Mixtral/DBRX convention).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_dense


def moe_init(cfg: ModelConfig, generator: Optional[torch.Generator], device,
             dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.param_dtype
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": init_dense((d, e), torch.float32, generator, device),
        "gate": init_dense((e, d, f), dtype, generator, device),
        "up": init_dense((e, d, f), dtype, generator, device),
        "down": init_dense((e, f, d), dtype, generator, device),
    }


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(p, xt: torch.Tensor, cfg: ModelConfig, cap: int):
    """The router on (T, D) tokens: (top_p (T, k) float32 renormalised,
    top_e (T, k) int32, keep (T*k,) bool, dest (T*k,) int32 rows of the
    (E*C + 1, D) dispatch buffer, aux () float32 load-balancing loss)."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = xt.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k].to(torch.int32)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)            # renormalize
    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e[:, 0].long(), e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    # position of each (token, slot) within its expert, int32
    flat_e = top_e.reshape(t * k)
    onehot = F.one_hot(flat_e.long(), e).to(torch.int32)       # (Tk, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos_in_e = torch.gather(pos, 1, flat_e.long()[:, None])[:, 0]
    keep = pos_in_e < cap
    dest = torch.where(keep, flat_e * cap + pos_in_e,
                       torch.full_like(flat_e, e * cap))       # dump row
    return top_p, top_e, keep, dest, aux


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in the compute dtype, aux () float32)."""
    cdtype = cfg.compute_dtype
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = capacity(t, cfg)
    xt = x.reshape(t, d).to(cdtype)
    top_p, _, keep, dest, aux = route(p, xt, cfg, cap)
    rows = dest.long()

    # dispatch: (E*C, D) buffer and a dump row; token copies scattered in
    src = torch.repeat_interleave(xt, k, dim=0) if k > 1 else xt  # (Tk, D)
    buf = torch.zeros((e * cap + 1, d), dtype=cdtype, device=x.device)
    buf[rows] = src
    hidden = buf[:e * cap].view(e, cap, d)

    # grouped expert GEMMs (SwiGLU)
    g = torch.bmm(hidden, p["gate"].to(cdtype))
    u = torch.bmm(hidden, p["up"].to(cdtype))
    h = F.silu(g) * u
    out_e = torch.bmm(h, p["down"].to(cdtype))

    # combine: each slot's expert output (0 from the zero row when dropped),
    # weighted, summed over k
    flat = torch.cat([out_e.reshape(e * cap, d),
                      torch.zeros((1, d), dtype=cdtype, device=x.device)])
    gathered = flat[rows]                                      # (Tk, D)
    w = (top_p.reshape(t * k) * keep).to(cdtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux.float()
