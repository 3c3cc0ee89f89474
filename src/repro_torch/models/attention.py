"""GQA attention: full-sequence (train / prefill) and cached decode paths.

Dispatch picks by the tensor's device, like every kernel wrapper of the
port. On a CUDA tensor ``_sdpa`` always launches the hand-written
``flash_attention`` kernel and ``attn_decode`` the ``flash_decode`` kernel,
whatever ``cfg.attn_impl`` says: on the card the port has one implementation
of each, so no configuration (not the default ``"ref"``, not the chunked
branch at S >= 8192) puts a plain version on the path there. On a CPU tensor
they follow the reference's branches exactly (``attn_impl == "flash"`` ->
the wrapper, which runs the plain version on the CPU; the chunked
online-softmax path at S >= 8192 unless ``"ref_full"``; else the plain
version), so the CPU tests compare like with like. Under
``distributed.partition.use_rules`` with a model axis whose size divides
the cache length, ``attn_decode`` runs the sequence-parallel decode
(``distributed.collectives.sp_decode_attention``: the kernel's partial
entry on each slice of the cache, then the exact merge), as the
reference's decode does under a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.partition import active_rules
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models import kvcache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, init_dense


def attn_init(cfg: ModelConfig, generator: Optional[torch.Generator], device,
              dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.param_dtype
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {name: init_dense(shape, dtype, generator, device)
         for name, shape in (("wq", (d, cfg.n_heads * hd)),
                             ("wk", (d, cfg.n_kv_heads * hd)),
                             ("wv", (d, cfg.n_kv_heads * hd)),
                             ("wo", (cfg.n_heads * hd, d)))}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, cdtype: torch.dtype):
    """x (B, S, D) -> q (B, H, S, hd), k / v (B, KH, S, hd), contiguous."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(cdtype)
    k = x @ p["wk"].to(cdtype)
    v = x @ p["wv"].to(cdtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdtype)
        k = k + p["bk"].to(cdtype)
        v = v + p["bv"].to(cdtype)

    def heads(t, n):
        return t.reshape(b, s, n, hd).transpose(1, 2).contiguous()

    return heads(q, cfg.n_heads), heads(k, cfg.n_kv_heads), \
        heads(v, cfg.n_kv_heads)


CHUNKED_ATTN_THRESHOLD = 8192   # S >= this uses the chunked path (CPU)
CHUNK_KV = 1024


def _chunked_sdpa(q, k, v, causal: bool) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``CHUNK_KV``: the same
    result as the plain version with only a (B, H, S, CHUNK) tile of logits
    alive at a time (the reference's long-context prefill path)."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    qf = q * torch.tensor(d ** -0.5, dtype=q.dtype)
    m = torch.full((b, h, s, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    for lo in range(0, s, CHUNK_KV):
        hi = min(s, lo + CHUNK_KV)
        kc = torch.repeat_interleave(k[:, :, lo:hi], g, dim=1)
        vc = torch.repeat_interleave(v[:, :, lo:hi], g, dim=1)
        sc = torch.einsum("bhqd,bhld->bhql", qf.float(), kc.float())
        if causal:
            kpos = torch.arange(lo, hi, device=q.device)[None, :]
            sc = sc.masked_fill(kpos > qpos, float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(sc - m_safe)
        p = torch.where(torch.isfinite(sc), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhql,bhld->bhqd",
                                        p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def _sdpa(q, k, v, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """The kernel on a CUDA tensor; the reference's branches on the CPU."""
    if q.device.type != "cpu" or cfg.attn_impl == "flash":
        return fa_ops.flash_attention(q, k, v, causal=causal)
    if cfg.attn_impl != "ref_full" and q.shape[2] >= CHUNKED_ATTN_THRESHOLD:
        return _chunked_sdpa(q, k, v, causal)
    return fa_ref.flash_attention(q, k, v, causal=causal)


def _merge_heads(out: torch.Tensor, p, cdtype) -> torch.Tensor:
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"].to(cdtype)


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, cos, sin,
               causal: bool = True,
               kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Full-sequence attention (training / prefill / encoder / cross)."""
    cdtype = cfg.compute_dtype
    x = x.to(cdtype)
    q, k, v = _project_qkv(p, x, cfg, cdtype)
    if kv_override is not None:
        k, v = kv_override                       # cross-attention
    else:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return _merge_heads(_sdpa(q, k, v, cfg, causal), p, cdtype)


def attn_prefill(p, x: torch.Tensor, cfg: ModelConfig, cos, sin
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal attention that also returns the K/V for the cache."""
    cdtype = cfg.compute_dtype
    x = x.to(cdtype)
    q, k, v = _project_qkv(p, x, cfg, cdtype)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _sdpa(q, k, v, cfg, causal=True)
    return _merge_heads(out, p, cdtype), {"k": k, "v": v}


def attn_decode(p, x: torch.Tensor, cfg: ModelConfig, cos, sin,
                cache: Dict[str, torch.Tensor], pos: int,
                kv_len: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with the cache updated in place.

    x (B, D); pos the write position (the same for every row); kv_len (B,)
    int32 live lengths after this token. K/V of the token are written at
    ``pos`` before attending."""
    cdtype = cfg.compute_dtype
    b = x.shape[0]
    q, k, v = _project_qkv(p, x[:, None, :].to(cdtype), cfg, cdtype)
    positions = torch.full((b, 1, 1), int(pos), dtype=torch.long,
                           device=x.device)
    q = apply_rope(q, cos, sin, positions.expand(b, cfg.n_heads, 1))
    k = apply_rope(k, cos, sin, positions.expand(b, cfg.n_kv_heads, 1))
    cache = kvcache.update_kv(cache, k, v, pos)
    q1 = q[:, :, 0].contiguous()                  # (B, H, hd)
    rules = active_rules()
    if rules is not None and rules.model_axis is not None \
            and cache["k"].shape[2] % rules.model_size == 0:
        out = collectives.sp_decode_attention(rules, q1, cache["k"],
                                              cache["v"], kv_len)
    elif x.device.type != "cpu" or cfg.attn_impl == "flash":
        out = fd_ops.decode_attention(q1, cache["k"], cache["v"], kv_len)
    else:
        out = fd_ref.decode_attention(q1, cache["k"], cache["v"], kv_len)
    return out.reshape(b, -1) @ p["wo"].to(cdtype), cache
