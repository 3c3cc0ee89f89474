"""Public wrapper for the flash_attention kernel: ``models/attention.py
_sdpa`` calls it.

``flash_attention`` picks the version by the tensor's device: a CPU tensor
runs the plain version in ``ref.py``, a CUDA tensor launches
``csrc/flash_attention.cu`` (or raises): in bf16 a Hopper kernel on the
tensor cores fed by TMA, in float32 a CUDA-core kernel. k and v may have
their own length Sk when the attention is not causal (the encoder-decoder's
cross-attention); causal attention takes Sk = Sq. The kernel masks the
ragged ends of both lengths itself, so nothing is padded and any length is
taken, as by the reference's default path (its einsum plain version); the
reference's Pallas wrapper alone refuses a non-causal S off its tile, and
``tq`` / ``tk`` are taken for its signature and not used. ``check_inputs``
holds what the kernel takes, 16-byte-aligned tensors included.

A CUDA call goes through ``_FlashAttention``, a
``torch.autograd.Function``. Its forward is the kernel launch, counted in
``LAUNCHES``; under autograd (training) it keeps q, k and v. Its backward runs the plain
version on them under ``torch.enable_grad()`` and returns that graph's
gradients for q, k and v: the gradient of the function the kernel computes,
which the kernel matches to bf16 rounding. The reference has no backward
kernel (it trains through its plain attention), so the port has none
either. The cost is the plain version's memory in the backward, one call at
a time: at tinyllama's training microbatch (B 2, H 32, S 2,048) each float32
(B, H, S, S) tensor of its graph (the logits, the masked logits, the
softmax, its upcast and their gradients) takes 1.07 GB, about 4 to 6 GB in
all, freed before the next layer's backward. Under ``layers.remat`` the
forward runs again in the backward, so a training step launches the kernel
twice an attention block and microbatch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16          # bytes: TMA's rule for a tensor's base address

# launches of the CUDA kernel in this process (never the plain version), and
# the largest (B, H, KH, S, D) it launched (S the query length)
LAUNCHES = 0
SHAPE = None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    tq: Optional[int] = None,
                    tk: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Sq, D), k/v (B, KH, Sk, D) (Sk = Sq when causal) ->
    (B, H, Sq, D) in q's dtype."""
    scale = scale if scale is not None else q.shape[3] ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    return _FlashAttention.apply(q, k, v, causal, float(scale))


class _FlashAttention(torch.autograd.Function):
    """The kernel forward, the plain version's gradient (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _launch(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.flash_attention(*inputs, causal=ctx.causal,
                                      scale=ctx.scale)
        grads = torch.autograd.grad(out, inputs, grad)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True) -> tuple:
    """Raise ValueError unless the kernel takes (q, k, v); return (B, H, KH,
    Sq, D). It takes float32 or bfloat16, D in ``HEAD_DIMS``, H a
    multiple of KH, k and v of one length Sk (Sq when causal), contiguous
    tensors of one dtype on one device, each starting on a 16-byte boundary
    (the bf16 kernel's TMA loads need it; float32 keeps the same rule)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, s, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if causal and sk != s:
        raise ValueError(f"flash_attention: causal attention needs k of q's "
                         f"length {s}, got {tuple(k.shape)}")
    if q.dtype not in DTYPES or d not in HEAD_DIMS or kh == 0 or h % kh:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16 "
                         f"with D in {HEAD_DIMS} and H a multiple of KH, got "
                         f"{q.dtype} {tuple(q.shape)}, KH={kh}")
    for name, t, shape in (("q", q, (b, h, s, d)), ("k", k, (b, kh, sk, d)),
                           ("v", v, (b, kh, sk, d))):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"{q.dtype} {shape} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"{ALIGN}-byte boundary, got address "
                             f"{t.data_ptr():#x}")
    return b, h, kh, s, d


def _launch(q, k, v, causal: bool, scale: float,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel into ``out`` (a new tensor unless given: the
    card-only tests pass a view whose neighbours hold a sentinel)."""
    global LAUNCHES, SHAPE
    from repro_torch.kernels import _build
    b, h, kh, s, d = check_inputs(q, k, v, causal)
    sk = k.shape[2]
    if out is None:
        out = torch.empty_like(q)
    elif (out.device != q.device or out.dtype != q.dtype
          or out.shape != q.shape or not out.is_contiguous()
          or out.data_ptr() % ALIGN):
        raise ValueError(f"flash_attention: out must be a contiguous, "
                         f"{ALIGN}-byte-aligned tensor like q")
    if out.numel() == 0:
        return out
    if sk == 0:                 # no key: every row's output is 0
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kh, s, sk, d, DTYPES[q.dtype], scale, int(bool(causal)),
            ctypes.c_void_p(stream))
    _build.check(code, "flash_attention")
    LAUNCHES += 1
    SHAPE = _build.larger(SHAPE, (b, h, kh, s, d))
    return out
