"""The plain scorer of the port's dense decoder family (``LMScorer``'s
default): token embedding, then per layer RMSNorm, GQA attention with RoPE
and a causal mask, a residual, RMSNorm, a SwiGLU MLP and a residual; a final
RMSNorm and the first ``lanes`` columns of the head at the last position.
The score of a prompt is the mean of those ``lanes`` logits, in float32.

``model`` holds the plain settings: ``vocab_size``, ``d_model``,
``n_layers``, ``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``,
``rope_theta``, ``norm_eps``, ``qkv_bias``, ``tie_embeddings`` and
``param_dtype``, the type the weights are served in.

Departures from the published models of the family, each the scorer's as
the program defines it (``core/enrich.LMScorer``, ``models/lm.py``):

- the prompt is a record's field vector, each field clipped into
  ``[0, vocab_size)``: record fields are not text;
- a tied head scales the final norm's output by ``d_model ** -0.5`` before
  the product with the embedding;
- RoPE rotates the two halves of a head (not interleaved pairs), with
  positions 0 .. S - 1 of each prompt;
- the embedding has ``vocab_size`` rounded up to a multiple of 128 rows; the
  padding rows are drawn and never read.

Weights: one ``torch.Generator`` on the device, seeded by the seed, draws
each leaf in one call in the layout the JAX reference stacks (every
layer's leaf stacked on axis 0): the embedding N(0, 1); a projection
N(0, 1) * fan_in ** -0.5; the q/k/v biases 0.1 * N(0, 1) and the norms
1 + 0.1 * N(0, 1), so that both are exercised. Each leaf is rounded to
``param_dtype`` and held in float32, so the program, which casts them to
its own types, serves the very values this forward reads.

Tolerance on a score (the configuration states its own, with its reason):

- a float32 program (the CPU tests' reduced model, ``tests/tiny.py``):
  atol 1e-5, rtol 1e-4. On the CPU both forwards run the same float32
  operations in the same order: over 12 seeds of 512 record prompts the
  program's scores equal these exactly. The same forward with bfloat16
  matrix products moves a score by 4.0e-3 to 7.1e-3, 53 to 538 times the
  tolerance (``test_bad_bench_scored.py`` holds both).
- a bfloat16 program at a published width (qwen2-1.5b whole, on an H100):
  atol 0.025, rtol 0. The program rounds every product, activation and
  attention operand to bfloat16; over 12 seeds of 4,096 record prompts its
  largest error is 0.0071 to 0.0092, while this forward with float8 (e4m3,
  per-tensor scaled) matrix products, the precision below, errs by 0.066
  to 0.089 at its largest. The limit sits 2.7 times above the one and 2.6
  times below the least of the other. Scores cross zero (their median
  magnitude is 0.07 to 0.21, the largest 0.44 to 0.57), so a relative part
  would only widen the limit where the scores are largest.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

BLOCK = 1024            # prompts a forward block


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, str(name).replace("torch.", ""))


def padded_vocab(model: Dict) -> int:
    return -(-int(model["vocab_size"]) // 128) * 128


def shapes(model: Dict) -> Dict:
    """The stacked tree's leaf shapes, by path."""
    d, L = model["d_model"], model["n_layers"]
    hd, h, kh, f = (model["head_dim"], model["n_heads"], model["n_kv_heads"],
                    model["d_ff"])
    attn = {"wq": (L, d, h * hd), "wk": (L, d, kh * hd),
            "wv": (L, d, kh * hd), "wo": (L, h * hd, d)}
    if model["qkv_bias"]:
        attn.update(bq=(L, h * hd), bk=(L, kh * hd), bv=(L, kh * hd))
    out = {"embed": (padded_vocab(model), d),
           "layers": {"b0": {"norm1": (L, d), "attn": attn, "norm2": (L, d),
                             "mlp": {"gate": (L, d, f), "up": (L, d, f),
                                     "down": (L, f, d)}}},
           "final_norm": (d,)}
    if not model["tie_embeddings"]:
        out["head"] = (d, padded_vocab(model))
    return out


def init(model: Dict, seed: int, device) -> Dict:
    """The weights: ``{"model": model, "tree": stacked float32 leaves}``."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(int(seed) % 2 ** 64)
    served = _dtype(model["param_dtype"])

    def draw(path: Tuple[str, ...], shape) -> torch.Tensor:
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        name = path[-1]
        if name.startswith("norm") or name == "final_norm":
            w.mul_(0.1).add_(1.0)
        elif name in ("bq", "bk", "bv"):
            w.mul_(0.1)
        elif name != "embed":
            w.mul_(shape[-2] ** -0.5)
        return w.copy_(w.to(served))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], path + (k,)) for k in node}
        return draw(path, node)

    return {"model": dict(model), "tree": walk(shapes(model), ())}


def _mm(a: torch.Tensor, b: torch.Tensor, dt: Optional[torch.dtype]):
    """a @ b in float32; with ``dt`` the operands are first rounded to it
    (per-tensor scaled for the float8 types) and, for bfloat16, the product
    is bfloat16's: the lower precisions a control runs in."""
    if dt is None:
        return a @ b
    if dt == torch.bfloat16:
        return (a.to(dt) @ b.to(dt)).float()
    top = torch.finfo(dt).max

    def q(x):
        s = x.abs().amax().clamp(min=1e-30) / top
        return (x / s).to(dt).float() * s

    return q(a) @ q(b)


def _rms(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _forward(w: Dict, tokens: torch.Tensor, lanes: int,
             dt: Optional[torch.dtype]) -> torch.Tensor:
    m, t = w["model"], w["tree"]
    b, s = tokens.shape
    d, hd = m["d_model"], m["head_dim"]
    h, kh, eps = m["n_heads"], m["n_kv_heads"], m["norm_eps"]
    dev = tokens.device
    inv = 1.0 / (float(m["rope_theta"]) ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd))
    ang = torch.outer(torch.arange(s, dtype=torch.float32, device=dev), inv)
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    x = t["embed"][tokens.long()]
    lay = t["layers"]["b0"]
    for i in range(m["n_layers"]):
        a = lay["attn"]
        y = _rms(x, lay["norm1"][i], eps)
        heads = {}
        for name, n in (("q", h), ("k", kh), ("v", kh)):
            p = _mm(y, a[f"w{name}"][i], dt)
            if m["qkv_bias"]:
                p = p + a[f"b{name}"][i]
            heads[name] = p.reshape(b, s, n, hd).transpose(1, 2)
        q = _rope(heads["q"], cos, sin)
        k = torch.repeat_interleave(_rope(heads["k"], cos, sin), h // kh, 1)
        v = torch.repeat_interleave(heads["v"], h // kh, 1)
        logits = _mm(q, k.transpose(-1, -2), dt) * hd ** -0.5
        probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        o = _mm(probs, v, dt).transpose(1, 2).reshape(b, s, h * hd)
        x = x + _mm(o, a["wo"][i], dt)
        y = _rms(x, lay["norm2"][i], eps)
        mlp = lay["mlp"]
        g = torch.nn.functional.silu(_mm(y, mlp["gate"][i], dt))
        x = x + _mm(g * _mm(y, mlp["up"][i], dt), mlp["down"][i], dt)
    z = _rms(x[:, -1], t["final_norm"], eps)
    if m["tie_embeddings"]:
        z = z * d ** -0.5
        head = t["embed"][:lanes].T
    else:
        head = t["head"][:, :lanes]
    return torch.mean(_mm(z, head, dt), dim=-1)


def score(weights: Dict, tokens: torch.Tensor, lanes: int,
          mm_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, S) prompts (record fields, clipped here into the vocabulary) ->
    (N,) float32 scores, in blocks of ``BLOCK`` prompts on the weights'
    device, TF32 off. ``mm_dtype`` rounds every matrix product's operands to
    a lower precision: a control, never the reference."""
    dev = weights["tree"]["embed"].device
    vocab = int(weights["model"]["vocab_size"])
    tokens = torch.as_tensor(tokens, device=dev).clamp(0, vocab - 1)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            out = [_forward(weights, tokens[i:i + BLOCK], lanes, mm_dtype)
                   for i in range(0, tokens.shape[0], BLOCK)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    if not out:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    return torch.cat(out).float()


def flops(model: Dict, shape, lanes: int) -> float:
    """Model FLOPs of scoring (N, S) prompts: per layer the q, k, v and o
    projections, the causal attention's QK^T and PV over the S (S + 1) / 2
    live positions of each head, the three MLP products; then the head's
    ``lanes`` columns at the last position. Two FLOPs a multiply-add."""
    n, s = (int(v) for v in shape)
    d, hd, f = model["d_model"], model["head_dim"], model["d_ff"]
    h, kh = model["n_heads"], model["n_kv_heads"]
    proj = 2 * s * d * (2 * h * hd + 2 * kh * hd)
    attn = 2 * 2 * h * hd * (s * (s + 1) // 2)
    mlp = 2 * s * d * f * 3
    per_prompt = model["n_layers"] * (proj + attn + mlp) + 2 * d * lanes
    return float(n) * per_prompt

