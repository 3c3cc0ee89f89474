"""Batched serving loop: prefill, then greedy decode over the KV caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 8 --prompt-len 512 --gen 32                 # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Every architecture id serves: token prompts for the decoder-only LMs,
seeded embeddings for the ``embed`` frontend (pixtral), seeded frames and 4
decoder tokens for the encoder-decoder (seamless).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import build_decode_step
from repro_torch.models import lm
from repro_torch.models.model import ModelApi


def prefill_scores(params, cfg, tokens: torch.Tensor,
                   lanes: int = 64) -> torch.Tensor:
    """One batched prefill as a relevance scorer: (B, S) prompts -> (B,)
    float32 scores, the mean of the first ``lanes`` final-position logits
    (``core/enrich.LMScorer``). The reference takes them from
    ``lm.forward``'s full (B, S, V) logits; here the final norm and the head
    run on the last position and the first ``lanes`` vocab columns only,
    which gives the same numbers (the head works position by position and
    column by column) without the (B, S, V) tensor: about 100 GB in bf16 at
    32,768 prompts of 10 tokens and qwen2-1.5b's vocab."""
    x, _ = lm.hidden(params, cfg, tokens=tokens)
    logits = lm.head_out(params, cfg, x[:, -1:, :], cols=lanes)[:, 0]
    return torch.mean(logits, dim=-1).float()


def serve_inputs(cfg, batch: int, prompt_len: int, gen: int, dev):
    """The reference's seeded serving inputs (numpy seed 0, the same draws
    in the same order): (prefill batch, cache length). Token frontends get
    (batch, prompt_len) int32 prompts; the ``embed`` frontend float32
    (batch, prompt_len, d_model) embeddings; an enc-dec model that many
    frames and 4 decoder tokens, with a cache of 4 + gen."""
    rng = np.random.default_rng(0)

    def embeds():
        return torch.tensor(rng.normal(size=(batch, prompt_len, cfg.d_model))
                            .astype(np.float32), device=dev)

    def tokens(n):
        return torch.tensor(rng.integers(0, cfg.vocab_size, (batch, n))
                            .astype(np.int32), device=dev)

    if cfg.is_encdec:
        return {"embeds": embeds(), "tokens": tokens(4)}, 4 + gen
    if cfg.frontend == "embed":
        return {"embeds": embeds()}, prompt_len + gen
    return {"tokens": tokens(prompt_len)}, prompt_len + gen


def serve(cfg, batch: int, prompt_len: int, gen: int, greedy: bool = True,
          device: DeviceLike = "cuda", params=None):
    """Prefill ``batch`` seeded inputs (``serve_inputs``), then decode
    ``gen`` tokens greedily. Parameters come from ``torch.Generator`` seeded
    0 on the device (the reference seeds ``jax.random.key(0)``; the two draw
    different numbers) unless ``params`` are given. Returns (tokens
    (batch, gen) int64 numpy, prefill seconds, decode seconds)."""
    dev = resolve_device(device)
    api = ModelApi(cfg)
    if params is None:
        params = api.init(torch.Generator(dev).manual_seed(0))
    pf_batch, max_len = serve_inputs(cfg, batch, prompt_len, gen, dev)
    decode = build_decode_step(api)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, caches, pos = api.prefill(params, pf_batch, max_len=max_len)
    sync()
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, -1)
    tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(params, caches, pos + i, {"token": tok})
        tok = torch.argmax(logits, -1)
        tokens.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    return torch.stack(tokens, 1).cpu().numpy(), t_prefill, t_decode


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    toks, tp, td = serve(cfg, args.batch, args.prompt_len, args.gen,
                         device=args.device)
    per_tok = td / max(1, args.gen - 1) * 1e3
    print(f"prefill {tp*1e3:.1f} ms; decode {per_tok:.2f} ms/token; "
          f"sample row: {toks[0][:8].tolist()}")


if __name__ == "__main__":
    main()
