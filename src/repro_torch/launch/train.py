"""Train loop: the accumulating train step, checkpointing, watchdog,
recovery (the reference's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 8 --batch 16 --seq 2048 --ckpt-dir ckpt          # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --steps 6 --batch 4 --seq 32 --device cpu --ckpt-dir ck

A second run with more ``--steps`` and the same ``--ckpt-dir`` resumes from
the latest checkpoint. Batches are the reference's numpy batches
(``TokenStream``; seeded embeddings for the ``embed`` frontend and the
encoder-decoder), moved to the device each step.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs, tree
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.interop import params_from_numpy
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import build_train_step, default_optimizer
from repro_torch.models.model import ModelApi
from repro_torch.runtime.failure import FailureInjector, StepTimer


def make_batch_fn(cfg, batch: int, seq: int):
    """step -> the reference's numpy batch for that step: ``TokenStream``
    tokens and labels; for the ``embed`` frontend float32 embeddings from
    ``default_rng(step)``; for the encoder-decoder those as frames with
    ``max(4, seq // 4)`` decoder tokens and labels."""
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch)

    def fn(step: int):
        b = stream.batch(step)
        if cfg.frontend == "embed" or cfg.is_encdec:
            rng = np.random.default_rng(step)
            embeds = rng.normal(size=(batch, seq, cfg.d_model)) \
                .astype(np.float32)
            if cfg.is_encdec:
                s_dec = max(4, seq // 4)
                return {"embeds": embeds, "tokens": b["tokens"][:, :s_dec],
                        "labels": b["labels"][:, :s_dec]}
            return {"embeds": embeds, "labels": b["labels"]}
        return b

    return fn


def train(cfg, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int = 20, injector: FailureInjector = None,
          log_every: int = 10, resume: bool = True,
          device: DeviceLike = "cuda", params=None):
    """Train for ``steps`` steps (resuming from the latest checkpoint in
    ``ckpt_dir`` unless ``resume`` is False), saving every ``ckpt_every``
    steps and at the end. Parameters come from a ``torch.Generator`` seeded
    0 on the device unless ``params`` are given: a numpy tree in the
    reference's layout (``jax.random`` cannot be reproduced in torch) is
    carried across by ``interop.params_from_numpy``, a tree of tensors is
    trained in place. Returns (params, opt_state, losses of the steps
    run)."""
    dev = resolve_device(device)
    api = ModelApi(cfg)
    optimizer = default_optimizer(cfg)
    step_fn = build_train_step(api, optimizer,
                               accum=min(cfg.grad_accum, batch))
    mgr = CheckpointManager(ckpt_dir, keep=2)
    batch_fn = make_batch_fn(cfg, batch, seq)
    timer = StepTimer()

    if params is None:
        params = api.init(torch.Generator(dev).manual_seed(0))
    elif isinstance(tree.leaves(params)[0], np.ndarray):
        params = params_from_numpy(cfg, params, device=dev)
    opt_state = optimizer.init(params)
    start = 0
    latest = mgr.latest_step()
    if resume and latest is not None:
        state = mgr.restore(latest, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = latest
    losses = []
    try:
        for step in range(start, steps):
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.perf_counter()
            host = batch_fn(step)
            params, opt_state, metrics = step_fn(
                params, opt_state,
                {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
            losses.append(float(metrics["loss"]))      # waits for the step
            timer.record("host0", time.perf_counter() - t0)
            if (step + 1) % ckpt_every == 0 or step + 1 == steps:
                mgr.save(step + 1, {"params": params, "opt": opt_state})
            if (step + 1) % log_every == 0:
                print(f"step {step+1}: loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={timer.times['host0']*1e3:.0f}ms", flush=True)
    finally:
        # Flush the async writer even when a step fails: the last published
        # checkpoint must be durable (not a half-renamed .tmp) so a restart
        # actually resumes from it.
        mgr.wait()
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    t0 = time.time()
    _, _, losses = train(cfg, args.steps, args.batch, args.seq, args.ckpt_dir,
                         device=args.device)
    if losses:
        print(f"done in {time.time()-t0:.1f}s; loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}")
    else:
        print(f"nothing to do: the checkpoint is at step {args.steps} or "
              f"later")


if __name__ == "__main__":
    main()
