"""Train an LM with the port's full loop (checkpoint/restart included).

Default: a reduced xlstm config for a quick demo. ``--full-100m`` trains a
~100M-parameter tinyllama-family config (float32, no accumulation, no
remat), as the reference's ``examples/train_lm.py`` does. The card is the
default device; ``--device cpu`` runs the same loop on the CPU.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30
    PYTHONPATH=src python examples/train_lm_torch.py --full-100m --steps 300
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.launch.train import train
from repro_torch.models.model import ModelApi


def hundred_m_config():
    base = configs.get_config("tinyllama-1.1b")
    return dataclasses.replace(
        base, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
        superlayer_repeat=12, n_layers=12, head_dim=64, vocab_size=32000,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        grad_accum=1, remat=False).validate()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm_torch"))
    args = ap.parse_args()
    cfg = hundred_m_config() if args.full_100m else configs.get_reduced(
        "xlstm-125m")
    print(f"training {cfg.name} ({ModelApi(cfg).param_count():,} params) "
          f"for {args.steps} steps on {args.device}")
    _, _, losses = train(cfg, args.steps, args.batch, args.seq, args.ckpt_dir,
                         ckpt_every=20, log_every=5, device=args.device)
    if losses:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
