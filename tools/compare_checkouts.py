#!/usr/bin/env python3
"""Compare checkouts of the port on one card, in turns.

    python3 tools/compare_checkouts.py PARENT CHANGE [--rounds 1]

A round runs every checkout in the order given and then in reverse
(PARENT, CHANGE, CHANGE, PARENT), each in a process of its own that imports
that checkout's ``chip_smoke.py`` and ``src/`` and so builds that
checkout's kernels. Each process times three ``launch/serve.py::serve``
calls on seeded qwen2-1.5b weights at ``chip_smoke.SERVE``'s shape, after a
warm-up call (prefill ms, decode ms a token: host clock ending in a device
sync), and ``flash_attention`` by ``chip_smoke.measure`` at the serve
prefill's shape and at the enriched tick's scorer batch, beside SDPA. A
checkout is a directory holding ``chip_smoke.py`` and ``src/``, such as an
unpacked ``git archive`` of the parent commit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys


def one(root: str) -> int:
    """Time one checkout (this process imports only its files)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch import configs
    from repro_torch.core import records
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import ModelApi
    if not torch.cuda.is_available():
        print("compare_checkouts: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = configs.get_config("qwen2-1.5b")
    b, p, g = (chip_smoke.SERVE[k] for k in ("batch", "prompt_len", "gen"))
    params = ModelApi(cfg).init(torch.Generator(dev).manual_seed(0))
    serve(cfg, b, p, 3, device=dev, params=params)          # warm-up call
    for _ in range(3):
        _, t_pre, t_dec = serve(cfg, b, p, g, device=dev, params=params)
        print(f"{root}: serve prefill {t_pre * 1e3:.2f} ms, decode "
              f"{t_dec / (g - 1) * 1e3:.3f} ms/token", flush=True)
    del params
    torch.cuda.empty_cache()
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    scorer = chip_smoke.MAIN["max_candidates"]
    fields = records.ENRICHED_TWEET_SCHEMA.num_fields
    rng = np.random.default_rng(chip_smoke.SEED + 7)
    for where, (bb, s) in (("serve prefill", (b, p)),
                           ("scorer", (scorer, fields))):
        shape = (bb, heads[0], heads[1], s, heads[2])
        k = chip_smoke.measure(chip_smoke.case_flash_attention(dev, rng,
                                                               shape),
                               str(shape))
        print(f"{root}: flash_attention {where} {shape}: {k['ms']:.4f} ms, "
              f"SDPA {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms, "
              f"max_abs_err {k['max_abs_err']} "
              f"({'within' if k['within_tolerance'] else 'OUTSIDE'} "
              f"tolerance)", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(args.checkouts[0])
    order = (args.checkouts + args.checkouts[::-1]) * args.rounds
    failed = 0
    for root in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root])
        failed += r.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
