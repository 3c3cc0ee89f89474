#!/usr/bin/env python3
"""Compare checkouts of the port on one card, in turns.

    python3 tools/compare_checkouts.py PARENT CHANGE [--rounds 1]
        [--only serve compact flash_attention flash_decode join_compact ...]

A round runs every checkout in the order given and then in reverse
(PARENT, CHANGE, CHANGE, PARENT), each in a process of its own that imports
that checkout's ``chip_smoke.py`` and ``src/`` and so builds that
checkout's kernels. Each process times three ``launch/serve.py::serve``
calls on seeded qwen2-1.5b weights at ``chip_smoke.SERVE``'s shape, after a
warm-up call (prefill ms, decode ms a token: host clock ending in a device
sync), ``flash_attention`` by ``chip_smoke.measure`` at the serve
prefill's shape and at the enriched tick's scorer batch, beside SDPA, and
every other kernel entry at the shapes of PERF.md's kernel table
(``flash_decode`` at the serve decode and a 32,768-key cache,
``predicate_filter`` at the ingest and a full scan of the 2M-row ring, the
stacked rows, both spatial joins, ``join_compact`` at the fused path's and
the compact phase's shapes, each beside the empty kernel's floor on its grid
where the checkout measures one), and the compact phase's ``execute_all``
ticks (``chip_smoke.compact_phase`` at ``chip_smoke.COMPACT``, both
backends, host clock ending in a device sync). A checkout is a directory
holding ``chip_smoke.py`` and ``src/``, such as an unpacked ``git archive``
of the parent commit. ``--only`` keeps the named parts (``serve``,
``compact`` or a kernel entry's name) and skips the rest.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def one(root: str, only) -> int:
    """Time one checkout (this process imports only its files): the parts
    named in ``only``, or all of them."""
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
    if only is None or "serve" in only:
        params = ModelApi(cfg).init(torch.Generator(dev).manual_seed(0))
        serve(cfg, b, p, 3, device=dev, params=params)      # warm-up call
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
        if only is not None and "flash_attention" not in only:
            break
        shape = (bb, heads[0], heads[1], s, heads[2])
        k = chip_smoke.measure(chip_smoke.case_flash_attention(dev, rng,
                                                               shape),
                               str(shape))
        print(f"{root}: flash_attention {where} {shape}: {k['ms']:.4f} ms, "
              f"SDPA {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms, "
              f"max_abs_err {k['max_abs_err']} "
              f"({'within' if k['within_tolerance'] else 'OUTSIDE'} "
              f"tolerance)", flush=True)
    # the other kernels at the shapes of PERF.md's kernel table: the serve
    # decode and a 32,768-key cache; the ingest, a full scan of the main
    # path's 2M-row ring and the compact phase's stacked rows; the spatial
    # joins; the compact join at the fused path's shape and the compact
    # phase's real grid
    cases = [
        ("flash_decode", "serve decode", (b, heads[0], heads[1], p + g,
                                          heads[2]),
         chip_smoke.case_flash_decode),
        ("flash_decode", "long cache", (b, heads[0], heads[1], 32768,
                                        heads[2]),
         chip_smoke.case_flash_decode),
        ("predicate_filter", "ingest", (65536, fields, 3),
         chip_smoke.case_predicate_filter),
        ("predicate_filter", "full scan", (1 << 21, fields, 3),
         chip_smoke.case_predicate_filter),
        ("predicate_filter_rows", "compact phase", (6, 28672, fields),
         chip_smoke.case_predicate_filter_rows),
        ("spatial_match", "per-channel path", (16384, 10000),
         chip_smoke.case_spatial_match),
        ("spatial_match_stacked", "fused path", (1, 16384, 16384),
         chip_smoke.case_spatial_match_stacked),
        ("join_compact", "fused path", (16384, 16),
         lambda dev, rng, shape: chip_smoke.case_join_compact(
             dev, rng, shape, aggregated=True)),
        ("join_compact", "compact phase", (8192, 16384),
         lambda dev, rng, shape: chip_smoke.case_join_compact(
             dev, rng, shape, aggregated=False)),
    ]
    for name, where, shape, case in cases:
        if only is not None and name not in only:
            continue
        k = chip_smoke.measure(case(dev, rng, shape), str(shape))
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        if k.get("floor_ms") is not None:
            lib += f", floor {k['floor_ms']:.4f} ms"
        if "path" in k:
            lib += f", {k['path']} path"
        print(f"{root}: {name} {where} {shape}: {k['ms']:.4f} ms, wrapper "
              f"{k['wrapper_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms"
              f"{lib}, bound {k['bound_ms']:.4f} ms, max_abs_err "
              f"{k['max_abs_err']} "
              f"({'within' if k['within_tolerance'] else 'OUTSIDE'} "
              f"tolerance)", flush=True)
    if only is None or "compact" in only:
        torch.cuda.empty_cache()
        cp = chip_smoke.compact_phase(dev, chip_smoke.COMPACT)
        for backend in ("compact_pallas", "pallas"):
            walls = ", ".join(f"{w:.3f}" for w in cp[backend]["walls_ms"])
            print(f"{root}: compact phase {backend} execute_all ms a tick "
                  f"[{walls}]; launches "
                  f"{json.dumps(cp[backend]['launches'])}", flush=True)
        del cp
        torch.cuda.empty_cache()
    print(f"{root}: {chip_smoke.card_line()}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", nargs="+", default=None,
                    help="time only these parts: serve, compact, or kernel "
                         "entries")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(args.checkouts[0], args.only)
    order = (args.checkouts + args.checkouts[::-1]) * args.rounds
    failed = 0
    for root in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root]
                           + (["--only", *args.only] if args.only else []))
        failed += r.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
