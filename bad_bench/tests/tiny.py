"""Tiny copies of the benchmark's configurations and cells, for runs on
the CPU: the shapes of the real ones (channels, plans, churn mix, cohort)
at a few thousand rows and subscriptions."""
from __future__ import annotations

import copy
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]


def load(cell_name: str):
    cell = json.loads((BENCH / "cells" / f"{cell_name}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                     .read_text())
    return cfg, cell


def tiny(cell_name: str):
    cfg, cell = copy.deepcopy(load(cell_name))
    cfg["preload_rows"], cfg["preload_chunk"] = 4096, 1024
    cfg["users"] = min(cfg["users"], 300)
    for ch in cfg["channels"]:
        if "subscriptions" in ch:
            ch["subscriptions"] //= 400
    cfg["engine"].update(dataset_capacity=4096, index_capacity=1 << 15,
                         frame_bytes=4096, max_deliver_pairs=1024,
                         max_notify=1 << 15)
    cell.update(tweets_per_tick=512, pool=4, warmup_ticks=2)
    if cell.get("churn"):
        for w in cell["churn"]["workloads"]:
            w["adds"] //= 100
            w["removes"] //= 100
            if "user_churn" in w:
                w["user_churn"] = 8
        cell["cohort"]["users"] = 150
    return cfg, cell


# qwen2-1.5b's plain settings as the port's registry holds them (the
# published rms_norm_eps is 1e-6; the port's dense family takes 1e-5)
QWEN2_1_5B = {"vocab_size": 151936, "d_model": 1536, "n_layers": 28,
              "n_heads": 12, "n_kv_heads": 2, "head_dim": 128, "d_ff": 8960,
              "rope_theta": 1e6, "norm_eps": 1e-5, "qkv_bias": True,
              "tie_embeddings": True, "param_dtype": "bfloat16"}
# the reduced dense model of the CPU tests: every width cut, float32
REDUCED = {"d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
           "vocab_size": 256, "n_layers": 2, "superlayer_repeat": 2,
           "head_dim": 16, "param_dtype": "float32",
           "compute_dtype": "float32"}
TOLERANCE = {"atol": 1e-5, "rtol": 1e-4,
             "why": "a float32 program against the float32 plain forward: "
                    "sums in another order only"}


def tiny_scored(cell_name: str = "paper-1m.fused", budget: int = 32,
                lanes: int = 16):
    """A tiny copy with an ``enrichment`` block: the reduced dense scorer
    at ``budget`` pairs a channel an execution."""
    cfg, cell = tiny(cell_name)
    cfg["enrichment"] = {"arch": "qwen2-1.5b", "model": dict(QWEN2_1_5B),
                         "overrides": dict(REDUCED), "budget": budget,
                         "lanes": lanes, "plain": "dense",
                         "tolerance": dict(TOLERANCE)}
    return cfg, cell
