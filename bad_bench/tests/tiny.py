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
