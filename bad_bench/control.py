#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the reference
computed one precision step down (record fields as int16, locations and
distances in bfloat16), put in the program's place, must come out as not
correct.

    python3 bad_bench/control.py --workload <cell> --seeds 1 2 3 \
        [--ticks N]

For each seed it records what the narrowed reference would have
delivered over ``N`` ticks, in the shape ``system.run`` records the
program (every tick delivered in full, nothing spilled), judges it with
``check.compare`` against the reference at the configuration's precision,
and prints each number beside its limit. Runs on the first card when
there is one (the cell's own size), else on the CPU; imports nothing of
the program.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bad_bench import check, system  # noqa: E402
from bad_bench import traffic as T  # noqa: E402
from bad_bench.reference import reference  # noqa: E402


def as_run(want, cfg, cell) -> system.Run:
    """A ``system.Run`` holding what ``want`` says was delivered."""
    chans = {ch["name"]: ch for ch in cfg["channels"]}
    ticks = []
    for per in want.ticks:
        reps = {}
        for name, (matched, res, notified, nb_k, rb) in per.items():
            ch = chans[name]
            pay = ch["payload_bytes"]
            if ch["join"] == "spatial":
                results = res
                bb = (pay * rb) % 2 ** 32
            else:
                # one line a (record, broker), as ``_lines`` builds them
                results = int(rb.sum())
                bb = pay * rb + 4 * nb_k
            st = (results, 0, 0, notified, 0, 0, 0, 0, 0, 0)
            reps[name] = (results, notified, bb.tolist(), st)
        ticks.append(system.Tick(0.0, cell["tweets_per_tick"], reps, {},
                                 []))
    for k, ctl in enumerate(want.control):
        ticks[k].control = list(ctl)
    sampled = {}
    for k, per in want.sampled.items():
        sampled[k] = {n: (_lines(keys, brokers, chans[n]["join"] == "param"),
                          sids.astype(np.int32))
                      for n, (keys, sids, brokers) in per.items()}
    return system.Run(
        setup_s=0.0, window=ticks, window_s=1.0, ticks=ticks,
        sampled=sampled, final_drains=[], pending_after=0,
        ring_fields=want.ring_fields, ring_location=want.ring_location,
        size_rows=want.rows, memory_peak_bytes=0, spans={}, profile=None,
        flush_drops=0)


def _lines(keys: np.ndarray, brokers: np.ndarray,
           grouped: bool) -> np.ndarray:
    """Wire lines of sorted (row, sID) keys: [row, 0, members, 0, sID,
    ...], one a (row, broker) with its sIDs as members where ``grouped``
    (a param channel), else one a pair."""
    rows = keys >> reference.SID_BITS
    sids = keys & ((1 << reference.SID_BITS) - 1)
    b = brokers[sids] if grouped else np.arange(len(sids))
    order = np.lexsort((sids, b, rows))
    rows, sids, b = rows[order], sids[order], b[order]
    new = np.ones(len(rows), bool)
    new[1:] = (rows[1:] != rows[:-1]) | (b[1:] != b[:-1])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(rows)))
    width = int(counts.max()) if len(counts) else 1
    lines = np.zeros((len(starts), 4 + width), np.int32)
    lines[:, 0], lines[:, 2] = rows[starts], counts
    col = np.arange(len(rows)) - np.repeat(starts, counts)
    lines[np.repeat(np.arange(len(starts)), counts), 4 + col] = sids
    return lines


def control_numbers(cfg, cell, seed: int, ticks: int, dev) -> dict:
    sampled = T.sample_ticks(seed, 0, ticks, 1.0, cell["samples"])
    narrow = reference.expected(cfg, cell, seed, ticks, sampled, dev,
                                narrow=True)
    want = reference.expected(cfg, cell, seed, ticks, sampled, dev)
    return check.compare(as_run(narrow, cfg, cell), want, cfg, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--ticks", type=int, default=64)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "bad_bench", "cells",
                           f"{args.workload}.json")) as fh:
        cell = json.load(fh)
    with open(os.path.join(ROOT, "bad_bench", "configs",
                           f"{cell['config']}.json")) as fh:
        cfg = json.load(fh)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in args.seeds:
        numbers = control_numbers(cfg, cell, seed, args.ticks, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "ticks": args.ticks,
                          "correct": check.correct(numbers),
                          "numbers": {k: v for k, (v, _) in
                                      numbers.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
