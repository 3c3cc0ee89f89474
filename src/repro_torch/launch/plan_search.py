"""Offline plan search: time every (scan x layout) plan per channel on the
engine's device and persist the winning assignment.

  PYTHONPATH=src python -m repro_torch.launch.plan_search --subs 2000 \
      --tweets 4096 --match 0.05 --out experiments/plan_search [--device cpu]

The JSON it writes round-trips through ``planner.load_plans`` /
``planner.apply_plans`` (of either package) to seed an engine before the
runtime planner takes over, or instead of it, for a frozen deployment.
``--device`` defaults to ``cuda``; the card's plans use the CUDA kernels
with ``--pallas``.
"""
import argparse
import json
import os

import numpy as np

from repro_torch.core import planner as qp
from repro_torch.core import records as R
from repro_torch.core.channel import most_threatening_tweets, tweets_about_drugs
from repro_torch.core.engine import BADEngine
from repro_torch.data.synthetic import drug_tweak, tweet_arrays


def build_engine(rng, n_subs: int, n_tweets: int, match: float,
                 use_pallas: bool, device: str = "cuda") -> BADEngine:
    """Two param-join channels with opposed selectivities (one wants the
    BAD index, one a window scan); the reference CLI's draws."""
    eng = BADEngine(brokers=("BrokerA", "BrokerB"), use_pallas=use_pallas,
                    device=device)
    eng.create_channel(tweets_about_drugs())
    eng.create_channel(most_threatening_tweets())
    for name in eng.channels:
        eng.subscribe_bulk(
            name, rng.integers(0, 50, n_subs).astype(np.int32),
            rng.integers(0, 2, n_subs).astype(np.int32))
    fields, loc = tweet_arrays(rng, n_tweets, 1)
    fields = drug_tweak(fields, rng, match)
    eng.ingest(R.RecordBatch.from_numpy(fields, loc, device=device))
    return eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--subs", type=int, default=2000)
    ap.add_argument("--tweets", type=int, default=4096)
    ap.add_argument("--match", type=float, default=0.05)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pallas", action="store_true",
                    help="the CUDA-kernel backends (pallas family)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/plan_search")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    eng = build_engine(rng, args.subs, args.tweets, args.match, args.pallas,
                       args.device)
    res = qp.search_plans(eng, repeats=args.repeats)
    os.makedirs(args.out, exist_ok=True)
    raw = os.path.join(args.out, "search.json")
    with open(raw, "w") as f:
        json.dump(res, f, indent=2, sort_keys=True)
    best = {n: qp.ChannelPlan.from_dict(r["best"]) for n, r in res.items()}
    plan_file = os.path.join(args.out, "plans.json")
    qp.save_plans(plan_file, best,
                  meta=dict(subs=args.subs, tweets=args.tweets,
                            match=args.match, seed=args.seed,
                            device=args.device))
    for name, r in res.items():
        worst = r["candidates"][-1]
        print(f"{name}: best={r['best']} "
              f"({r['candidates'][0]['wall_s'] * 1e3:.2f} ms) "
              f"worst={worst['plan']} ({worst['wall_s'] * 1e3:.2f} ms)")
    print(f"wrote {raw} and {plan_file}")


if __name__ == "__main__":
    main()
