"""A model in the delivery loop, on the PyTorch port: the twin of
``examples/enriched_pipeline.py``.

Raw tweets flow through ingestion-time BAD indexing and channel execution;
then an LM (``core/enrich.LMScorer``: one batched prefill per join group
through ``launch/serve.prefill_scores``, on the card with the hand-written
``flash_attention`` kernel) scores every candidate record between the join
and broker delivery, and the per-channel budget keeps the top-scored pairs.

    PYTHONPATH=src python examples/enriched_pipeline_torch.py          # card
    PYTHONPATH=src python examples/enriched_pipeline_torch.py --device cpu

The LM is reduced qwen2-1.5b, as in the reference's example
(``chip_smoke.py`` runs the full-width one); ``--heuristic`` swaps the LM
for the urgency scorer; ``--budget 0`` detaches ranking.
"""
import argparse
import time

import numpy as np

from repro_torch.core import enrich
from repro_torch.core import records as R
from repro_torch.core.channel import most_threatening_tweets, tweets_about_drugs
from repro_torch.core.engine import BADEngine
from repro_torch.core.plans import ExecutionRequest
from repro_torch.data.synthetic import tweet_arrays
from repro_torch.models.model import ModelApi


def build_stage(budget, heuristic=False, device="cuda"):
    """The enrichment stage: a reduced-LM scorer (one batched prefill per
    join group over the candidates) or the heuristic payload scorer."""
    if heuristic:
        return enrich.HeuristicScorer(budget=budget)
    stage = enrich.LMScorer(budget=budget, device=device)
    n = ModelApi(stage.cfg).param_count()
    print(f"enrichment model {stage.cfg.name}-reduced ({n:,} params)")
    return stage


def run(periods=3, batch=2048, budget=64, heuristic=False, n_subs=2000,
        capacity=1 << 15, device="cuda"):
    """Drive ``periods`` enriched ticks; returns the per-period reports."""
    rng = np.random.default_rng(0)
    eng = BADEngine(dataset_capacity=capacity, index_capacity=capacity // 2,
                    max_window=capacity // 2,
                    max_candidates=max(256, capacity >> 4),
                    brokers=("BrokerA", "BrokerB"), device=device)
    eng.create_channel(tweets_about_drugs())
    eng.create_channel(most_threatening_tweets())
    params, brokers = (rng.integers(0, 50, n_subs).astype(np.int32),
                       rng.integers(0, 2, n_subs).astype(np.int32))
    eng.subscribe_bulk("TweetsAboutDrugs", params, brokers)
    eng.subscribe_bulk("MostThreateningTweets", params, brokers)
    if budget:
        eng.set_enrichment(build_stage(budget, heuristic, device))
    print(f"2 channels, {2 * n_subs} subscriptions, "
          f"budget={budget or 'off'} "
          f"scorer={'heuristic' if heuristic or not budget else 'lm'}")

    out = []
    for period in range(periods):
        # 1. raw feed -> 2. ingestion: conditionsList eval + BAD indexing
        fields, location = tweet_arrays(rng, batch, t0=1 + period * 600)
        eng.ingest(R.RecordBatch.from_numpy(fields, location, device=device))
        # 3. one fused tick: discovery, join, scoring + budget rank, fan-out
        t0 = time.perf_counter()
        reports = eng.execute(ExecutionRequest(deliver=True, timed=True))
        wall = time.perf_counter() - t0
        for chan, rep in reports.items():
            o = rep.overflow
            print(f"period {period} {chan}: matched={rep.scanned} "
                  f"groups={rep.num_results} notified={rep.num_notified} "
                  f"delivered={o.delivered_pairs} ranked_out={o.ranked_pairs} "
                  f"tick={wall * 1e3:.1f}ms")
        out.append(reports)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--periods", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--budget", type=int, default=64,
                    help="per-channel delivered-pair budget (0 = no ranking)")
    ap.add_argument("--heuristic", action="store_true",
                    help="use the urgency scorer instead of the LM")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(args.periods, args.batch, args.budget, args.heuristic,
        device=args.device)


if __name__ == "__main__":
    main()
