"""Quickstart on the PyTorch port: create a channel, subscribe, ingest tweets,
execute, deliver. The twin of ``examples/quickstart.py`` (on the same seed it
prints the same counts), followed by the README's tour: the fused
``execute_all(fully_optimized(), deliver=True)`` under delivery caps that
overflow, then ``drain_spilled()`` until the spill queue is empty.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import records as R
from repro_torch.core.channel import tweets_about_drugs
from repro_torch.core.engine import BADEngine
from repro_torch.core.plans import ExecutionFlags
from repro_torch.data.synthetic import drug_tweak, tweet_arrays

SUBSCRIPTIONS = [(4, "BrokerA"), (4, "BrokerA"), (4, "BrokerB"),
                 (27, "BrokerA")]


def _engine(device: str) -> BADEngine:
    return BADEngine(dataset_capacity=1 << 14, index_capacity=1 << 13,
                     max_window=1 << 13, max_candidates=1 << 10,
                     brokers=("BrokerA", "BrokerB"), device=device)


def main(device: str = "cuda") -> None:
    rng = np.random.default_rng(0)
    eng = _engine(device)

    # Developer: CREATE CONTINUOUS PUSH CHANNEL TweetsAboutDrugs(MyState)
    eng.create_channel(tweets_about_drugs())

    # Subscribers: SUBSCRIBE TO TweetsAboutDrugs("CA") ON BrokerA; ...
    for state, broker in SUBSCRIPTIONS:
        sid = eng.subscribe("TweetsAboutDrugs", state, broker)
        print(f"subscribed sid={sid} state={state} via {broker}")

    # Data feed: one period of tweets (fixed predicates are evaluated at
    # ingestion; matching PKs land in the channel's BAD index).
    fields, location = tweet_arrays(rng, 4096, t0=1)
    fields = drug_tweak(fields, rng, 0.05)
    eng.ingest(R.RecordBatch.from_numpy(fields, location, device=device))

    # Channel execution under the fully optimized plan.
    rep = eng.execute_channel("TweetsAboutDrugs",
                              ExecutionFlags.fully_optimized())
    print(f"\nresults (group records): {rep.num_results}")
    print(f"subscribers notified:    {rep.num_notified}")
    print(f"records scanned:         {rep.scanned} (BAD index window)")
    print(f"bytes to brokers:        {rep.broker_bytes.tolist()}")

    # Compare against the original (pre-optimization) plan.
    eng2 = _engine(device)
    eng2.create_channel(tweets_about_drugs())
    for state, broker in SUBSCRIPTIONS:
        eng2.subscribe("TweetsAboutDrugs", state, broker)
    eng2.ingest(R.RecordBatch.from_numpy(fields, location, device=device))
    rep0 = eng2.execute_channel("TweetsAboutDrugs", ExecutionFlags.original())
    print(f"\noriginal plan: scanned={rep0.scanned} results={rep0.num_results} "
          f"(same {rep0.num_notified} notified)")

    # The README's tour: every channel in one fused call with broker
    # delivery, on an engine whose notify buffer holds 8 subscribers, then
    # the spilled notifications re-delivered exactly once.
    eng3 = BADEngine(dataset_capacity=1 << 14, index_capacity=1 << 13,
                     max_window=1 << 13, max_candidates=1 << 10,
                     brokers=("BrokerA", "BrokerB"), max_notify=8,
                     ring_capacity=4, device=device)
    eng3.create_channel(tweets_about_drugs())
    for state, broker in SUBSCRIPTIONS:
        eng3.subscribe("TweetsAboutDrugs", state, broker)
    eng3.ingest(R.RecordBatch.from_numpy(fields, location, device=device))
    tour(eng3, ExecutionFlags.fully_optimized())


def tour(eng, flags) -> None:
    """``execute_all(flags, deliver=True)``, a ring flush, then
    ``drain_spilled()`` until the queue is empty, printing the delivery
    accounting (delivered + spilled + dropped == produced, per stage)."""
    rep = eng.execute_all(flags, deliver=True)["TweetsAboutDrugs"]
    s = rep.overflow
    print(f"\nexecute_all: {rep.num_results} results, {rep.num_notified} "
          f"notified; sIDs delivered {s.delivered_sids}, spilled "
          f"{s.spilled_sids}, dropped {s.dropped_sids}")
    eng.flush_rings()
    rounds = 0
    while eng.spill.pending_pairs() + eng.spill.pending_sids():
        drained = eng.drain_spilled()["TweetsAboutDrugs"].stats
        rounds += 1
        print(f"drain_spilled round {rounds}: re-delivered "
              f"{drained.delivered_sids} sIDs, {eng.spill.pending_sids()} "
              f"still queued")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default) or 'cpu'")
    main(ap.parse_args().device)
