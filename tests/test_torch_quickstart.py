"""The torch quickstart prints what the reference quickstart prints, on the
same seed, with both run in-process at the quickstart's own small size; its
README tour (``execute_all(..., deliver=True)`` then ``drain_spilled()``)
prints what the same calls print on the reference engine. The torch
crime-alerts example prints the reference example's counts."""
import importlib.util
import pathlib

import pytest

pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_tour(twin):
    """The twin's tour on the reference engine, built by the same calls."""
    import numpy as np
    from repro.core import records as R
    from repro.core.channel import tweets_about_drugs
    from repro.core.engine import BADEngine
    from repro.core.plans import ExecutionFlags
    from repro.data.synthetic import drug_tweak, tweet_batch

    rng = np.random.default_rng(0)
    batch = tweet_batch(rng, 4096, t0=1)
    fields = drug_tweak(np.asarray(batch.fields).copy(), rng, 0.05)
    eng = BADEngine(dataset_capacity=1 << 14, index_capacity=1 << 13,
                    max_window=1 << 13, max_candidates=1 << 10,
                    brokers=("BrokerA", "BrokerB"), max_notify=8,
                    ring_capacity=4)
    eng.create_channel(tweets_about_drugs())
    for state, broker in twin.SUBSCRIPTIONS:
        eng.subscribe("TweetsAboutDrugs", state, broker)
    eng.ingest(R.RecordBatch.from_numpy(fields, np.asarray(batch.location)))
    twin.tour(eng, ExecutionFlags.fully_optimized())


def test_quickstart_twin_prints_the_same_counts(capsys):
    twin = _load("quickstart_torch")
    _load("quickstart").main()
    _reference_tour(twin)
    want = capsys.readouterr().out
    twin.main(device="cpu")
    got = capsys.readouterr().out
    assert "subscribers notified" in want
    assert "drain_spilled round 1" in want
    assert got == want


def test_crime_alerts_twin_prints_the_same_counts(capsys):
    """``examples/crime_alerts_torch.py`` on the CPU prints the reference
    script's lines, wall times aside."""
    import re

    def counts(text):
        return re.sub(r"wall=[0-9.]+ms", "wall=", text)

    _load("crime_alerts").main()
    want = capsys.readouterr().out
    _load("crime_alerts_torch").main(device="cpu")
    got = capsys.readouterr().out
    assert "alerts=" in want and counts(got) == counts(want)
