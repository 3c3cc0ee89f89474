"""Engine pairs for the enrichment parity tests (tests/test_torch_enrich*.py):
the reference test's engine built in both packages by the same calls, the
same stage on both, tick data fed to both, and the delivered view that the
comparisons read."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import channel as jch  # noqa: E402
from repro.core import enrich as jen  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core.broker import payload_notifications  # noqa: E402
from repro.core.engine import BADEngine as JEngine  # noqa: E402
from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro.data.synthetic import drug_tweak, tweet_batch  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import enrich as ten  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.core.engine import BADEngine as TEngine  # noqa: E402
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402

from torch_parity import stats_tuple  # noqa: E402

PW = 8    # engine default deliver_payload_words
AGG = (("window", True, True), ("window", False, False))


def _stage(lib, kind, budget):
    return None if kind is None else getattr(lib, kind)(budget=budget)


def _pair(seed=0, stage=None, budget=None, **kw):
    """(reference, port, rng): the reference test's engine, two param
    channels with 200 subscriptions each, the same stage on both (``stage``
    names the scorer class) and 192 tweets ingested."""
    rng = np.random.default_rng(seed)
    kw.setdefault("max_deliver_pairs", 256)
    kw.setdefault("max_notify", 512)
    kw.setdefault("ring_capacity", 0)
    common = dict(dataset_capacity=4096, index_capacity=1024,
                  max_window=2048, max_candidates=512, brokers=("B1", "B2"),
                  group_cap=8, **kw)
    je, te = JEngine(**common), TEngine(device="cpu", **common)
    for lib, eng in ((jch, je), (tch, te)):
        eng.debug_delivery_buffers = True
        eng.create_channel(lib.tweets_about_drugs())
        eng.create_channel(lib.most_threatening_tweets())
    for name in ("TweetsAboutDrugs", "MostThreateningTweets"):
        p, b = rng.integers(0, 50, 200), rng.integers(0, 2, 200)
        je.subscribe_bulk(name, p, b)
        te.subscribe_bulk(name, p, b)
    if stage is not None:
        je.set_enrichment(_stage(jen, stage, budget))
        te.set_enrichment(_stage(ten, stage, budget))
    _ingest((je, te), rng, 192, 1, 0.3)
    return je, te, rng


def _ingest(engines, rng, n, t0, match):
    """The same tweets into every engine (reference or port)."""
    b = tweet_batch(rng, n, t0)
    f = drug_tweak(np.asarray(b.fields).copy(), rng, match)
    loc = np.asarray(b.location)
    for eng in engines:
        eng.ingest(JR.RecordBatch.from_numpy(f, loc) if isinstance(
            eng, JEngine) else TR.RecordBatch.from_numpy(f, loc, device="cpu"))


def _delivered(reports):
    """Per channel: ((row, sID) multiset, sID multiset, stats tuple)."""
    out = {}
    for name, rep in reports.items():
        o = rep.overflow
        pairs = sorted(map(tuple, payload_notifications(
            np.asarray(rep.payload), o.delivered_pairs, PW).tolist()))
        sids = sorted(np.asarray(rep.notify)[:o.delivered_sids].tolist())
        out[name] = (pairs, sids, stats_tuple(o))
    return out


def _delivered_ordered(reports):
    return {name: list(map(tuple, payload_notifications(
        np.asarray(rep.payload), rep.overflow.delivered_pairs, PW).tolist()))
        for name, rep in reports.items()}


def _both(je, te, flags=None, **kw):
    """One fused execution with delivery on both engines (``flags`` a
    (scan, agg, pushdown) triple, or None for the assigned plans)."""
    jf = None if flags is None else JFlags(*flags)
    tf = None if flags is None else TFlags(*flags)
    return (je.execute_all(jf, deliver=True, **kw),
            te.execute_all(tf, deliver=True, **kw))
