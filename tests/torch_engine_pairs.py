"""Engine pairs for the fused-path parity tests (tests/test_torch_fused*.py,
tests/test_torch_join_compact.py): the same engine built in the reference
and the port by the same calls, tick data fed to both, and exact
comparisons of reports, rings, queues, drains and stream buckets."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import channel as jch  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core.engine import BADEngine as JEngine  # noqa: E402
from repro.core.plans import ChannelPlan as JPlan  # noqa: E402,F401
from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro.core.plans import ExecutionRequest as JRequest  # noqa: E402
from repro.data.synthetic import drug_tweak, tweet_batch  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.core.engine import BADEngine as TEngine  # noqa: E402
from repro_torch.core.plans import ChannelPlan as TPlan  # noqa: E402,F401
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402
from repro_torch.core.plans import ExecutionRequest as TRequest  # noqa: E402

from repro_torch.core.broker import payload_notifications  # noqa: E402
from repro_torch.data.synthetic import drug_tweak as t_drug_tweak  # noqa: E402
from repro_torch.data.synthetic import tweet_arrays  # noqa: E402

from torch_parity import (assert_same, assert_same_tuple,  # noqa: E402,F401
                          stats_tuple, to_np)

SCANS = ("full", "window", "trad_index", "bad_index")
BACKENDS = ("oracle", "pallas", "compact", "compact_pallas")
PARAM = ("TweetsAboutDrugs", "MostThreateningTweets")
CAPS = dict(max_deliver_pairs=24, max_notify=90, max_spill=12,
            spill_capacity=150, group_cap=8, ring_capacity=16)


def _engines(seed, incremental=True, **kw):
    """(reference, port, rng): two param channels and a spatial one, the
    same subscriptions and users (on a 0.5 grid, where every distance form
    is exact in float32)."""
    rng = np.random.default_rng(seed)
    common = dict(dataset_capacity=1024, index_capacity=512, max_window=512,
                  max_candidates=128, brokers=("B1", "B2"),
                  incremental=incremental, **CAPS)
    common.update(kw)
    je, te = JEngine(**common), TEngine(device="cpu", **common)
    for lib, eng in ((jch, je), (tch, te)):
        eng.create_channel(lib.tweets_about_drugs())
        eng.create_channel(lib.most_threatening_tweets())
        eng.create_channel(lib.tweets_about_crime(3))
    for name in PARAM:
        p, b = rng.integers(0, 50, 200), rng.integers(0, 2, 200)
        assert_same(je.subscribe_bulk(name, p, b), te.subscribe_bulk(name, p, b))
    users = (np.round(rng.normal(size=(24, 2)) * 60) / 2).astype(np.float32)
    ub = rng.integers(0, 2, 24)
    je.set_user_locations(users, ub)
    te.set_user_locations(users, ub)
    return je, te, rng


def _ingest(je, te, rng, n, t0, match=0.2, also=()):
    """One batch into both engines, and into the reference engines
    ``also``."""
    b = tweet_batch(rng, n, t0)
    f = drug_tweak(np.asarray(b.fields).copy(), rng, match)
    loc = (np.round(np.asarray(b.location) * 2) / 2).astype(np.float32)
    for eng in (je, *also):
        eng.ingest(JR.RecordBatch.from_numpy(f, loc))
    te.ingest(TR.RecordBatch.from_numpy(f, loc, device="cpu"))


def _assert_reports(a, b, tag, deliver=False):
    assert list(a) == list(b), tag
    for name in a:
        x, y = a[name], b[name]
        t = f"{tag} {name}"
        assert_same_tuple(x.result, y.result, t)
        assert (x.num_results, x.num_notified, x.scanned) == \
            (y.num_results, y.num_notified, y.scanned), t
        assert_same(x.broker_bytes, y.broker_bytes, f"{t} broker_bytes")
        assert x.plan.to_dict() == y.plan.to_dict(), t
        if deliver:
            assert stats_tuple(x.overflow) == stats_tuple(y.overflow), t
            assert x.payload is None or np.array_equal(x.payload, y.payload)
            assert x.notify is None or np.array_equal(x.notify, y.notify)


def _spill_view(q):
    pairs = {k: [(r.tolist(), t.tolist(), v) for r, t, v in d]
             for k, d in q._pairs.items()}
    sids = {k: [s.tolist() for s in d] for k, d in q._sids.items()}
    return pairs, sids, q.pending_pairs(), q.pending_sids()


def _assert_queues(je, te, tag):
    assert _spill_view(je.spill) == _spill_view(te.spill), f"{tag} spill"
    assert je.ring_pending_pairs() == te.ring_pending_pairs(), tag
    assert je.ring_pending_sids() == te.ring_pending_sids(), tag
    assert je.ring_flush_drops == te.ring_flush_drops, tag


def _drain_round(je, te, tag):
    """One ``drain_spilled`` round on both engines: equal reports (stats and
    re-packed buffers) and queues."""
    a, b = je.drain_spilled(), te.drain_spilled()
    assert list(a) == list(b), tag
    for name in a:
        assert stats_tuple(a[name].stats) == stats_tuple(b[name].stats), tag
        for k in ("payload", "notify"):
            x, y = getattr(a[name], k), getattr(b[name], k)
            assert (x is None) == (y is None), (tag, name, k)
            if x is not None:
                assert_same(x, y, f"{tag} {name} {k}")
    _assert_queues(je, te, tag)


def _drain_until_empty(je, te, tag, rounds=12):
    for r in range(rounds):
        _drain_round(je, te, f"{tag} drain {r}")
        if je.spill.pending_pairs() + je.spill.pending_sids() == 0:
            return
    raise AssertionError(f"{tag}: queues not empty after {rounds} rounds")


def _norm(x):
    """A stream-bucket key part of either package as plain values."""
    if hasattr(x, "to_dict"):
        return tuple(sorted(x.to_dict().items()))
    if hasattr(x, "scan_mode"):
        return (x.scan_mode, x.aggregation, x.param_pushdown)
    return x


def _buckets(eng):
    return {tuple(_norm(p) for p in k): v
            for k, v in eng._stream_buckets.items()}


def check_every_scan_layout_backend(incremental):
    """One tick's data, every scan mode x layout x backend under explicit
    plans (one engine pair: the reference compiles each plan once, which is
    what this test spends its time on, so the tick stays under the compact
    stream's floor and no plan compiles twice): the reports equal the
    reference's, pair grids and dtypes included, and every backend of a
    plan notifies the same subscribers."""
    je, te, rng = _engines(10, incremental, dataset_capacity=256,
                           index_capacity=128, max_window=128,
                           max_candidates=64)
    _ingest(je, te, rng, 120, 1)
    for scan in SCANS:
        for agg in (False, True):
            seen = set()
            for backend in BACKENDS:
                req = dict(backend=backend, advance=False)
                a = je.execute(JRequest(flags=JFlags(scan, agg, agg), **req))
                b = te.execute(TRequest(flags=TFlags(scan, agg, agg), **req))
                _assert_reports(a, b, (scan, agg, backend))
                seen.add(tuple((n, r.num_notified) for n, r in b.items()))
            assert len(seen) == 1, (scan, agg, seen)
            assert b["TweetsAboutCrime3"].num_results > 0


# the ChurnReport fields the churn parity tests compare
COUNTERS = ("ticks", "adds", "removes", "user_adds", "user_removes",
            "live_subs", "results", "delivered_pairs", "delivered_sids",
            "spilled", "dropped", "drain_calls", "ring_pending",
            "queue_pending", "pipeline_depth")


def _batcher(records, loc_of):
    """A make_batch for either package drawing ``tweet_arrays`` (the
    reference generator's draws) on the 0.5 grid where every spatial
    distance is exact in float32."""
    def make(r, n, t0):
        f, loc = tweet_arrays(r, n, t0)
        f = t_drug_tweak(f, r, 0.3)
        loc = (np.round(loc * 2) / 2).astype(np.float32)
        return loc_of(records, f, loc)
    return make


def _collect(sink, pw=8):
    """(on_tick, on_drain) folding delivered content into (channel, row,
    sID) pair and (channel, sID) multisets."""
    def lines(name, payload, n):
        return [(name,) + tuple(x) for x in payload_notifications(
            to_np(payload), n, pw).tolist()]

    def on_tick(tick, reports):
        for name, rep in reports.items():
            o = rep.overflow
            sink["pairs"] += lines(name, rep.payload, o.delivered_pairs)
            sink["sids"] += [(name, s) for s in
                             to_np(rep.notify)[:o.delivered_sids].tolist()]

    def on_drain(drained):
        for name, dr in drained.items():
            if dr.payload is not None and dr.stats.delivered_pairs:
                sink["pairs"] += lines(name, dr.payload,
                                       dr.stats.delivered_pairs)
            if dr.notify is not None and dr.stats.delivered_sids:
                sink["sids"] += [(name, s) for s in to_np(dr.notify)[
                    :dr.stats.delivered_sids].tolist()]
    return on_tick, on_drain

