"""Port parity for the slice as a whole: the same engine built in both
packages by the same calls, driven through the paper's seven plans on both
kernel backends with delivery under caps that overflow, across ticks, and
continued from the reference's state after a ring wraparound."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import channel as jch  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core.engine import BADEngine as JEngine  # noqa: E402
from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro.data.synthetic import drug_tweak, tweet_batch  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import interop  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.core.engine import BADEngine as TEngine  # noqa: E402
from repro_torch.core import plans as TPlans  # noqa: E402
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402

from torch_parity import (assert_same, assert_same_tuple,  # noqa: E402
                          stats_tuple, to_np)

PLANS = [("full", False, False), ("window", False, False),
         ("trad_index", False, False), ("bad_index", False, False),
         ("bad_index", True, False), ("bad_index", True, True),
         ("window", True, True)]          # tests/test_system.py ALL_PLANS
CAPS = dict(max_deliver_pairs=48, max_notify=200, max_spill=24,
            spill_capacity=300, group_cap=8)


def _engines(seed, use_pallas, **kw):
    """(reference, port, rng): the same channels, subscriptions and users."""
    rng = np.random.default_rng(seed)
    common = dict(dataset_capacity=2048, index_capacity=1024, max_window=1024,
                  max_candidates=256, brokers=("B1", "B2"),
                  use_pallas=use_pallas, **CAPS)
    common.update(kw)
    je, te = JEngine(**common), TEngine(device="cpu", **common)
    for lib, eng in ((jch, je), (tch, te)):
        eng.create_channel(lib.tweets_about_drugs())
        eng.create_channel(lib.most_threatening_tweets())
        eng.create_channel(lib.tweets_about_crime(3))
    for name in ("TweetsAboutDrugs", "MostThreateningTweets"):
        p, b = rng.integers(0, 50, 300), rng.integers(0, 2, 300)
        assert_same(je.subscribe_bulk(name, p, b), te.subscribe_bulk(name, p, b))
    users = (np.round(rng.normal(size=(40, 2)) * 60) / 2).astype(np.float32)
    ub = rng.integers(0, 2, 40)
    je.set_user_locations(users, ub)
    te.set_user_locations(users, ub)
    return je, te, rng


def _ingest(je, te, rng, n, t0):
    b = tweet_batch(rng, n, t0)
    f = drug_tweak(np.asarray(b.fields).copy(), rng, 0.1)
    # a 0.5 grid keeps every spatial distance exact in float32
    loc = (np.round(np.asarray(b.location) * 2) / 2).astype(np.float32)
    assert_same(je.ingest(JR.RecordBatch.from_numpy(f, loc)),
                te.ingest(TR.RecordBatch.from_numpy(f, loc, device="cpu")))


def _spill_view(q):
    pairs = {k: [(r.tolist(), t.tolist(), v) for r, t, v in d]
             for k, d in q._pairs.items()}
    sids = {k: [s.tolist() for s in d] for k, d in q._sids.items()}
    return pairs, sids, q.pending_pairs(), q.pending_sids()


def _assert_engines(je, te, tag):
    for k in ("fields", "location", "size"):
        assert_same(getattr(je.dataset, k), getattr(te.dataset, k), f"{tag} {k}")
    for k in ("row_ids", "counts", "watermarks", "overflowed"):
        assert_same(getattr(je.index_state, k), getattr(te.index_state, k),
                    f"{tag} index.{k}")
    assert (je.now, je.size_host) == (te.now, te.size_host)
    assert _spill_view(je.spill) == _spill_view(te.spill), f"{tag} spill"


def _assert_reports(a, b, tag):
    assert_same_tuple(a.result, b.result, tag)
    assert (a.num_results, a.num_notified, a.scanned) == \
        (b.num_results, b.num_notified, b.scanned), tag
    assert_same(a.broker_bytes, b.broker_bytes, f"{tag} broker_bytes")
    assert stats_tuple(a.overflow) == stats_tuple(b.overflow), tag


@pytest.mark.parametrize("backend", ["oracle", "pallas"])
def test_seven_plans_with_overflowing_delivery(backend):
    je, te, rng = _engines(0, backend == "pallas")
    _ingest(je, te, rng, 1024, 1)
    _assert_engines(je, te, "ingest")
    dropped = 0
    for name in ("TweetsAboutDrugs", "MostThreateningTweets",
                 "TweetsAboutCrime3"):
        for plan in PLANS:
            a = je.execute_channel(name, JFlags(*plan), advance=False,
                                   deliver=True)
            b = te.execute_channel(name, TFlags(*plan), advance=False,
                                   deliver=True)
            _assert_reports(a, b, f"{name} {plan}")
            dropped += b.overflow.dropped_pairs + b.overflow.dropped_sids
        _assert_engines(je, te, name)
    assert dropped > 0                    # the caps and the queue overflowed


@pytest.mark.parametrize("backend", ["oracle", "pallas"])
def test_ticks_advance_watermarks_across_wraparound(backend):
    je, te, rng = _engines(1, backend == "pallas")
    flags = [("bad_index", True, True), ("window", False, True),
             ("bad_index", False, False)]
    for tick in range(4):                 # 4 x 700 rows wrap the 2048 ring
        _ingest(je, te, rng, 700, 1 + 1000 * tick)
        for name, plan in zip(("TweetsAboutDrugs", "MostThreateningTweets",
                               "TweetsAboutCrime3"), flags):
            a = je.execute_channel(name, JFlags(*plan), deliver=True)
            b = te.execute_channel(name, TFlags(*plan), deliver=True)
            _assert_reports(a, b, f"tick {tick} {name}")
            sj, st = je.channels[name], te.channels[name]
            assert (sj.last_exec_ts, sj.last_exec_size, sj.executions) == \
                (st.last_exec_ts, st.last_exec_size, st.executions)
        _assert_engines(je, te, f"tick {tick}")
    again = te.execute_channel("TweetsAboutDrugs", TFlags("bad_index"))
    assert again.num_results == 0         # nothing new since the watermark


def test_state_from_numpy_after_wraparound():
    """Start the port from the reference's device state (after the ring
    wrapped) and continue both engines tick for tick."""
    je, te, rng = _engines(2, True)
    for tick in range(4):
        b = tweet_batch(rng, 700, 1 + 1000 * tick)
        f = drug_tweak(np.asarray(b.fields).copy(), rng, 0.1)
        loc = (np.round(np.asarray(b.location) * 2) / 2).astype(np.float32)
        je.ingest(JR.RecordBatch.from_numpy(f, loc))
        for name in ("TweetsAboutDrugs", "TweetsAboutCrime3"):
            je.execute_channel(name, JFlags.fully_optimized())
    ds, ix = je.dataset, je.index_state
    # host copies now: the reference's next ingest donates these buffers
    arrays = [to_np(a).copy() for a in (ds.fields, ds.location, ds.size,
                                        ix.row_ids, ix.counts, ix.watermarks,
                                        ix.overflowed)]
    dataset, index = interop.state_from_numpy(*arrays, device="cpu")
    interop.load_engine_state(
        te, dataset, index, now=je.now,
        marks={n: (s.last_exec_ts, s.last_exec_size, s.executions)
               for n, s in je.channels.items()})
    _assert_engines(je, te, "carried")
    for tick in range(4, 6):
        _ingest(je, te, rng, 700, 1 + 1000 * tick)
        for name in ("TweetsAboutDrugs", "MostThreateningTweets",
                     "TweetsAboutCrime3"):
            a = je.execute_channel(name, JFlags.fully_optimized(), deliver=True)
            b = te.execute_channel(name, TFlags.fully_optimized(), deliver=True)
            _assert_reports(a, b, f"tick {tick} {name}")
        _assert_engines(je, te, f"tick {tick}")
    with pytest.raises(ValueError):
        interop.state_from_numpy(arrays[0].astype(np.int64), *arrays[1:],
                                 device="cpu")


def test_control_plane_churn_and_drop_channel():
    je, te, rng = _engines(3, False)
    sid = je.subscribe("TweetsAboutDrugs", 7, "B2")
    assert te.subscribe("TweetsAboutDrugs", 7, "B2") == sid
    assert je.unsubscribe("TweetsAboutDrugs", 7, "B2", sid) \
        == te.unsubscribe("TweetsAboutDrugs", 7, "B2", sid) is True
    gone = np.arange(0, 300, 3)
    assert je.remove_subscriptions("MostThreateningTweets", gone) == \
        te.remove_subscriptions("MostThreateningTweets", gone)
    _ingest(je, te, rng, 600, 1)
    je.drop_channel("MostThreateningTweets")
    te.drop_channel("MostThreateningTweets")
    _assert_engines(je, te, "drop")
    _ingest(je, te, rng, 600, 500)
    for name in ("TweetsAboutDrugs", "TweetsAboutCrime3"):
        for plan in (PLANS[0], PLANS[5]):
            _assert_reports(
                je.execute_channel(name, JFlags(*plan), deliver=True),
                te.execute_channel(name, TFlags(*plan), deliver=True), name)
    st_j, st_t = je.channels["TweetsAboutDrugs"], te.channels["TweetsAboutDrugs"]
    assert st_j.epoch == st_t.epoch
    assert_same(je.group_sids_array("TweetsAboutDrugs", False),
                te.group_sids_array("TweetsAboutDrugs", False))


def test_device_rule_and_paths_not_ported_yet():
    """The device rule holds, and the paths a later slice ported (cohorts,
    the dispatch/sync split, the resolved spill lane) run on a CPU engine
    (tests/test_torch_churn.py and test_torch_runtime.py hold them to the
    reference)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TEngine()
    eng = TEngine(dataset_capacity=64, index_capacity=16, device="cpu")
    eng.create_channel(tch.tweets_about_crime(1))
    assert eng.dispatch(TPlans.ExecutionRequest()).sync().keys() == \
        {"TweetsAboutCrime1"}
    assert set(eng.dispatch_all(deliver=True).sync()) == {"TweetsAboutCrime1"}
    assert set(eng.execute(TPlans.ExecutionRequest(
        deliver=True, resolve_spills=True))) == {"TweetsAboutCrime1"}
    assert eng.subscribe_users("TweetsAboutCrime1", [0]) == 1
    assert eng.unsubscribe_users("TweetsAboutCrime1", [0]) == 1
    # the enrichment stage is ported: a non-stage is refused as in the
    # reference (tests/test_torch_enrich.py holds the rest)
    with pytest.raises(TypeError, match="EnrichmentStage"):
        eng.set_enrichment(object())
    with pytest.raises(ValueError, match="engine on cpu"):
        eng.ingest(TR.RecordBatch.from_numpy(np.zeros((1, 10), np.int32),
                                             device="meta"))
    with pytest.raises(ValueError, match="from_numpy"):
        eng.ingest(TR.RecordBatch(torch.zeros((1, 10), dtype=torch.int32),
                                  torch.zeros((1, 2))))
    # the fused slice's paths run
    assert set(eng.execute_all(deliver=True)) == {"TweetsAboutCrime1"}
    assert eng.execute_channel("TweetsAboutCrime1", TFlags(),
                               backend="compact").num_results == 0
    assert eng.drain_spilled() == {}
    eng.flush_rings()
