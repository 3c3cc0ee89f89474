"""Port parity for the enrichment stage (``repro_torch/core/enrich.py`` and
the engine's ranked branch) against the reference's ``repro/core/enrich.py``:
the non-sharded, non-pipelined tests of ``tests/test_enrich.py``, each run
on both packages with the same calls and data and held equal exactly
(delivered multisets, every ``DeliveryStats`` field, queues, dtypes), plus
``rank_result`` itself on crafted ties and the port's example on the CPU."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import channel as jch  # noqa: E402
from repro.core import enrich as jen  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core.broker import payload_notifications  # noqa: E402
from repro.core.engine import BADEngine as JEngine  # noqa: E402
from repro.core.plans import ChannelPlan as JPlan  # noqa: E402
from repro.core.plans import ChannelResult as JResult  # noqa: E402
from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro.data.synthetic import tweet_batch  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import enrich as ten  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.core.engine import BADEngine as TEngine  # noqa: E402
from repro_torch.core.plans import ChannelPlan as TPlan  # noqa: E402
from repro_torch.core.plans import ChannelResult as TResult  # noqa: E402
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402

from conftest import check_delivery_conservation  # noqa: E402
from torch_engine_pairs import _assert_queues  # noqa: E402
from torch_enrich_pairs import (AGG, PW, _both, _delivered,  # noqa: E402
                                _delivered_ordered, _ingest, _pair, _stage)
from torch_parity import assert_same, stats_tuple  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("backend", ["oracle", "compact"],
                         ids=["padded", "compact"])
@pytest.mark.parametrize("flags", AGG, ids=["agg", "flat"])
@pytest.mark.parametrize("stage,budget", [("NoopScorer", None),
                                          ("NoopScorer", 100_000),
                                          ("HeuristicScorer", 100_000)],
                         ids=["noop-untagged", "noop-budget", "heur-budget"])
def test_noop_scorer_bit_parity(backend, flags, stage, budget):
    """Under-budget (or budget-less) stages: the port's delivery equals the
    reference's with the same stage, and equals the port's scorer-less
    engine, multisets and full DeliveryStats alike."""
    je, te, _ = _pair(stage=stage, budget=budget)
    _, base, _ = _pair()
    for eng, plan in ((je, JPlan), (te, TPlan), (base, TPlan)):
        for name in eng.channels:
            eng.set_plan(name, plan(*flags, backend))
    a, b = _both(je, te)
    want = _delivered(base.execute_all(None, deliver=True))
    assert _delivered(a) == _delivered(b) == want
    assert all(r.plan.scorer == te.enrichment.identity for r in b.values())


def test_budget_rank_drops_lowest():
    """Over budget, the delivered records are exactly the ``budget`` with
    the largest retweet counts (the only field that differs), on both
    packages."""
    out = []
    for lib, eng_cls, rec, en, flags, kw in (
            (jch, JEngine, JR, jen, JFlags, {}),
            (tch, TEngine, TR, ten, TFlags, dict(device="cpu"))):
        eng = eng_cls(dataset_capacity=4096, index_capacity=1024,
                      max_window=2048, max_candidates=512, brokers=("B1",),
                      group_cap=8, max_deliver_pairs=256, max_notify=512,
                      ring_capacity=0, **kw)
        eng.debug_delivery_buffers = True
        eng.create_channel(lib.most_threatening_tweets())
        eng.subscribe_bulk("MostThreateningTweets", np.zeros(1, np.int32),
                           np.zeros(1, np.int32))
        n = 24
        batch = tweet_batch(np.random.default_rng(3), n, 1)
        fields = np.asarray(batch.fields).copy()
        fields[:, JR.STATE] = 0
        fields[:, JR.THREATENING_RATE] = 10
        fields[:, [JR.HATE_SPEECH_RATE, JR.WEAPON_MENTIONED,
                   JR.DRUG_ACTIVITY]] = 0
        fields[:, JR.RETWEET_COUNT] = np.arange(n) * 100
        rows = eng.ingest(rec.RecordBatch.from_numpy(
            fields, np.asarray(batch.location), **kw))
        eng.set_enrichment(en.HeuristicScorer(budget=5))
        rep = eng.execute_all(flags("window", False, False),
                              deliver=True)["MostThreateningTweets"]
        o = rep.overflow
        assert rep.num_results == n and o.delivered_pairs == 5
        assert o.ranked_pairs == n - 5
        got = sorted(payload_notifications(
            np.asarray(rep.payload), o.delivered_pairs, PW)[:, 0].tolist())
        assert got == sorted(np.asarray(rows)[-5:].tolist())
        check_delivery_conservation(o, rep.num_results, rep.num_notified)
        out.append((got, stats_tuple(o)))
    assert out[0] == out[1]


def test_budget_rank_tie_determinism():
    """Constant scores and budget 9: the kept pairs are the scorer-less
    delivered prefix in ravel order, equal to the reference's, identical on
    a second run."""
    runs = []
    for _ in range(2):
        _, base, _ = _pair(seed=7)
        want = _delivered_ordered(base.execute_all(
            TFlags("window", False, False), deliver=True))
        je, te, _ = _pair(seed=7, stage="NoopScorer", budget=9)
        a, b = _both(je, te, ("window", False, False))
        got = _delivered_ordered(b)
        assert got == _delivered_ordered(a)
        for name in got:
            o = b[name].overflow
            assert o.delivered_pairs <= 9
            assert got[name] == want[name][:len(got[name])]
            if b[name].num_results > 9:
                assert o.ranked_pairs == b[name].num_results - 9
        runs.append(got)
    assert runs[0] == runs[1]


def test_conservation_with_ranked_drops_and_overflow():
    """Ranked drops under tight caps and a ring of 16, three ticks: every
    DeliveryStats field and the queues equal the reference's, conservation
    telescopes and ranked_* stays a subset of dropped_*."""
    je, te, _ = _pair(seed=5, stage="HeuristicScorer", budget=6,
                      max_deliver_pairs=4, max_notify=8, ring_capacity=16)
    for tick in range(3):
        rng = np.random.default_rng(te.now + 1)
        _ingest((je, te), rng, 96, te.now + 1, 0.3)
        a, b = _both(je, te, AGG[0])
        assert _delivered(a) == _delivered(b), tick
        _assert_queues(je, te, f"tick {tick}")
        for rep in b.values():
            o = rep.overflow
            check_delivery_conservation(o, rep.num_results, rep.num_notified)
            assert o.ranked_pairs <= o.dropped_pairs
            assert o.ranked_sids <= o.dropped_sids
            assert o.delivered_pairs <= min(6, 4)
    assert sum(r.overflow.ranked_pairs for r in b.values()) > 0


def test_detach_and_swap_stage():
    """The reference's test on both packages: after ``set_enrichment(None)``
    delivery equals a scorer-less engine's (multisets and stats); a
    non-stage is refused."""
    je, te, _ = _pair(seed=2, stage="HeuristicScorer", budget=3)
    _, base, _ = _pair(seed=2)
    a, b = _both(je, te, AGG[0])
    assert _delivered(a) == _delivered(b)
    base.execute_all(TFlags(*AGG[0]), deliver=True)
    assert je.set_enrichment(None) and te.set_enrichment(None)
    assert not te.set_enrichment(None)
    _ingest((je, te, base), np.random.default_rng(99), 64, te.now + 1, 0.1)
    a, b = _both(je, te, AGG[0])
    want = _delivered(base.execute_all(TFlags(*AGG[0]), deliver=True))
    assert _delivered(a) == _delivered(b) == want
    with pytest.raises(TypeError):
        te.set_enrichment(object())


def test_stage_switches_migrate_rings():
    """Attach, swap and detach under caps that overflow into rings of 16:
    each switch re-keys the executed plans, so the resident rings migrate
    through the flush path into the host queue; every tick's delivery,
    the queues and the ring counts equal the reference's."""
    je, te, _ = _pair(seed=2, max_deliver_pairs=6, max_notify=12,
                      ring_capacity=16)
    stages = [(None, None), ("HeuristicScorer", 3), ("NoopScorer", 4),
              (None, None)]
    for tick, (kind, budget) in enumerate(stages):
        assert je.set_enrichment(_stage(jen, kind, budget)) == \
            te.set_enrichment(_stage(ten, kind, budget)) == (tick > 0)
        if tick:
            _ingest((je, te), np.random.default_rng(99 + tick), 64,
                    te.now + 1, 0.3)
        a, b = _both(je, te, AGG[0])
        assert _delivered(a) == _delivered(b), tick
        _assert_queues(je, te, f"tick {tick}")
        if tick:
            assert te.spill.pending_pairs() + te.spill.pending_sids() > 0


def test_engine_constructor_and_plan_tag():
    """``BADEngine(enrichment=...)`` attaches like ``set_enrichment``; the
    stamped ``ChannelPlan.scorer`` stays out of ``to_dict`` and off the
    channels' own plans, in both packages."""
    stage = ten.HeuristicScorer(budget=2)
    eng = TEngine(dataset_capacity=64, index_capacity=16, device="cpu",
                  enrichment=stage)
    assert eng.enrichment is stage and not eng.set_enrichment(stage)
    eng.create_channel(tch.tweets_about_drugs())
    rep = eng.execute_all(deliver=True)["TweetsAboutDrugs"]
    assert rep.plan.scorer == stage.identity
    assert eng.channels["TweetsAboutDrugs"].plan is None
    assert eng.execute_all()["TweetsAboutDrugs"].plan.scorer is None
    jp = JPlan(scorer=("x",))
    tp = TPlan(scorer=("x",))
    assert jp.to_dict() == tp.to_dict() == TPlan().to_dict()
    assert tp != TPlan() and hash(tp) != hash(TPlan())
    assert isinstance(stage, ten.EnrichmentStage)
    assert not isinstance(object(), ten.EnrichmentStage)


@pytest.mark.parametrize("budget", [None, 0, 1, 7, 40, 1000])
def test_rank_result_matches_reference(budget):
    """``rank_result`` on a random stacked result with tied scores (only 3
    distinct values over 12 slots, two channels) and a member table: the
    pruned grids and both ranked counters equal the reference's, dtypes
    included; this pins the stable-sort tie rule against ``lax.top_k``."""
    rng = np.random.default_rng(11 + (budget or 0))
    C, Rm, Tm, T, cap = 2, 12, 5, 9, 4
    valid = rng.random((C, Rm, Tm)) < 0.5
    valid[0, 3] = False                       # a slot with no pair
    tgts = np.where(valid, rng.integers(0, T, (C, Rm, Tm)), -1).astype(
        np.int32)
    rows = np.where(valid, rng.integers(0, 64, (C, Rm, Tm)), -1).astype(
        np.int32)
    mrows = rng.integers(-1, 64, (C, Rm)).astype(np.int32)
    sids = np.full((C, T, cap), -1, np.int32)
    for c in range(C):
        for t in range(T):
            n = int(rng.integers(1, cap + 1))
            sids[c, t, :n] = rng.integers(0, 1000, n)
    counts = (sids >= 0).sum(-1).astype(np.int32)
    fields = rng.integers(0, 3, (64, 10)).astype(np.int32)
    z, zb = np.zeros((C,), np.int32), np.zeros((C, 2), np.int32)
    arrays = (rows, tgts, valid, mrows, mrows >= 0, z, z, z, zb, zb)
    jres = JResult(*map(jnp.asarray, arrays))
    tres = TResult(*map(torch.tensor, arrays))

    class DS:       # the dataset fields rank_result reads
        def __init__(self, f, mod):
            self.fields, self.capacity = mod(f), 64

    out = []
    for res, ds, en, mod in ((jres, DS(fields, jnp.asarray), jen, jnp.asarray),
                             (tres, DS(fields, torch.tensor), ten,
                              torch.tensor)):
        stage = en.HeuristicScorer(budget=budget, weights=(1.0, 0, 0, 0, 0))
        out.append(en.rank_result(stage, ds, res, mod(np.arange(C)),
                                  mod(sids), counts=mod(counts)))
    (jr, jp, js), (tr, tp, ts) = out
    for f in ("pair_valid", "pair_rows", "pair_targets"):
        assert_same(getattr(jr, f), getattr(tr, f), f)
    assert_same(jp, tp, "ranked_pairs")
    assert_same(js, ts, "ranked_sids")
    if budget is not None:
        kept = tr.pair_valid.sum((1, 2))
        assert (kept == np.minimum(valid.sum((1, 2)), budget)).all()


def test_enriched_pipeline_torch_example_smoke():
    """The port's example runs on the CPU with the heuristic scorer and
    ranks against the budget (the reference's example smoke test, mirrored)."""
    path = ROOT / "examples" / "enriched_pipeline_torch.py"
    spec = importlib.util.spec_from_file_location("enriched_pipeline_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.run(periods=2, batch=128, budget=8, heuristic=True,
                  n_subs=100, capacity=1 << 12, device="cpu")
    assert len(out) == 2
    assert sum(rep.overflow.ranked_pairs
               for reports in out for rep in reports.values()) > 0
    for reports in out:
        for rep in reports.values():
            assert rep.overflow.delivered_pairs <= 8
            check_delivery_conservation(rep.overflow, rep.num_results,
                                        rep.num_notified)
