"""Port parity for the dispatch/sync runtime: ``dispatch`` / ``dispatch_all``
and ``PendingExecution``, the resolved spill lane, ``TickPipeline`` and
``run_ticks`` at depth 1 and 2, each against the reference on the same
calls and data (CPU engines; exact comparisons)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import records as JR  # noqa: E402
from repro.core.churn import ChurnWorkload as JWorkload  # noqa: E402
from repro.core.churn import run_ticks as j_run_ticks  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.core.churn import ChurnWorkload, run_ticks  # noqa: E402
from repro_torch.core.runtime import (EngineProtocol,  # noqa: E402
                                      PendingExecution, TickPipeline)

from torch_engine_pairs import (COUNTERS, PARAM, JFlags, JPlan,  # noqa: E402
                                TFlags, TPlan, TRequest, _assert_queues,
                                _assert_reports, _batcher, _collect,
                                _drain_until_empty, _engines, _ingest,
                                assert_same)

CRIME = "TweetsAboutCrime3"


def _resolved_view(q):
    return {k: [(r.tolist(), t.tolist(), s.tolist()) for r, t, s in d]
            for k, d in q._resolved.items()}


def _plans(je, te, backend):
    for eng, plan in ((je, JPlan), (te, TPlan)):
        for name in PARAM:
            eng.set_plan(name, plan("bad_index", True, True, backend))
        eng.set_plan(CRIME, plan("bad_index", False, True, "oracle"))


@pytest.mark.parametrize("backend", ["oracle", "compact_pallas"])
def test_deferred_sync_resolves_against_the_dispatch_time_tables(backend):
    """The trap of in-place patches: dispatch tick N with
    ``resolve_spills``, churn (subscription removals and cohort churn),
    dispatch tick N+1 (which patches the stacked sID tables in place), and
    only then sync tick N. Its spilled pairs must resolve against the
    tables it joined, as in the reference, where a patch makes new arrays:
    equal reports and equal resolved-lane content."""
    je, te, rng = _engines(41, ring_capacity=4)
    je.debug_delivery_buffers = te.debug_delivery_buffers = True
    _plans(je, te, backend)
    for eng in (je, te):
        eng.subscribe_users(CRIME, np.arange(0, 24, 2))
    _ingest(je, te, rng, 300, 1, match=0.4)
    pa = je.dispatch_all(None, deliver=True, resolve_spills=True)
    pb = te.dispatch_all(None, deliver=True, resolve_spills=True)
    assert isinstance(pb, PendingExecution) and not pb.done
    patches = te.maintenance.patches
    for eng in (je, te):
        eng.remove_subscriptions("TweetsAboutDrugs", np.arange(0, 200, 2))
        eng.unsubscribe_users(CRIME, [0, 2, 4, 6])
        eng.subscribe_users(CRIME, [1, 3, 5])
    _ingest(je, te, rng, 300, 500, match=0.4)
    qa = je.dispatch_all(None, deliver=True, resolve_spills=True)
    qb = te.dispatch_all(None, deliver=True, resolve_spills=True)
    assert te.maintenance.patches > patches    # N+1 patched in place
    a, b = pa.sync(), pb.sync()
    assert pb.done and pb.sync() is b and pb.latency_s > 0
    _assert_reports(a, b, "tick N", deliver=True)
    assert _resolved_view(je.spill) == _resolved_view(te.spill)
    assert te.spill.pending_pairs() > 0
    assert {k for k in te.spill.resolved_keys()} >= {"TweetsAboutDrugs"}
    _assert_reports(qa.sync(), qb.sync(), "tick N+1", deliver=True)
    _assert_queues(je, te, "tick N+1")
    assert _resolved_view(je.spill) == _resolved_view(te.spill)
    _drain_until_empty(je, te, "resolved")


def test_dispatch_surface_and_tick_pipeline_window():
    """``execute`` is ``dispatch(...).sync()``; an empty request dispatches
    nothing; the engine satisfies ``EngineProtocol``; ``TickPipeline``
    keeps at most depth - 1 ticks pending, yields them oldest first and
    flushes the rest."""
    je, te, rng = _engines(5)
    assert isinstance(te, EngineProtocol)
    empty = te.dispatch(TRequest(channels=()))
    assert empty.sync() == {} and empty.latency_s is not None
    with pytest.raises(ValueError, match="depth"):
        TickPipeline(te, depth=0)
    pipe = TickPipeline(te, depth=3)
    jpipe = __import__("repro.core.runtime",
                       fromlist=["TickPipeline"]).TickPipeline(je, depth=3)
    got, want = [], []
    for tick in range(5):
        _ingest(je, te, rng, 150, 1 + 300 * tick, match=0.4)
        got += pipe.step(TFlags("bad_index", True, True))
        want += jpipe.step(JFlags("bad_index", True, True))
        assert pipe.in_flight == min(tick + 1, 2)
        assert pipe.drain_due() == jpipe.drain_due()
    got += pipe.flush()
    want += jpipe.flush()
    assert [t for t, _ in got] == [t for t, _ in want] == list(range(5))
    for (t, x), (_, y) in zip(want, got):
        _assert_reports(x, y, f"tick {t}", deliver=True)
    assert pipe.max_in_flight == 3 and len(pipe.latencies) == 5
    _assert_queues(je, te, "pipeline")


@pytest.mark.parametrize("depth", [1, 2])
def test_run_ticks_matches_reference(depth):
    """``run_ticks`` with slot churn on both param channels, cohort churn on
    the spatial channel and caps that overflow every tick: the ChurnReport
    counters, the maintenance counters and the delivered (row, sID) and
    sID multisets equal the reference's run of the same seed, at depth 1
    (synchronous) and depth 2 (``TickPipeline``, resolved lane, batched
    drains)."""
    runs = {}
    for lib, make_eng in (("ref", 0), ("port", 1)):
        engines = _engines(61)
        eng = engines[make_eng]
        eng.debug_delivery_buffers = True
        eng.subscribe_users(CRIME, np.arange(0, 24, 2))
        Workload = JWorkload if lib == "ref" else ChurnWorkload
        wl = [Workload("TweetsAboutDrugs", adds_per_tick=12,
                       removes_per_tick=10, num_brokers=2,
                       user_channel=CRIME, user_churn_per_tick=3),
              Workload("MostThreateningTweets", adds_per_tick=6,
                       removes_per_tick=8, num_brokers=2)]
        if lib == "ref":
            make = _batcher(JR, lambda R, f, loc: R.RecordBatch.from_numpy(
                f, loc))
            run = j_run_ticks
        else:
            make = _batcher(TR, lambda R, f, loc: R.RecordBatch.from_numpy(
                f, loc, device="cpu"))
            run = run_ticks
        sink = {"pairs": [], "sids": []}
        on_tick, on_drain = _collect(sink)
        live = {n: np.arange(200, dtype=np.int32) for n in PARAM}
        rep = run(eng, wl, 5, np.random.default_rng(62),
                  flags=None, deliver=True, ingest_per_tick=150,
                  make_batch=make, warmup=1, live_sids=live, churn_rounds=2,
                  on_tick=on_tick, on_drain=on_drain, pipeline_depth=depth)
        runs[lib] = (rep, sorted(sink["pairs"]), sorted(sink["sids"]),
                     {k: v.tolist() for k, v in live.items()})
    (jr, jp, js, jl), (tr, tp, ts, tl) = runs["ref"], runs["port"]
    assert [getattr(jr, k) for k in COUNTERS] == \
        [getattr(tr, k) for k in COUNTERS]
    assert (jr.maintenance.rebuilds, jr.maintenance.patches) == \
        (tr.maintenance.rebuilds, tr.maintenance.patches)
    assert tr.maintenance.rebuilds == 0
    assert tr.maintenance.patches > 0 and tr.pipeline_depth == depth
    assert tr.delivered_sids > 0 and tr.user_adds > 0
    assert tp == jp and ts == js and tl == jl
    assert tr.ticks_per_s > 0 and tr.subs_per_s > 0


def test_run_ticks_default_batches_run_on_the_engine_device():
    """The default ``make_batch`` draws ``tweet_batch`` on the engine's
    device with the reference's draws: a param-only run matches the
    reference's default run counter for counter."""
    from repro.core import channel as jch
    from repro.core.engine import BADEngine as JEngine
    from repro_torch.core import channel as tch
    from repro_torch.core.engine import BADEngine as TEngine

    out = []
    for lib, eng in ((jch, JEngine(dataset_capacity=2048,
                                   index_capacity=1024, max_window=1024,
                                   max_candidates=256)),
                     (tch, TEngine(dataset_capacity=2048,
                                   index_capacity=1024, max_window=1024,
                                   max_candidates=256, device="cpu"))):
        eng.create_channel(lib.tweets_about_drugs())
        Workload = JWorkload if lib is jch else ChurnWorkload
        run = j_run_ticks if lib is jch else run_ticks
        rep = run(eng, [Workload("TweetsAboutDrugs", 64, 32)], 3,
                  np.random.default_rng(3), ingest_per_tick=2048, warmup=1)
        out.append([getattr(rep, k) for k in COUNTERS])
    assert out[0] == out[1] and out[1][COUNTERS.index("results")] > 0


def test_resolved_lane_survives_churn_before_a_deferred_drain():
    """Captures through the resolved lane survive churn between dispatch
    and drain (delivered in full), where the epoch lane drops them: both
    packages agree on both lanes."""
    for lane in ("resolved", "epoch"):
        je, te, rng = _engines(3, ring_capacity=4)
        _ingest(je, te, rng, 300, 1, match=0.4)
        flags = (JFlags("window", True, True), TFlags("window", True, True))
        if lane == "resolved":
            a = je.dispatch_all(flags[0], deliver=True,
                                resolve_spills=True).sync()
            b = te.dispatch_all(flags[1], deliver=True,
                                resolve_spills=True).sync()
        else:
            a = je.execute_all(flags[0], deliver=True)
            b = te.execute_all(flags[1], deliver=True)
        _assert_reports(a, b, lane, deliver=True)
        assert te.spill.pending_pairs() > 0
        for eng in (je, te):
            eng.subscribe("TweetsAboutDrugs", 3, "B1")       # epoch bump
        outcome = []
        for eng in (je, te):
            delivered = dropped = 0
            while eng.spill.pending_pairs() + eng.spill.pending_sids():
                for dr in eng.drain_spilled().values():
                    delivered += dr.stats.delivered_pairs
                    dropped += dr.stats.dropped_pairs
            outcome.append((delivered, dropped))
        assert outcome[0] == outcome[1], lane
        assert (outcome[1][1] == 0) == (lane == "resolved"), outcome


def test_resolved_rows_match_the_host_rule():
    """``engine._resolve_rows`` (a device gather of the named rows) equals
    ``broker.resolve_pair_sids`` on every table shape: group rows, the
    1-wide flat and cohort tables, the 0-width identity and an empty
    table."""
    import torch

    from repro_torch.core.broker import resolve_pair_sids
    from repro_torch.core.engine import _resolve_rows

    rng = np.random.default_rng(0)
    tgts = rng.integers(-2, 12, 9).astype(np.int32)
    for shape in ((10, 4), (10, 1), (0,), (10, 0), (0, 3)):
        tbl = rng.integers(-1, 99, shape).astype(np.int32)
        for t in (tgts, tgts[:0]):
            want = resolve_pair_sids(tbl, t)
            got = _resolve_rows(torch.as_tensor(tbl), t)
            assert_same(want, got, (shape, len(t)))
