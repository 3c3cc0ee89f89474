"""Port parity for the planner: ``RuntimePlanner`` proposes and applies the
reference's switches on the same report stream (hooked into ``run_ticks``
on both engines), plan files written by either package load in the other,
and ``search_plans`` / the ``plan_search`` CLI run on a CPU engine."""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import planner as jqp  # noqa: E402
from repro.core.churn import ChurnWorkload as JWorkload  # noqa: E402
from repro.core.churn import run_ticks as j_run_ticks  # noqa: E402
from repro_torch.core import planner as tqp  # noqa: E402
from repro_torch.core.churn import ChurnWorkload, run_ticks  # noqa: E402

from torch_engine_pairs import (COUNTERS, JR, TR, JPlan,  # noqa: E402
                                TPlan, _assert_reports, _batcher, _engines,
                                _ingest)


def _switches(planner):
    return [(s.tick, s.channel, s.old.to_dict(), s.new.to_dict())
            for s in planner.switches]


def test_runtime_planner_switches_like_the_reference_under_churn():
    """Both engines start every channel on a window scan, flat layout;
    the planner hooked into ``run_ticks(on_tick=...)`` observes the same
    reports and switches the same channels at the same ticks to the same
    plans, with conservation across the switches (the run's counters,
    drained to empty, equal the reference's)."""
    runs = []
    for side in (0, 1):
        eng = _engines(90)[side]
        plan = (JPlan, TPlan)[side]
        for name in eng.channels:
            eng.set_plan(name, plan("window", False, False, "oracle"))
        planner = (jqp, tqp)[side].RuntimePlanner(
            eng, (jqp, tqp)[side].PlannerConfig(patience=2, cooldown=2))
        Workload = (JWorkload, ChurnWorkload)[side]
        make = _batcher((JR, TR)[side], (
            lambda R, f, loc: R.RecordBatch.from_numpy(f, loc),
            lambda R, f, loc: R.RecordBatch.from_numpy(f, loc,
                                                       device="cpu"))[side])
        rep = (j_run_ticks, run_ticks)[side](
            eng, [Workload("TweetsAboutDrugs", 10, 10, num_brokers=2)], 6,
            np.random.default_rng(91), deliver=True, ingest_per_tick=150,
            make_batch=make, warmup=0,
            live_sids={"TweetsAboutDrugs": np.arange(200, dtype=np.int32)},
            use_channel_plans=True,
            on_tick=lambda tick, reports, p=planner: p.step(reports))
        runs.append((_switches(planner), [getattr(rep, k) for k in COUNTERS],
                     {n: p.to_dict()
                      for n, p in eng.plan_assignment().items()},
                     planner.stable_since(),
                     {n: dataclasses.astuple(o)
                      for n, o in planner.obs.items()}))
    assert runs[0] == runs[1]
    assert len(runs[1][0]) > 0


class _Rep:
    def __init__(self, name, num_results, num_notified, scanned,
                 overflow=None):
        self.channel, self.num_results = name, num_results
        self.num_notified, self.scanned = num_notified, scanned
        self.overflow = overflow


def test_planner_decisions_match_the_reference_on_synthetic_reports():
    """Hysteresis (patience, cooldown), the index ratchet, pressure with and
    without ring recycling, and the compact proposal for a predicate-less
    sparse window channel: the same report stream gives the same proposals
    and switches in both packages."""
    class _Ov:
        delivered_pairs, spilled_pairs, dropped_pairs = 10, 40, 0
        delivered_sids, spilled_sids, dropped_sids = 10, 0, 0
        retried_pairs, retried_sids = 0, 0

    class _Ring(_Ov):
        retried_pairs = 38

    stream = ([{"TweetsAboutDrugs": _Rep("TweetsAboutDrugs", 5, 50, 1000)}]
              * 2 + [{"TweetsAboutDrugs": _Rep("TweetsAboutDrugs", 5, 5,
                                               1000)}] * 5
              + [{"MostThreateningTweets":
                  _Rep("MostThreateningTweets", 50, 50, 1000, _Ov())},
                 {"MostThreateningTweets":
                  _Rep("MostThreateningTweets", 50, 50, 1000, _Ring())},
                 {"NoPreds": _Rep("NoPreds", 20, 20, 1000)},
                 {"NoPreds": _Rep("NoPreds", 900, 900, 1000)}])
    out = []
    for side in (0, 1):
        eng = _engines(1)[side]
        from repro.core.channel import tweets_about_drugs as jd
        from repro_torch.core.channel import tweets_about_drugs as td
        eng.create_channel(dataclasses.replace((jd, td)[side](),
                                               name="NoPreds",
                                               fixed_preds=()))
        qp = (jqp, tqp)[side]
        planner = qp.RuntimePlanner(eng, qp.PlannerConfig(patience=2,
                                                          cooldown=4))
        props = []
        for reports in stream:
            planner.step(reports)
            props.append({n: planner.propose(n).to_dict()
                          for n in eng.channels})
        forced = qp.RuntimePlanner(eng, qp.PlannerConfig(backend="pallas"))
        forced.observe(stream[-2])
        props.append(forced.propose("NoPreds").to_dict())
        out.append((_switches(planner), props))
    assert out[0] == out[1]
    assert len(out[1][0]) >= 2


def test_plan_files_load_in_both_packages(tmp_path):
    """A plan file saved by either package loads in the other and applies
    the same assignment."""
    plans = {"TweetsAboutDrugs": ("bad_index", True, True, "compact_pallas"),
             "TweetsAboutCrime3": ("window", False, True, "pallas")}
    for writer, reader, wplan in ((tqp, jqp, TPlan), (jqp, tqp, JPlan)):
        path = tmp_path / f"{writer.__name__}.json"
        writer.save_plans(str(path), {n: wplan(*p) for n, p in plans.items()},
                          meta={"seed": 0})
        loaded = reader.load_plans(str(path))
        assert {n: p.to_dict() for n, p in loaded.items()} == \
            {n: wplan(*p).to_dict() for n, p in plans.items()}
        je, te, _ = _engines(2)
        eng = te if reader is tqp else je
        assert reader.apply_plans(eng, loaded) == 2
        assert reader.apply_plans(eng, {"missing": loaded[
            "TweetsAboutDrugs"]}) == 0
        assert eng.channel_plan("TweetsAboutCrime3") == \
            loaded["TweetsAboutCrime3"]


def test_search_plans_and_the_cli_on_a_cpu_engine(tmp_path):
    """``search_plans`` times each candidate through ``execute_channel``
    without advancing watermarks (the reports after the search equal the
    reference's); the ``plan_search`` CLI writes a plan file the reference
    loads."""
    je, te, rng = _engines(4)
    _ingest(je, te, rng, 200, 1, match=0.4)
    cands = (TPlan("window", False, True), TPlan("bad_index", True, True),
             TPlan("bad_index", True, True, "compact"))
    res = tqp.search_plans(te, candidates=cands, repeats=1)
    assert set(res) == set(te.channels)
    for name, r in res.items():
        walls = [c["wall_s"] for c in r["candidates"]]
        assert walls == sorted(walls) and all(w > 0 for w in walls)
        assert TPlan.from_dict(r["best"]) in cands
    from repro.core.plans import ExecutionFlags as JFlags
    from repro_torch.core.plans import ExecutionFlags as TFlags
    _assert_reports(je.execute_all(JFlags("bad_index", True, True),
                                   timed=False),
                    te.execute_all(TFlags("bad_index", True, True),
                                   timed=False), "after search")
    from repro_torch.launch import plan_search
    out = tmp_path / "ps"
    plan_search.main(["--subs", "200", "--tweets", "512", "--repeats", "1",
                      "--device", "cpu", "--out", str(out)])
    loaded = jqp.load_plans(str(out / "plans.json"))
    assert set(loaded) == {"TweetsAboutDrugs", "MostThreateningTweets"}
    doc = json.loads((out / "plans.json").read_text())
    assert doc["meta"]["device"] == "cpu"
    import torch
    if not torch.cuda.is_available():      # the CLI defaults to the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan_search.main(["--subs", "10", "--out", str(out)])
