"""A scored deployment on tiny runs on the CPU: the enrichment stage built
from the configuration's ``enrichment`` block with the reduced dense
scorer, its budget's pruned pairs counted as the budget's, and each fault
planted in the stage comes out as not correct."""
import argparse
import filecmp
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bad_bench import check, enrichment, run, system  # noqa: E402
from bad_bench import traffic as T  # noqa: E402
from bad_bench.reference.scorers import dense  # noqa: E402
from bad_bench.tests.tiny import tiny, tiny_scored  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
SEED = 2 ** 31 + 2029
CELL = "paper-1m.fused"
OLD_CHECKS = ["count_mismatch", "conservation_break", "dropped",
              "undelivered", "pair_mismatch", "sid_mismatch",
              "line_broker_mismatch", "no_sample", "ring_row_mismatch",
              "control_mismatch", "raised"]


def measured(cfg, cell, monkeypatch, capsys, workload=CELL):
    """``run.measure`` on the CPU: (result line, the run it judged). At
    ``--seconds 0`` the window is one tick, and it is the sampled one
    however slow the machine is."""
    kept = []
    orig = system.run

    def keep(*a, **k):
        kept.append(orig(*a, **k))
        return kept[-1]

    monkeypatch.setattr(system, "run", keep)
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=0,
                              trace=0)
    assert run.measure(BENCH, cell, cfg, args, CPU) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, kept[0]


def _bad(line, *names):
    return not line["correct"] and all(
        line["checks"][n]["value"] > 0 for n in names)


def _ranked(r):
    return sum(st[8] for t in r.window for *_, st in t.reports.values())


def test_an_under_budget_scored_run_equals_the_unscored_run(monkeypatch,
                                                            capsys):
    """One window tick each, so both runs hold the same ticks and sample
    the same one: the stage passes everything through."""
    base, r0 = measured(*tiny(CELL), monkeypatch, capsys)
    monkeypatch.undo()
    got, r1 = measured(*tiny_scored(CELL, budget=10 ** 6), monkeypatch,
                       capsys)
    for key in ("correct", "attempted", "failed"):
        assert got[key] == base[key]
    assert base["correct"] and set(got["metrics"]) == set(base["metrics"])
    assert {k: got["checks"][k] for k in base["checks"]} == base["checks"]
    assert all(got["checks"][k]["value"] == 0
               for k in check.SCORED_LIMITS)
    assert [t.reports for t in r1.ticks] == [t.reports for t in r0.ticks]
    assert r1.sampled.keys() == r0.sampled.keys() and r1.scores
    for k, per in r0.sampled.items():
        for name, (lines, sids) in per.items():
            assert np.array_equal(r1.sampled[k][name][0], lines)
            assert np.array_equal(r1.sampled[k][name][1], sids)


def test_an_over_budget_run_is_correct_with_ranked_pairs_not_failed(
        monkeypatch, capsys):
    line, r = measured(*tiny_scored(CELL, budget=32), monkeypatch, capsys)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert _ranked(r) > 0
    # the sampled ticks' channels were ranked, so the selection was judged
    k = next(iter(r.sampled))
    assert any(r.ticks[k].reports[n][3][8] for n in r.sampled[k])
    drops = sum(st[2] for t in r.window for *_, st in t.reports.values())
    assert drops == _ranked(r)


def _stage_patch(monkeypatch, fault):
    orig = enrichment.stage

    def stage(block, seed, dev):
        s = orig(block, seed, dev)
        fault(s, block)
        return s

    monkeypatch.setattr(enrichment, "stage", stage)


def test_scores_moved_by_twice_the_tolerance_fail_score_mismatch(
        monkeypatch, capsys):
    def moved(s, block):
        tol, score = block["tolerance"], s.score

        def shifted(*a):
            v = score(*a)
            return v + 2 * (tol["atol"] + tol["rtol"] * v.abs())

        s.score = shifted

    _stage_patch(monkeypatch, moved)
    line, _ = measured(*tiny_scored(CELL, budget=32), monkeypatch, capsys)
    assert _bad(line, "score_mismatch")
    assert line["checks"]["rank_order_break"]["value"] == 0


def test_a_stage_that_keeps_one_pair_over_its_budget_fails(monkeypatch,
                                                           capsys):
    def over(s, block):
        s.budget = int(block["budget"]) + 1

    _stage_patch(monkeypatch, over)
    line, _ = measured(*tiny_scored(CELL, budget=32), monkeypatch, capsys)
    assert _bad(line, "budget_mismatch")


def test_a_stage_that_keeps_low_scored_slots_fails_rank_order(monkeypatch,
                                                              capsys):
    """The selection ranks by the negated scores while the stage reports
    its own: the lowest-scored slots are kept."""
    from repro_torch.core import enrich
    orig = enrich.rank_result

    class Negated:
        def __init__(self, stage):
            self.stage, self.budget = stage, stage.budget

        def score(self, *a):
            return -self.stage.score(*a)

    def rank_result(stage, *a, **k):
        return orig(Negated(stage), *a, **k)

    monkeypatch.setattr(enrich, "rank_result", rank_result)
    line, _ = measured(*tiny_scored(CELL, budget=32), monkeypatch, capsys)
    assert _bad(line, "rank_order_break")
    assert line["checks"]["score_mismatch"]["value"] == 0


def test_a_real_drop_in_a_scored_run_still_counts(monkeypatch, capsys):
    """A wire buffer under the budget, no retry ring and a one-entry spill
    queue: pairs the budget kept are lost, and counted."""
    cfg, cell = tiny_scored(CELL, budget=32)
    cfg["engine"].update(max_deliver_pairs=16, ring_capacity=0,
                         spill_capacity=1)
    line, r = measured(cfg, cell, monkeypatch, capsys)
    assert _bad(line, "dropped") and line["failed"] > 0
    assert _ranked(r) > 0
    stats = [rep[3] for t in r.ticks for rep in t.reports.values()] + \
        [st for t in r.ticks for st in t.drained.values()]
    real = sum(st[2] - st[8] + st[5] - st[9] for st in stats)
    assert 0 < real <= line["checks"]["dropped"]["value"]


@pytest.mark.parametrize("cell", ["paper-1m.fused", "paper-1m.trickle",
                                  "trending-2lang.fused", "paper-1m.churn"])
def test_the_existing_cells_print_the_same_checks(cell, monkeypatch, capsys):
    line, r = measured(*tiny(cell), monkeypatch, capsys, workload=cell)
    assert list(line["checks"]) == OLD_CHECKS
    assert line["correct"] and r.enrichment is None and not r.scores


def test_the_dense_tolerance_is_tight():
    """At the tiny size on the CPU the program's float32 scores lie within
    the tolerance of the plain forward's; the same forward with bfloat16
    matrix products does not."""
    cfg, _ = tiny_scored()
    block = cfg["enrichment"]
    tol = block["tolerance"]
    for seed in (SEED, SEED + 1, 7):
        stage = enrichment.stage(block, seed, CPU)
        f, _ = T.batch(seed, T.POOL, 0, 256, 0, "paper", 0.05)
        tok = torch.as_tensor(f)
        prog = stage.score(tok, torch.zeros(256), tok[:, 0])
        w = dense.init(enrichment.model_settings(block), seed, CPU)
        plain = dense.score(w, tok, block["lanes"])
        low = dense.score(w, tok, block["lanes"], mm_dtype=torch.bfloat16)
        limit = tol["atol"] + tol["rtol"] * plain.abs()
        assert ((prog - plain).abs() <= limit).all()
        assert ((low - plain).abs() > limit).any()


def test_the_plain_weights_follow_the_seed_and_carry_into_the_program():
    cfg, _ = tiny_scored()
    block = cfg["enrichment"]
    model = enrichment.model_settings(block)
    a, b = dense.init(model, SEED, CPU), dense.init(model, SEED, CPU)
    c = dense.init(model, SEED + 1, CPU)
    ea, eb = a["tree"]["embed"], b["tree"]["embed"]
    assert torch.equal(ea, eb) and not torch.equal(ea, c["tree"]["embed"])
    prog = enrichment.stage(block, SEED, CPU).params
    wq = a["tree"]["layers"]["b0"]["attn"]["wq"]
    assert len(prog["layers"]) == model["n_layers"]
    assert torch.equal(prog["layers"][1]["b0"]["attn"]["wq"], wq[1])
    assert torch.equal(prog["embed"], ea)


def test_plain_settings_that_disagree_with_the_program_are_refused():
    cfg, _ = tiny_scored()
    block = dict(cfg["enrichment"], model=dict(cfg["enrichment"]["model"],
                                               rope_theta=1e4))
    with pytest.raises(ValueError, match="rope_theta"):
        enrichment.program_config(block)


def test_a_scored_cell_added_as_files_runs_correct(tmp_path):
    """A scored configuration, its cell and a plain module added as new
    files to a copy of ``bad_bench/``, with the cell's entries in a copy of
    ``BENCHMARK.json``: ``run.measure`` judges it correct, and no file of
    the copy was edited."""
    bench = tmp_path / "bad_bench"
    shutil.copytree(ROOT / "bad_bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg, cell = tiny_scored(CELL, budget=24)
    cfg.update(name="fixture-scored")
    cfg["enrichment"]["plain"] = "fixture_dense"
    cell["config"] = "fixture-scored"
    (bench / "configs" / "fixture-scored.json").write_text(json.dumps(cfg))
    (bench / "cells" / "fixture.scored.json").write_text(json.dumps(cell))
    shutil.copy(bench / "reference" / "scorers" / "dense.py",
                bench / "reference" / "scorers" / "fixture_dense.py")
    entries = dict(BENCH)
    entries["configs"] = BENCH["configs"] + [
        {"name": "fixture-scored", "source": "fixture",
         "file": "bad_bench/configs/fixture-scored.json",
         "reduced": cfg["reduced"], "why": "fixture"}]
    entries["workloads"] = BENCH["workloads"] + [
        {"name": "fixture.scored", "config": "fixture-scored",
         "traffic": "scored", "chips": 1, "why": "fixture"}]
    entries["end_to_end"] = [dict(m, workloads=m["workloads"] +
                                  ["fixture.scored"])
                             if "workloads" in m and m["name"] in
                             ("tweets_per_s", "tick_ms_p90") else m
                             for m in BENCH["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(entries))
    code = ("import argparse, sys, torch\n"
            "from bad_bench import run\n"
            "bench, entry, cell, cfg = run.load(sys.argv[1], "
            "'fixture.scored')\n"
            "args = argparse.Namespace(workload='fixture.scored', "
            f"seed={SEED}, seconds=0, trace=0)\n"
            "rc = run.measure(bench, cell, cfg, args, torch.device('cpu'))\n"
            "assert run.__file__.startswith(sys.argv[1])\n"
            "assert 'bad_bench.reference.scorers.fixture_dense' in "
            "sys.modules\n"
            "sys.exit(rc)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=f"{tmp_path}:{ROOT / 'src'}"))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(OLD_CHECKS) | set(check.SCORED_LIMITS)
    assert set(line["metrics"]) == {"tweets_per_s", "tick_ms_p90", "setup_s"}
    for path in (ROOT / "bad_bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert filecmp.cmp(path, bench / path.relative_to(
                ROOT / "bad_bench"), shallow=False), path
