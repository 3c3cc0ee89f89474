"""Every cell, configuration and per-layer metric of ``BENCHMARK.json`` is
found by name and parses; a cell, configuration or metric added as files
is found with no change to the harness."""
import json
import pathlib
import re
import shutil

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_names():
    assert set(BENCH) == TOP
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_and_its_config_parse(w):
    cell = json.loads((ROOT / "bad_bench" / "cells" /
                       f"{w['name']}.json").read_text())
    assert cell["config"] == w["config"]
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    assert cfg["name"] == w["config"] and len(cfg["source"]) <= 200
    assert set(cfg_entry["reduced"]) == set(cfg["reduced"])
    for ch in cfg["channels"]:
        assert ch["plan"]["backend"] in ("compact_pallas", "pallas")
    assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(m):
    import importlib
    reader = importlib.import_module(
        f"bad_bench.metrics.{m['name'].split('.')[0]}")
    assert callable(reader.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_a_cell_added_as_files_is_found(tmp_path):
    from bad_bench import run
    (tmp_path / "bad_bench").mkdir()
    shutil.copytree(ROOT / "bad_bench" / "configs",
                    tmp_path / "bad_bench" / "configs")
    (tmp_path / "bad_bench" / "cells").mkdir()
    cell = {"config": "bad-trending-2lang", "tweets_per_tick": 4096,
            "tweak": 0, "pool": 4, "warmup_ticks": 2, "samples": 1,
            "churn": None, "cohort": None}
    (tmp_path / "bad_bench" / "cells" / "fixture.small.json").write_text(
        json.dumps(cell))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "fixture.small", "config": "bad-trending-2lang",
         "traffic": "small", "chips": 1, "why": "fixture"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    _, entry, got, cfg = run.load(str(tmp_path), "fixture.small")
    assert got == cell and cfg["name"] == "bad-trending-2lang"
    assert entry["chips"] == 1


def test_a_metric_added_as_a_file_is_read(tmp_path, monkeypatch):
    import bad_bench.metrics
    from bad_bench import run
    (tmp_path / "fixture_ticks.py").write_text(
        "def read(run):\n    return float(len(run.window))\n")
    monkeypatch.setattr(bad_bench.metrics, "__path__",
                        list(bad_bench.metrics.__path__) + [str(tmp_path)])
    bench = {"per_layer": [{"name": "fixture_ticks", "unit": "ticks"}]}

    class Run:
        window = [1, 2, 3]

    assert run.per_layer(Run, bench, "any") == {
        "fixture_ticks": {"value": 3.0, "unit": "ticks"}}


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_the_trending_engine_sizes_cover_the_references_largest_tick(seed):
    """At the cell's period, the wire buffer, the notify buffer and the
    candidate bucket hold the largest tick the reference works out over
    every batch of the cell's pool (tick k takes batch k mod pool, so those
    ticks are all there are)."""
    import numpy as np
    torch = pytest.importorskip("torch")
    from bad_bench.reference import reference
    from bad_bench.tests.tiny import load
    cfg, cell = load("trending-2lang.fused")
    e = cfg["engine"]
    want = reference.expected(cfg, cell, seed, cell["pool"], set(),
                              torch.device("cpu"))
    for name in want.ticks[0]:
        rows, _, sids, _, lines = zip(*(t[name] for t in want.ticks))
        assert max(int(np.sum(b)) for b in lines) <= e["max_deliver_pairs"]
        assert max(sids) <= e["max_notify"]
        assert max(rows) <= e["max_candidates"]
    assert cell["tweets_per_tick"] <= e["max_window"]


# a width may never be cut (the model-configs guide, section 4)
WIDTHS = {"d_model", "d_ff", "head_dim", "n_heads", "n_kv_heads",
          "moe_top_k", "ssm_state", "ssm_expand", "ssm_conv"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_an_enrichment_block_names_its_cut_and_its_plain_scorer(c):
    """Where a configuration has an ``enrichment`` block: each overridden
    key is in its ``reduced`` and ``BENCHMARK.json``'s, no width is cut,
    its plain scorer is a module of ``reference/scorers/`` and its
    tolerance gives its reason."""
    import importlib
    cfg = json.loads((ROOT / c["file"]).read_text())
    block = cfg.get("enrichment")
    if block is None:
        return
    over = set(block.get("overrides", {}))
    assert over <= set(cfg["reduced"]) and over <= set(c["reduced"])
    assert not over & WIDTHS
    plain = importlib.import_module(
        f"bad_bench.reference.scorers.{block['plain']}")
    assert all(callable(getattr(plain, f))
               for f in ("init", "score", "flops"))
    tol = block["tolerance"]
    assert tol["atol"] >= 0 and tol["rtol"] >= 0 and tol["why"]
    assert int(block["budget"]) > 0 and int(block["lanes"]) > 0
