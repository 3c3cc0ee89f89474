"""What a run prints about its own window: the tick diagnosis line on
standard error, before the check lines, with numbers that agree with the
run's ticks."""
import argparse
import json
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bad_bench import run, system  # noqa: E402
from bad_bench.tests.tiny import tiny  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 91
NUMBER = r"(\d+(?:\.\d+)?)"


def _fake_run(walls_ms, starts_s, window_s):
    ticks = [system.Tick(w / 1e3, 1, {}, {}, [], start_s=10.0 + s)
             for w, s in zip(walls_ms, starts_s)]
    return system.Run(setup_s=0.0, window=ticks, window_s=window_s,
                      ticks=ticks, sampled={}, final_drains=[],
                      pending_after=0, ring_fields=None, ring_location=None,
                      size_rows=0, memory_peak_bytes=0, spans={},
                      profile=None, flush_drops=0, window_t0=10.0)


def test_the_diagnosis_counts_slow_ticks_by_quarter_and_the_time_between():
    walls = [2.0, 2.0, 2.0, 9.0, 2.0, 2.0, 5.0, 2.0]
    starts = [0.0, 0.1, 0.2, 0.3, 0.5, 0.6, 0.8, 0.95]
    d = run.diagnosis(_fake_run(walls, starts, 1.0))
    assert d["p50_ms"] == 2.0 and d["max_ms"] == 9.0
    assert d["p90_ms"] == pytest.approx(np.percentile(walls, 90))
    assert d["p99_ms"] == pytest.approx(np.percentile(walls, 99))
    assert d["slow"] == 2 and d["slow_by_quarter"] == [0, 1, 0, 1]
    assert d["outside_s"] == pytest.approx(1.0 - sum(walls) / 1e3)


def test_each_run_prints_its_tick_diagnosis(monkeypatch, capsys):
    cfg, cell = tiny("paper-1m.trickle")
    kept = []
    orig = system.run

    def keep(*a, **k):
        kept.append(orig(*a, **k))
        return kept[-1]

    monkeypatch.setattr(system, "run", keep)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    args = argparse.Namespace(workload="paper-1m.trickle", seed=SEED,
                              seconds=0.6, trace=0)
    assert run.measure(bench, cell, cfg, args, CPU) == 0
    err = capsys.readouterr().err.splitlines()
    at = next(i for i, line in enumerate(err) if line.startswith("ticks: "))
    assert err[at - 1].startswith("window: ")
    assert at < next(i for i, line in enumerate(err)
                     if line.startswith("check "))
    got = re.match(
        rf"ticks: p50 {NUMBER} ms, p90 {NUMBER} ms, p99 {NUMBER} ms, "
        rf"max {NUMBER} ms; (\d+) over twice the median \(by quarter of the "
        rf"window (\d+), (\d+), (\d+), (\d+)\); {NUMBER} s of the window's "
        rf"{NUMBER} s outside ticks$", err[at])
    assert got, err[at]
    r = kept[0]
    ms = 1e3 * np.array([t.wall_s for t in r.window])
    want = np.percentile(ms, [50, 90, 99]).tolist() + [ms.max()]
    assert [float(v) for v in got.groups()[:4]] == pytest.approx(
        want, abs=6e-4)
    slow = ms > 2 * np.median(ms)
    assert int(got.group(5)) == int(slow.sum()) == sum(
        int(v) for v in got.groups()[5:9])
    outside = r.window_s - sum(t.wall_s for t in r.window)
    assert float(got.group(10)) == pytest.approx(outside, abs=1e-6)
    assert 0 < outside < r.window_s
    assert float(got.group(11)) == pytest.approx(r.window_s, abs=1e-6)
    assert all(r.window_t0 <= t.start_s <= r.window_t0 + r.window_s
               for t in r.window)
