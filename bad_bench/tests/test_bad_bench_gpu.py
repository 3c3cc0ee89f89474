"""On the card: one short run of a cell, end to end through the command,
comes out correct with its end-to-end metrics.

    python -m pytest -q -m gpu bad_bench/tests
"""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "trending-2lang.fused"


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode here")
    out = subprocess.run(
        [sys.executable, "bad_bench/run.py", "--workload", CELL, "--seed",
         "4000000005", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line["checks"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if CELL in m.get("workloads", [CELL])}
    assert set(line["metrics"]) == want
