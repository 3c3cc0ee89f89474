"""Port parity: the BAD index (insert with per-channel stable compaction,
capacity drops and the sticky overflow flag; watermark windows; compact)
over several batches that overflow capacity."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bad_index as JB  # noqa: E402
from repro_torch.core import bad_index as TB  # noqa: E402

from torch_parity import assert_same  # noqa: E402


def _assert_state(js, ts, tag):
    for k in ("row_ids", "counts", "watermarks", "overflowed"):
        assert_same(getattr(js, k), getattr(ts, k), f"{tag}.{k}")


def test_insert_overflow_and_watermarks(rng):
    C, cap, n = 3, 32, 20
    js = JB.BADIndexState.create(C, cap)
    ts = TB.BADIndexState.create(C, cap, device="cpu")
    base = 0
    for step in range(6):
        rows = (base + np.arange(n)).astype(np.int32)
        base += n
        match = rng.random((n, C)) < np.array([0.9, 0.4, 0.1])
        js = JB.insert(js, jnp.asarray(rows), jnp.asarray(match))
        out = TB.insert(ts, torch.as_tensor(rows), torch.as_tensor(match))
        assert out is ts                      # updated in place
        _assert_state(js, ts, f"insert {step}")
        for c in range(C):
            for m in (1, 8, 64):
                a = JB.new_entries(js, c, m)
                b = TB.new_entries(ts, c, m)
                assert_same(a[0], b[0], f"new_entries rows c={c} m={m}")
                assert_same(a[1], b[1], f"new_entries valid c={c} m={m}")
        if step == 2:
            js = JB.advance_watermark(js, 1)
            TB.advance_watermark(ts, 1)
            _assert_state(js, ts, "advance_watermark")
        if step == 4:
            chans = np.array([0, 2], np.int32)
            js = JB.advance_watermarks(js, jnp.asarray(chans))
            TB.advance_watermarks(ts, torch.as_tensor(chans))
            _assert_state(js, ts, "advance_watermarks")
    assert bool(ts.overflowed[0])             # channel 0 ran past capacity
    _assert_state(JB.compact(js), TB.compact(ts), "compact")


def test_insert_with_no_matches_and_full_buffers():
    js = JB.BADIndexState.create(2, 4)
    ts = TB.BADIndexState.create(2, 4, device="cpu")
    for rows, match in ((np.arange(3), np.zeros((3, 2), bool)),
                        (np.arange(3, 10), np.ones((7, 2), bool)),
                        (np.arange(10, 12), np.ones((2, 2), bool))):
        rows = rows.astype(np.int32)
        js = JB.insert(js, jnp.asarray(rows), jnp.asarray(match))
        TB.insert(ts, torch.as_tensor(rows), torch.as_tensor(match))
        _assert_state(js, ts, "insert")
