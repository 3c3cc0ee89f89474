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


def test_make_room_shifts_only_what_would_overflow(rng):
    """``make_room`` before an insert that would pass a channel's capacity
    moves that channel's live window to the front (its delivered entries
    go, as in ``compact``), so the insert drops nothing; a channel that
    fits keeps its buffer as it is, and one never executed (watermark 0)
    overflows as ``insert`` says. The executed channels' watermark windows
    read as in an index of four times the capacity."""
    C, cap, n = 3, 32, 12
    ts = TB.BADIndexState.create(C, cap, device="cpu")
    big = TB.BADIndexState.create(C, 4 * cap, device="cpu")
    base, shifted, seen_full = 0, 0, set()
    for step in range(6):
        rows = torch.as_tensor((base + np.arange(n)).astype(np.int32))
        base += n
        match = torch.as_tensor(rng.random((n, C)) < np.array([0.9, 0.2,
                                                               0.8]))
        before = ts.row_ids.clone()
        old = ts.counts.clone()
        room = (ts.counts + match.sum(0, dtype=torch.int32) > cap) & (
            ts.watermarks > 0)
        most, full = TB.make_room(ts, match)
        TB.insert(ts, rows, match)
        TB.insert(big, rows, match)
        # the bound leaves out the channels the insert overflowed, and
        # those hold watermark 0: nothing to shift until an execution
        rest = np.setdiff1d(np.arange(C), full)
        assert most == (int(ts.counts[rest].max()) if rest.size else 0)
        seen_full.update(full.tolist())
        assert all(int(ts.counts[c]) == cap and int(ts.watermarks[c]) == 0
                   and bool(ts.overflowed[c]) for c in full)
        for c in range(C):
            if bool(room[c]):
                shifted += 1
            else:
                k = int(old[c])
                assert torch.equal(ts.row_ids[c, :k], before[c, :k])
        for c in range(2):
            want = TB.new_entries(big, c, 4 * cap)
            got = TB.new_entries(ts, c, 4 * cap)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        assert not bool(ts.overflowed[:2].any())
        chans = torch.as_tensor([0, 1], dtype=torch.int32)
        TB.advance_watermarks(ts, chans)
        TB.advance_watermarks(big, chans)
    assert shifted > 0 and seen_full == {2}
    assert bool(ts.overflowed[2]) and int(ts.watermarks[2]) == 0


def test_engine_makes_room_in_its_index_and_drops_nothing():
    """An engine whose BAD index holds fewer entries than its ticks add up
    to notifies, tick for tick, what one with a large index notifies: the
    executed channels' delivered entries make room."""
    from torch_delivery_cases import ingest, small_engine
    engines = [small_engine("cpu", 5, index_capacity=cap)[0]
               for cap in (96, 4096)]
    rngs = [np.random.default_rng(9) for _ in engines]
    for tick in range(8):
        reps = []
        for eng, r in zip(engines, rngs):
            ingest(eng, r, 120, 1 + 200 * tick)
            reps.append(eng.execute_all(None, timed=False))
        assert {k: (v.num_results, v.num_notified) for k, v in
                reps[0].items()} == {k: (v.num_results, v.num_notified)
                                     for k, v in reps[1].items()}, tick
        assert not bool(engines[0].index_state.overflowed.any())
    assert int(engines[1].index_state.counts.max()) > 96


def test_a_full_channel_costs_the_engine_one_read_not_one_an_ingest():
    """Channels never executed fill their index and overflow (watermark 0:
    nothing to shift); after the read that finds them full, ingests read
    the counts no more. Once an execution moves their watermarks, the next
    ingest reads once and makes room, and nothing more is dropped."""
    from repro_torch.core import trace
    from torch_delivery_cases import ingest, small_engine
    eng, rng = small_engine("cpu", 4, index_capacity=512)

    def reads(ticks, t0):
        trace.collect()
        trace.enable()
        try:
            for k in range(ticks):
                ingest(eng, rng, 40, t0 + 100 * k, match=0.9)
        finally:
            trace.disable()
        return sum(r.name == "read.index_counts" for r in trace.collect())

    # the two param channels take about 37 of every 40 rows, the spatial
    # one about 4: the first two fill, the third stays far from full
    assert reads(16, 1) >= 1
    full = eng.index_state.overflowed.tolist()
    assert full == [True, True, False], full
    assert reads(6, 2000) == 0
    eng.execute_all(None, timed=False)
    assert reads(1, 3000) == 1
    assert not bool(eng.index_state.overflowed.any())
