"""Port parity for churn maintenance: the stacked caches patched in place
(group slots, flat slots, spatial cohorts), the rebuild triggers, and
spatial cohorts on the per-channel and fused paths. Every check runs the
same calls on a reference engine and a port engine on the CPU and compares
exactly: reports, rings, queues, ``fused_sids_table``, and the
``(rebuilds, patches)`` counters after every tick."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_engine_pairs import (PARAM, JFlags, JPlan, TFlags,  # noqa: E402
                                TPlan, _assert_queues, _assert_reports,
                                _drain_round, _drain_until_empty, _engines,
                                _ingest, assert_same, stats_tuple)

CRIME = "TweetsAboutCrime3"


def _counters(eng):
    m = eng.maintenance
    return m.rebuilds, m.patches


def _assert_tick(je, te, a, b, tag):
    _assert_reports(a, b, tag, deliver=True)
    _assert_queues(je, te, tag)
    assert _counters(je) == _counters(te), (tag, je.maintenance,
                                            te.maintenance)
    for name in je.channels:
        for agg in (False, True):
            assert_same(je.fused_sids_table(name, agg),
                        te.fused_sids_table(name, agg), f"{tag} {name}")


def _both(je, te, call, *args):
    """One control-plane call on both engines; equal return values."""
    x, y = getattr(je, call)(*args), getattr(te, call)(*args)
    assert_same(np.asarray(x), np.asarray(y), call)
    return y


# (param-channel plan, spatial plan): slot rows (aggregated), flat stable
# slots, and the compact backend over patched slot rows
FUZZ_PLANS = {
    "slot": (("bad_index", True, True, "oracle"),
             ("bad_index", True, True, "pallas")),
    "flat_slot": (("window", False, True, "pallas"),
                  ("window", False, True, "oracle")),
    "compact": (("bad_index", True, True, "compact_pallas"),
                ("bad_index", False, True, "compact")),
}


def _every(engines, call, *args):
    """One control-plane call on every engine; equal return values."""
    out = [getattr(eng, call)(*args) for eng in engines]
    for x in out[:-1]:
        assert_same(np.asarray(x), np.asarray(out[-1]), call)
    return out[-1]


def _assert_counts(a, b, names, tag):
    """The reports of ``names``: counts, bytes, overflow stats and the
    delivered content (not the result grids, whose padding follows the
    plan-group's shared shape bucket)."""
    for name in names:
        x, y, t = a[name], b[name], f"{tag} {name}"
        assert (x.num_results, x.num_notified, x.scanned) == \
            (y.num_results, y.num_notified, y.scanned), t
        assert_same(x.broker_bytes, y.broker_bytes, f"{t} broker_bytes")
        assert stats_tuple(x.overflow) == stats_tuple(y.overflow), t
        assert np.array_equal(x.payload, y.payload), t
        assert np.array_equal(x.notify, y.notify), t


@pytest.mark.parametrize("layout", list(FUZZ_PLANS))
def test_delta_engine_fuzz_matches_reference(layout):
    """Seeded interleavings of subscribe_bulk / subscribe /
    remove_subscriptions / unsubscribe / cohort churn / ingest under caps
    that overflow every tick, at the pairs' BAD-index capacity of 512,
    which the 1,200 rows the ticks ingest pass. There the reference's
    index drops the entries past its capacity, where the port's engine
    makes room: every channel executes every tick, so its live window
    fits. So the port equals a reference whose index the rows never fill
    (2,048): after every tick the reports (delivered content included),
    rings, queues, every ``fused_sids_table`` and the maintenance counters
    equal its, and steady churn patches (rebuilds flat after the first
    tick). Against the reference at 512, channel by channel, the reports
    are equal until its index overflows in a channel that scans the index
    (a window scan reads the dataset and stays equal); in the tick it
    first does, the port's results are the reference's plus those of the
    entries it dropped (more results, the 2,048 reference's)."""
    seed = 101 + list(FUZZ_PLANS).index(layout)
    je, te, rng = _engines(seed)
    jw = _engines(seed, index_capacity=2048)[0]
    assert je.index_capacity == te.index_capacity == 512
    refs = (je, jw)
    for eng in (*refs, te):
        eng.debug_delivery_buffers = True
    p_plan, s_plan = FUZZ_PLANS[layout]
    # a channel on a window scan reads the dataset, not the BAD index
    scans = {CRIME: s_plan[0], **{name: p_plan[0] for name in PARAM}}
    for name in PARAM:
        for eng in refs:
            eng.set_plan(name, JPlan(*p_plan))
        te.set_plan(name, TPlan(*p_plan))
    for eng in refs:
        eng.set_plan(CRIME, JPlan(*s_plan))
    te.set_plan(CRIME, TPlan(*s_plan))
    _every((*refs, te), "subscribe_users", CRIME, np.arange(0, 24, 2))
    live = {n: list(range(200)) for n in PARAM}
    dropped = {}
    for tick in range(6):
        for _ in range(3):
            op = int(rng.integers(0, 5))
            name = PARAM[int(rng.integers(0, 2))]
            if op == 0:
                n = int(rng.integers(1, 40))
                p, b = rng.integers(0, 50, n), rng.integers(0, 2, n)
                live[name] += _every((*refs, te), "subscribe_bulk", name, p,
                                     b).tolist()
            elif op == 1:
                p, broker = int(rng.integers(0, 50)), ("B1", "B2")[tick % 2]
                live[name].append(int(_every((*refs, te), "subscribe", name,
                                             p, broker)))
            elif op == 2 and live[name]:
                pick = rng.choice(live[name], min(len(live[name]), 30),
                                  replace=False)
                _every((*refs, te), "remove_subscriptions", name, pick)
                live[name] = sorted(set(live[name]) - set(pick.tolist()))
            else:
                _every((*refs, te), "unsubscribe_users", CRIME,
                       rng.integers(0, 24, 4))
                _every((*refs, te), "subscribe_users", CRIME,
                       rng.integers(0, 24, 4))
        _ingest(je, te, rng, 200, 1 + 400 * tick, match=0.4, also=(jw,))
        over = np.asarray(je.index_state.overflowed)
        for name, st in je.channels.items():
            if over[st.index] and scans[name] == "bad_index":
                dropped.setdefault(name, tick)
        assert not np.asarray(jw.index_state.overflowed).any()
        assert not bool(te.index_state.overflowed.any())
        a, w = (eng.execute_all(None, timed=False, deliver=True)
                for eng in refs)
        b = te.execute_all(None, timed=False, deliver=True)
        tag = f"{layout} tick {tick}"
        _assert_tick(jw, te, w, b, tag)
        _assert_counts(a, b, [n for n in a if n not in dropped], tag)
        for name in [n for n, t in dropped.items() if t == tick]:
            assert a[name].num_results < b[name].num_results, (tag, name)
        if tick == 0:
            first = _counters(te)
        if tick % 2:
            _drain_round(jw, te, tag)
            je.drain_spilled()
    if layout == "compact":
        # its seed's rows overflow both param channels' reference index
        assert set(dropped) == set(PARAM), dropped
    assert te.maintenance.rebuilds == first[0], te.maintenance
    assert te.maintenance.patches > first[1], te.maintenance
    jw.flush_rings()
    te.flush_rings()
    _drain_until_empty(jw, te, layout)


def test_capacity_overflow_and_out_of_band_mutation_rebuild_like_reference():
    """Growing past the padded slot capacity, an out-of-band aggregator
    mutation (``invalidate_targets``, no delta) and a delta-log gap each
    rebuild exactly when the reference rebuilds; a small delta patches."""
    je, te, rng = _engines(7)
    for eng, plan in ((je, JPlan), (te, TPlan)):
        for name in eng.channels:
            eng.set_plan(name, plan("bad_index", True, True, "oracle"))
    steps = []
    for tick in range(6):
        if tick == 1:                  # past tmax: thousands of new groups
            p, b = rng.integers(0, 50, 3000), rng.integers(0, 2, 3000)
            _both(je, te, "subscribe_bulk", "TweetsAboutDrugs", p, b)
        elif tick == 2:                # a small delta: patched
            _both(je, te, "remove_subscriptions", "TweetsAboutDrugs",
                  np.arange(0, 60, 3))
        elif tick == 3:                # out of band: no delta recorded
            for eng in (je, te):
                st = eng.channels["MostThreateningTweets"]
                st.aggregator.add_bulk(np.asarray([4, 5], np.int32),
                                       np.asarray([0, 1], np.int32))
                st.user_params.add_bulk(np.asarray([4, 5], np.int32))
                st.invalidate_targets()
        elif tick == 4:                # 65 epochs: the log (64) has a gap
            for _ in range(65):
                _both(je, te, "subscribe", "TweetsAboutDrugs",
                      int(rng.integers(0, 50)), "B1")
        _ingest(je, te, rng, 200, 1 + 400 * tick, match=0.4)
        a = je.execute_all(None, timed=False, deliver=True)
        b = te.execute_all(None, timed=False, deliver=True)
        _assert_tick(je, te, a, b, f"tick {tick}")
        steps.append(_counters(te))
    rebuilds = [s[0] for s in steps]
    assert rebuilds[1] > rebuilds[0]       # capacity
    assert rebuilds[2] == rebuilds[1]      # patched
    assert steps[2][1] > steps[1][1]
    assert rebuilds[3] > rebuilds[2]       # out of band
    assert rebuilds[4] > rebuilds[3]       # log gap


def test_rebuild_engine_and_changed_user_version_rebuild_like_reference():
    """``incremental=False`` rebuilds on every epoch move and a
    ``set_user_locations`` rebuilds the spatial entry, as in the
    reference; cohort creation rebuilds, cohort churn then patches."""
    for incremental in (False, True):
        je, te, rng = _engines(13, incremental)
        counts = []
        for tick in range(4):
            _both(je, te, "remove_subscriptions", "TweetsAboutDrugs",
                  np.arange(tick, 200, 11))
            if tick == 1:
                _both(je, te, "subscribe_users", CRIME, np.arange(10))
            if tick == 2:
                _both(je, te, "unsubscribe_users", CRIME, [1, 2])
                _both(je, te, "subscribe_users", CRIME, [20])
            if tick == 3:
                users = np.zeros((30, 2), np.float32)
                je.set_user_locations(users)
                te.set_user_locations(users)
            _ingest(je, te, rng, 200, 1 + 400 * tick, match=0.4)
            a = je.execute_all(JFlags("bad_index", True, True), timed=False,
                               deliver=True)
            b = te.execute_all(TFlags("bad_index", True, True), timed=False,
                               deliver=True)
            _assert_tick(je, te, a, b, f"incremental={incremental} {tick}")
            counts.append(_counters(te))
        if not incremental:
            assert all(c[1] == 0 for c in counts), counts


def _cohort_view(eng):
    st = eng.channels[CRIME]
    return (st.epoch, st.user_epoch, st.cohort.num_slots,
            st.cohort.num_users, st.cohort.slot_uids().tolist(),
            [(e, sorted(d)) for e, d in st.user_delta_log])


def test_cohort_parity_per_channel_and_fused():
    """``subscribe_users`` / ``unsubscribe_users`` give the reference's
    slots (freed slots reused last-freed-first), epoch bumps (creation
    bumps even with no new id) and the ``identity`` flip of the stacked
    user sets; the per-channel and fused paths deliver the same GLOBAL
    user ids, and spilled cohort pairs drain against the cohort table."""
    je, te, rng = _engines(55, max_notify=6)
    je.debug_delivery_buffers = te.debug_delivery_buffers = True
    assert je.unsubscribe_users(CRIME, [1]) == te.unsubscribe_users(
        CRIME, [1]) == 0
    with pytest.raises(ValueError, match="not a spatial channel"):
        te.subscribe_users("TweetsAboutDrugs", [0])
    with pytest.raises(ValueError, match="out of"):
        te.subscribe_users(CRIME, [24])
    names = (CRIME,)
    _ingest(je, te, rng, 300, 1, match=0.4)
    te.execute_all(TFlags(), timed=False, advance=False)
    je.execute_all(JFlags(), timed=False, advance=False)
    assert te._stacked_cache[("spatial", names)].identity
    assert _both(je, te, "subscribe_users", CRIME, []) == 0   # creation
    assert _cohort_view(je) == _cohort_view(te)
    _both(je, te, "subscribe_users", CRIME, [3, 9, 4, 9, 17, 22, 0])
    _both(je, te, "unsubscribe_users", CRIME, [9, 0, 5])
    _both(je, te, "subscribe_users", CRIME, [11, 12, 13])
    assert _cohort_view(je) == _cohort_view(te)
    flags = (JFlags("bad_index", False, False), TFlags("bad_index", False,
                                                       False))
    for tick in range(3):
        _ingest(je, te, rng, 300, 500 + 400 * tick, match=0.4)
        for backend in ("oracle", "pallas", "compact"):
            x = je.execute_channel(CRIME, flags[0], advance=False,
                                   deliver=True, backend=backend)
            y = te.execute_channel(CRIME, flags[1], advance=False,
                                   deliver=True, backend=backend)
            assert_same(x.result.pair_targets, y.result.pair_targets)
            assert (x.num_results, x.num_notified) == (y.num_results,
                                                       y.num_notified)
            assert stats_tuple(x.overflow) == stats_tuple(y.overflow)
        _assert_queues(je, te, f"per-channel {tick}")
        a = je.execute_all(None, timed=False, deliver=True)
        b = te.execute_all(None, timed=False, deliver=True)
        _assert_tick(je, te, a, b, f"fused {tick}")
        assert not te._stacked_cache[("spatial", names)].identity
        # delivered sIDs are global user ids of the cohort, never slots
        got = b[CRIME].notify[:b[CRIME].overflow.delivered_sids]
        cohort = set(te.channels[CRIME].cohort.slot_uids().tolist())
        assert set(got.tolist()) <= cohort - {-1}
        _drain_round(je, te, f"fused {tick}")
        _both(je, te, "unsubscribe_users", CRIME, [3, 4])
        _both(je, te, "subscribe_users", CRIME, [3, 21])
    assert sum(r.overflow.delivered_sids for r in b.values()) > 0
    _drain_until_empty(je, te, "cohort")
