"""Port parity for the fused tick's delivery: ring-aware ``deliver_all``
under caps that overflow every tick on each backend, ``drain_spilled``
until both queues are empty, subscription churn that stales ring pairs,
and channel-subset requests."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_engine_pairs import (BACKENDS, PARAM, JPlan, JRequest,  # noqa: E402
                                TPlan, TRequest, _assert_queues,
                                _assert_reports, _drain_round,
                                _drain_until_empty, _engines, _ingest,
                                assert_same)


@pytest.mark.parametrize("backend", BACKENDS)
def test_delivery_rings_and_drain_across_ticks(backend):
    """Caps that overflow every tick, rings of 16: every DeliveryStats field
    (retried and ring counts included), the ring and queue contents and the
    drained buffers equal the reference's over four ticks; then drain both
    queues until empty."""
    je, te, rng = _engines(20 + BACKENDS.index(backend))
    je.debug_delivery_buffers = te.debug_delivery_buffers = True
    for name, plan in zip(PARAM + ("TweetsAboutCrime3",),
                          (("bad_index", True, True), ("window", False, True),
                           ("bad_index", True, True))):
        je.set_plan(name, JPlan(*plan, backend))
        te.set_plan(name, TPlan(*plan, backend))
    for tick in range(4):
        _ingest(je, te, rng, 300, 1 + 500 * tick, match=0.4)
        a = je.execute_all(None, timed=False, deliver=True)
        b = te.execute_all(None, timed=False, deliver=True)
        _assert_reports(a, b, f"tick {tick}", deliver=True)
        _assert_queues(je, te, f"tick {tick}")
        if tick % 2:
            _drain_round(je, te, f"tick {tick}")
    assert te.ring_pending_pairs() + te.ring_pending_sids() > 0
    assert sum(r.overflow.retried_sids for r in b.values()) > 0
    te.flush_rings()
    je.flush_rings()
    _assert_queues(je, te, "flushed")
    _drain_until_empty(je, te, backend)


def test_churn_between_ticks_rebuilds_and_stales_the_ring():
    """Subscription churn between ticks moves epochs: the stacked caches
    are patched in place (equal ``(rebuilds, patches)``) and ring pairs of
    the churned channel go stale (counted) exactly as in the reference; a
    channel-subset request leaves the other rings resident."""
    je, te, rng = _engines(31)
    for eng, plan in ((je, JPlan), (te, TPlan)):
        for name in eng.channels:
            eng.set_plan(name, plan("bad_index", True, True, "oracle"))
    for tick in range(3):
        _ingest(je, te, rng, 300, 1 + 500 * tick, match=0.4)
        if tick:
            gone = np.arange(tick, 200, 7)
            assert je.remove_subscriptions("TweetsAboutDrugs", gone) == \
                te.remove_subscriptions("TweetsAboutDrugs", gone)
        a = je.execute_all(None, timed=False, deliver=True)
        b = te.execute_all(None, timed=False, deliver=True)
        _assert_reports(a, b, f"tick {tick}", deliver=True)
        _assert_queues(je, te, f"tick {tick}")
        assert (je.maintenance.rebuilds, je.maintenance.patches) == \
            (te.maintenance.rebuilds, te.maintenance.patches), tick
    assert te.maintenance.patches > 0
    assert sum(r.overflow.dropped_pairs for r in b.values()) > 0
    req = dict(channels=("MostThreateningTweets",), deliver=True,
               advance=False)
    _assert_reports(je.execute(JRequest(**req)), te.execute(TRequest(**req)),
                    "subset", deliver=True)
    _assert_queues(je, te, "subset")
    for sid_table in (True, False):
        assert_same(je.fused_sids_table("TweetsAboutDrugs", sid_table),
                    te.fused_sids_table("TweetsAboutDrugs", sid_table))


def test_drop_channel_flushes_rings_to_the_queue():
    """Dropping a channel hands every resident ring to the host queue; the
    dropped channel's entries drop at drain time (counted) and the others
    re-deliver, as in the reference."""
    je, te, rng = _engines(77)
    for eng, plan in ((je, JPlan), (te, TPlan)):
        for name in eng.channels:
            eng.set_plan(name, plan("bad_index", True, True, "compact"))
    for tick in range(3):
        _ingest(je, te, rng, 300, 1 + 500 * tick, match=0.4)
        if tick == 2:
            je.drop_channel("MostThreateningTweets")
            te.drop_channel("MostThreateningTweets")
            _assert_queues(je, te, "dropped")
            assert te.ring_pending_pairs() + te.ring_pending_sids() == 0
        _assert_reports(je.execute_all(None, timed=False, deliver=True),
                        te.execute_all(None, timed=False, deliver=True),
                        f"tick {tick}", deliver=True)
        _assert_queues(je, te, f"tick {tick}")
    _drain_until_empty(je, te, "end")
