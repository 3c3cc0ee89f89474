"""Port parity for the fused multi-channel tick: ``execute_all`` / ``execute``
on the same engine built in both packages by the same calls, over every scan
mode x layout x backend on the incremental engine; heterogeneous plan
assignments, a plan switch that migrates a ring, ``flush_rings`` and drains
until both queues are empty. Delivery across ticks is
tests/test_torch_fused_delivery.py."""
import pytest

pytest.importorskip("torch")

from torch_engine_pairs import (JPlan, TPlan,  # noqa: E402
                                _assert_queues, _assert_reports,
                                _drain_round, _drain_until_empty, _engines,
                                _ingest, check_every_scan_layout_backend)


def test_every_scan_layout_backend():
    """The incremental engine (slot / flat_slot layouts); the rebuild
    engine's run is tests/test_torch_fused_rebuild.py, in its own file so
    the two run on separate test workers."""
    check_every_scan_layout_backend(incremental=True)


def test_heterogeneous_plans_switch_and_flush():
    """Two plan-groups in one call; then a plan switch migrates the old
    group's ring into the queue; drains interleave with ticks."""
    je, te, rng = _engines(30)
    a_plan = ("bad_index", True, True, "compact")
    b_plan = ("window", False, True, "oracle")
    for name, plan in (("TweetsAboutDrugs", a_plan),
                       ("MostThreateningTweets", b_plan),
                       ("TweetsAboutCrime3", a_plan)):
        je.set_plan(name, JPlan(*plan))
        te.set_plan(name, TPlan(*plan))
    assert {n: p.to_dict() for n, p in te.plan_assignment().items()} == \
        {n: p.to_dict() for n, p in je.plan_assignment().items()}
    for tick in range(5):
        if tick == 3:        # switch: the compact group's rings migrate
            for eng, plan in ((je, JPlan), (te, TPlan)):
                assert eng.set_plan("TweetsAboutDrugs", plan(*b_plan))
                assert not eng.set_plan("TweetsAboutDrugs", plan(*b_plan))
        _ingest(je, te, rng, 250, 1 + 500 * tick, match=0.4)
        a = je.execute_all(None, timed=False, deliver=True)
        b = te.execute_all(None, timed=False, deliver=True)
        _assert_reports(a, b, f"tick {tick}", deliver=True)
        _assert_queues(je, te, f"tick {tick}")
        _drain_round(je, te, f"drain {tick}")
    je.flush_rings()
    te.flush_rings()
    _assert_queues(je, te, "flushed")
    _drain_until_empty(je, te, "end")
