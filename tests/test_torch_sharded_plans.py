"""Port parity for ``repro_torch/core/sharded.py``, continued: a subset of
the plan matrix (every scan mode, the padded and the compact backends) on
two shards against the reference's two, report for report, delivering the
port's single-shard content; and ``drop_channel`` against the reference's
(see ``test_torch_sharded.py``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import channel as jch  # noqa: E402
from repro.core.plans import ChannelPlan as JPlan  # noqa: E402
from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core.plans import ChannelPlan as TPlan  # noqa: E402
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402

from torch_parity import assert_same  # noqa: E402
from torch_sharded_pairs import (MATRIX_CAPS, assert_partitioned,  # noqa: E402
                                 assert_sharded, both, delivered, ingest,
                                 pair, setup)

FLAGS = ("window", True, True)
CRIME = "TweetsAboutCrime3"


# one plan per scan mode, padded and compact backends both covered:
# (scan, aggregation, param backend, spatial backend)
MATRIX = [("full", False, "oracle", "oracle"),
          ("window", True, "compact", "oracle"),
          ("trad_index", True, "oracle", "oracle"),
          ("bad_index", False, "compact", "oracle")]


def _matrix_run(num_shards, case):
    """The seeded matrix workload on the port (and, with two shards, the
    reference beside it): TweetsAboutDrugs under the case's plan, the
    spatial channel under the same scan mode, 2 delivered ticks, no
    overflow. Returns the delivered (row, sID) and sID multisets."""
    scan, agg, backend, spatial = case
    rng = np.random.default_rng(5)
    je, te = pair(num_shards, MATRIX_CAPS)
    if num_shards == 1:
        je = None
    setup(je, te, rng, ("drugs", "crime"), subs=250)
    for eng, Plan in ((je, JPlan), (te, TPlan)):
        if eng is not None:
            eng.set_plan("TweetsAboutDrugs", Plan(scan, agg, True, backend))
            eng.set_plan(CRIME, Plan(scan, agg, True, spatial))
    sink = {"pairs": [], "sids": []}
    for tick in range(2):
        ingest(je, te, rng, 150, 100 * (tick + 1))
        b = te.execute_all(None, timed=False, deliver=True)
        if je is not None:
            a = je.execute_all(None, timed=False, deliver=True)
            assert_sharded(a, b, f"{case} tick {tick}")
        for rep in b.values():
            for r in rep.per_shard:
                o = r.overflow
                assert o.spilled_pairs + o.dropped_pairs + o.spilled_sids \
                    + o.dropped_sids == 0, (case, o)
        delivered(b, sink)
    return sorted(sink["pairs"]), sorted(sink["sids"])


@pytest.mark.multidevice
@pytest.mark.parametrize("case", MATRIX, ids=lambda c: f"{c[0]}-{c[2]}")
def test_plan_matrix_subset_matches_reference(multidevice, case):
    """Two shards against the reference's two, report for report, and the
    delivered (row, sID) and sID multisets equal the port's single-shard
    engine's: sharding is a physical layout choice."""
    two, one = _matrix_run(2, case), _matrix_run(1, case)
    assert two == one
    assert len(two[1]) > 0


@pytest.mark.multidevice
def test_drop_channel_matches_reference(multidevice):
    """Dropping one channel leaves the other's partitioned population
    intact (registry == union of the shards' aggregators, each on its hash
    shard, equal to the reference's); the name can be re-created and the
    next tick's reports equal the reference's."""
    rng = np.random.default_rng(23)
    je, te = pair(4, MATRIX_CAPS)
    setup(je, te, rng, ("drugs", "threat"))
    gone = both(je, te, "subscribe_bulk", "MostThreateningTweets",
                rng.integers(0, 50, 100), rng.integers(0, 2, 100))[:40]
    both(je, te, "remove_subscriptions", "MostThreateningTweets", gone)
    before = te.live_sids("MostThreateningTweets")
    je.drop_channel("TweetsAboutDrugs")
    te.drop_channel("TweetsAboutDrugs")
    assert_same(je.live_sids("MostThreateningTweets"),
                te.live_sids("MostThreateningTweets"))
    np.testing.assert_array_equal(te.live_sids("MostThreateningTweets"),
                                  before)
    for x, y in zip(je.shard_live_sids("MostThreateningTweets"),
                    te.shard_live_sids("MostThreateningTweets")):
        assert_same(x, y)
    assert_partitioned(te, "MostThreateningTweets", 4)
    je.create_channel(jch.tweets_about_drugs())
    te.create_channel(tch.tweets_about_drugs())
    both(je, te, "subscribe_bulk", "TweetsAboutDrugs",
         rng.integers(0, 50, 50), rng.integers(0, 2, 50))
    ingest(je, te, rng, 80, 500)
    a = je.execute_all(JFlags(*FLAGS), timed=False, deliver=True)
    b = te.execute_all(TFlags(*FLAGS), timed=False, deliver=True)
    assert set(b) == {"TweetsAboutDrugs", "MostThreateningTweets"}
    assert_sharded(a, b, "after drop")
