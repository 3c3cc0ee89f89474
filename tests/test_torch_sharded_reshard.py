"""Port parity for ``ShardedBADEngine.reshard``
(``repro_torch/core/sharded.py``) against the reference's on the 4 forced
host devices (the port's shards all on the CPU): a 2 -> 4 reshard under
churn and overflow, with rings populated and an ingest after it. The
drained reports and every later tick equal the reference's, nothing
drops, the settled sID multiset equals a generous-cap single-shard
oracle's, and each new shard owns its own dataset and index tensors (two
or more shards on one device included)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402

from torch_parity import assert_same  # noqa: E402
from torch_sharded_pairs import (GENEROUS, OVERFLOW_CAPS,  # noqa: E402
                                 assert_drained, assert_partitioned,
                                 assert_sharded, both, delivered, drained,
                                 ingest, pair, settle, setup, sub_multiset)

FLAGS = ("window", True, True)


def _owned(eng):
    """Every tensor of every shard's dataset and index state, by storage."""
    ptrs = []
    for e in eng.shards:
        for state in (e.dataset, e.index_state):
            for t in vars(state).values():
                ptrs.append(t.untyped_storage().data_ptr())
    return ptrs


@pytest.mark.multidevice
def test_reshard_conservation_and_owned_state(multidevice):
    """Resharding 2 -> 4 after the third tick, rings populated: the drained
    reports equal the reference's and drop nothing; every new shard owns
    its dataset and index tensors (no storage shared with another shard),
    so the ingest after the reshard appends once per shard; later ticks'
    reports equal the reference's; the settled sID multiset equals the
    oracle's, the pairs a sub-multiset; the live population is the
    registry's, each sID on its hash shard."""
    rng = np.random.default_rng(11)
    je, te = pair(2, OVERFLOW_CAPS)
    setup(je, te, rng, ("drugs", "crime"))
    live = list(range(200))
    sink = {"pairs": [], "sids": []}
    ring_at_reshard = 0
    for tick in range(6):
        new = both(je, te, "subscribe_bulk", "TweetsAboutDrugs",
                   rng.integers(0, 50, 40), rng.integers(0, 2, 40))
        live += new.tolist()
        gone = [live.pop(int(rng.integers(0, len(live)))) for _ in range(20)]
        both(je, te, "remove_subscriptions", "TweetsAboutDrugs",
             np.asarray(gone))
        ingest(je, te, rng, 120, 100 * (tick + 1))
        size = te.shards[0].size_host
        assert all(e.size_host == size and int(e.dataset.size) == size
                   for e in te.shards)
        a = je.execute_all(JFlags(*FLAGS), timed=False, deliver=True)
        b = te.execute_all(TFlags(*FLAGS), timed=False, deliver=True)
        assert_sharded(a, b, f"tick {tick}")
        delivered(b, sink)
        if tick == 2:
            ring_at_reshard = te.ring_pending_pairs() + te.ring_pending_sids()
            da, db = je.reshard(4), te.reshard(4)
            assert_drained(da, db, "reshard")
            drained(db, sink)
            assert te.num_shards == len(te.shards) == 4
            ptrs = _owned(te)
            assert len(set(ptrs)) == len(ptrs), "shards share state"
            for x, y in zip(je.shards, te.shards):
                assert_same(np.asarray(x.dataset.fields), y.dataset.fields)
                assert_same(np.asarray(x.index_state.row_ids),
                            y.index_state.row_ids)
                assert y.size_host == int(x.dataset.size)
    assert ring_at_reshard > 0, "the reshard must find rings populated"
    jsink = {"pairs": [], "sids": []}
    settle(je, jsink)
    rest = {"pairs": [], "sids": []}
    settle(te, rest)
    assert sorted(jsink["sids"]) == sorted(rest["sids"])
    want_pairs, want_sids = _reshard_oracle()
    assert sorted(sink["sids"] + rest["sids"]) == want_sids
    assert sub_multiset(sink["pairs"] + rest["pairs"], want_pairs)
    assert_partitioned(te, "TweetsAboutDrugs", 4)
    for x, y in zip(je.shard_live_sids("TweetsAboutDrugs"),
                    te.shard_live_sids("TweetsAboutDrugs")):
        assert_same(x, y)


def _reshard_oracle():
    """The reshard test's workload on one port shard with generous caps:
    its (channel, row, sID) pairs and sorted (channel, sID) list."""
    rng = np.random.default_rng(11)
    _, te = pair(1, dict(OVERFLOW_CAPS, **GENEROUS))
    setup(None, te, rng, ("drugs", "crime"))
    live = list(range(200))
    sink = {"pairs": [], "sids": []}
    for tick in range(6):
        live += te.subscribe_bulk("TweetsAboutDrugs",
                                  rng.integers(0, 50, 40),
                                  rng.integers(0, 2, 40)).tolist()
        gone = [live.pop(int(rng.integers(0, len(live)))) for _ in range(20)]
        te.remove_subscriptions("TweetsAboutDrugs", np.asarray(gone))
        ingest(None, te, rng, 120, 100 * (tick + 1))
        b = te.execute_all(TFlags(*FLAGS), timed=False, deliver=True)
        for rep in b.values():
            assert rep.overflow.spilled_sids + rep.overflow.dropped_sids == 0
        delivered(b, sink)
    return sink["pairs"], sorted(sink["sids"])
