"""Port parity for ``repro_torch/core/sharded.py``: the port's
``ShardedBADEngine`` (every shard on the CPU) against the reference's on the
4 forced host devices, on the same calls and data. Shard by shard the
reports are exact (pair grids, counts, ``DeliveryStats``, payload and
notify buffers, dtypes included), ``routed`` is exact, the per-shard
``(rebuilds, patches)`` equal the reference's, and a
facade of one shard equals the plain engine. The plan matrix and
``drop_channel`` are in ``test_torch_sharded_plans.py``; churn, overflow
and ``reshard`` in ``test_torch_sharded_churn.py`` (three files, so that
``--dist loadfile`` spreads the reference's compiles over workers)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.plans import ChannelPlan as JPlan  # noqa: E402
from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core.engine import BADEngine  # noqa: E402
from repro_torch.core.plans import ChannelPlan as TPlan  # noqa: E402
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402
from repro_torch.core.runtime import EngineProtocol  # noqa: E402
from repro_torch.core.sharded import ShardedBADEngine  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402

from torch_parity import assert_same, stats_tuple  # noqa: E402
from torch_sharded_pairs import (MATRIX_CAPS, OVERFLOW_CAPS,  # noqa: E402
                                 assert_drained, assert_partitioned,
                                 assert_sharded, batches, both, counters,
                                 delivered, ingest, pair, setup)

FLAGS = ("window", True, True)
CRIME = "TweetsAboutCrime3"


@pytest.mark.multidevice
def test_per_shard_reports_routed_and_counters_match_reference(multidevice):
    """Four shards with routing on, caps that overflow every tick, churn
    (subscriptions and the cohort) between the two ticks: every tick's reports
    shard by shard, ``routed``, the drains, the rings and queues and the
    per-shard maintenance counters equal the reference's; ``routed`` holds
    exactly the delivered sIDs, each row only sIDs its shard's brokers
    own."""
    rng = np.random.default_rng(31)
    je, te = pair(4, OVERFLOW_CAPS, route=True)
    setup(je, te, rng, ("drugs", "crime"))
    live = list(range(200))
    for tick in range(2):
        if tick:
            new = both(je, te, "subscribe_bulk", "TweetsAboutDrugs",
                       rng.integers(0, 50, 30), rng.integers(0, 2, 30))
            live += new.tolist()
            gone = rng.choice(live, 25, replace=False)
            both(je, te, "remove_subscriptions", "TweetsAboutDrugs", gone)
            both(je, te, "unsubscribe_users", CRIME, rng.integers(0, 24, 4))
            both(je, te, "subscribe_users", CRIME, rng.integers(0, 24, 4))
        ingest(je, te, rng, 150, 1 + 400 * tick)
        a = je.execute_all(JFlags(*FLAGS), timed=False, deliver=True)
        b = te.execute_all(TFlags(*FLAGS), timed=False, deliver=True)
        assert_sharded(a, b, f"tick {tick}")
        assert counters(je) == counters(te), tick
        assert (je.ring_pending_pairs(), je.ring_pending_sids()) == \
            (te.ring_pending_pairs(), te.ring_pending_sids()), tick
        sink = {"pairs": [], "sids": []}
        delivered(b, sink)
        for name, rep in b.items():
            sids = [s for n, s in sink["sids"] if n == name]
            routed = rep.routed[rep.routed >= 0]
            assert rep.routed.shape == (4, 4 * OVERFLOW_CAPS["max_notify"])
            assert rep.routed.dtype == np.int32
            assert sorted(routed.tolist()) == sorted(sids)
            brokers = (te._user_brokers if name == CRIME
                       else te._reg[name].brokers)
            for o in range(4):
                row = rep.routed[o][rep.routed[o] >= 0]
                assert (partition.broker_owner(brokers[row], 4) == o).all()
        assert_drained(je.drain_spilled(), te.drain_spilled(), tick)
        assert (je.spill.pending_pairs(), je.spill.pending_sids()) == \
            (te.spill.pending_pairs(), te.spill.pending_sids())
    assert sum(p for _, p in counters(te)) > 0
    assert te.maintenance.rebuilds == je.maintenance.rebuilds


def _port_batch(rng, n, t0):
    return batches()[1](rng, n, t0)


def test_facade_matches_plain_engine():
    """The num_shards=1 facade equals the port's plain BADEngine
    buffer for buffer: the sharded control plane adds global sID
    allocation and nothing else."""
    def drive(eng):
        rng = np.random.default_rng(17)
        eng.debug_delivery_buffers = True
        eng.create_channel(tch.tweets_about_drugs())
        eng.subscribe_bulk("TweetsAboutDrugs", rng.integers(0, 50, 120),
                           rng.integers(0, 2, 120))
        out = []
        for tick in range(2):
            eng.ingest(_port_batch(rng, 100, 100 * (tick + 1)))
            out.append(eng.execute_all(TFlags(*FLAGS), timed=False,
                                       deliver=True)["TweetsAboutDrugs"])
        return out
    plain = drive(BADEngine(device="cpu", **MATRIX_CAPS))
    facade = drive(ShardedBADEngine(num_shards=1, device="cpu",
                                    **MATRIX_CAPS))
    for p, f in zip(plain, facade):
        s = f.per_shard[0]
        assert (f.num_results, f.num_notified, f.scanned) == \
            (p.num_results, p.num_notified, p.scanned)
        assert stats_tuple(f.overflow) == stats_tuple(p.overflow)
        assert_same(p.payload, s.payload)
        assert_same(p.notify, s.notify)


def test_devices_and_protocol():
    """Shard i runs on ``devices[i % len(devices)]``; every shard engine
    gets its device explicitly; the facade satisfies ``EngineProtocol``;
    CUDA without a card raises instead of running on the CPU."""
    eng = ShardedBADEngine(num_shards=3, device=["cpu", torch.device("cpu")],
                           **MATRIX_CAPS)
    assert isinstance(eng, EngineProtocol)
    assert [e.device.type for e in eng.shards] == ["cpu"] * 3
    assert eng.device == eng.shard_device(2) == torch.device("cpu")
    with pytest.raises(ValueError):
        ShardedBADEngine(num_shards=0, device="cpu")
    with pytest.raises(ValueError, match="explicit sids"):
        eng.create_channel(tch.tweets_about_drugs())
        eng.subscribe("TweetsAboutDrugs", 3, "B1", sid=7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedBADEngine(num_shards=2)
