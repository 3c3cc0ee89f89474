"""Sharded engine pairs for the port's sharded parity tests
(tests/test_torch_sharded*.py): the reference's ``ShardedBADEngine`` on the
4 forced host devices and the port's with every shard on the CPU, built by
the same calls and fed the same ticks, compared shard by shard."""
import collections

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import channel as jch  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core.sharded import ShardedBADEngine as JSharded  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.core.broker import payload_notifications  # noqa: E402
from repro_torch.core.sharded import ShardedBADEngine as TSharded  # noqa: E402

from torch_engine_pairs import _assert_reports, _batcher  # noqa: E402
from torch_parity import assert_same, stats_tuple, to_np  # noqa: E402

PW = 8    # engine default deliver_payload_words
# generous caps: nothing overflows, so pair content is partition-exact
MATRIX_CAPS = dict(dataset_capacity=1024, index_capacity=512,
                   max_window=512, max_candidates=256,
                   brokers=("B1", "B2"), group_cap=8,
                   max_deliver_pairs=1 << 12, max_notify=1 << 14,
                   ring_capacity=1 << 10)
# the oracles' caps on top of OVERFLOW_CAPS: nothing overflows
GENEROUS = dict(max_deliver_pairs=1 << 13, max_notify=1 << 15,
                ring_capacity=1 << 12)
# tight per-shard caps: every tick overflows into the rings and the spill
# queues (whose capacity keeps every overflowed entry)
OVERFLOW_CAPS = dict(dataset_capacity=2048, index_capacity=512,
                     max_window=1024, max_candidates=256,
                     brokers=("B1", "B2"), group_cap=8,
                     max_deliver_pairs=24, max_notify=48, ring_capacity=64,
                     max_spill=1024, spill_capacity=1 << 15)


def pair(num_shards, caps, route=False):
    """(reference, port) sharded engines with the same configuration, both
    surfacing their delivered buffers."""
    je = JSharded(num_shards=num_shards, route_cross_shard=route, **caps)
    te = TSharded(num_shards=num_shards, route_cross_shard=route,
                  device="cpu", **caps)
    je.debug_delivery_buffers = te.debug_delivery_buffers = True
    return je, te


def spec(lib, name):
    return {"drugs": lib.tweets_about_drugs,
            "threat": lib.most_threatening_tweets,
            "crime": lambda: lib.tweets_about_crime(3)}[name]()


def both(je, te, call, *args):
    """One control-plane call on both engines (the port's alone when
    ``je`` is None); equal return values."""
    if je is None:
        return getattr(te, call)(*args)
    x, y = getattr(je, call)(*args), getattr(te, call)(*args)
    if x is not None:
        assert_same(np.asarray(x), np.asarray(y), call)
    return y


def setup(je, te, rng, channels, subs=200, users=24):
    """Users on a 0.5 grid (every distance form exact in float32), the
    channels, and ``subs`` subscriptions on each param channel."""
    loc = (np.round(rng.normal(size=(users, 2)) * 60) / 2).astype(np.float32)
    ub = rng.integers(0, 2, users)
    both(je, te, "set_user_locations", loc, ub)
    for name in channels:
        if je is not None:
            je.create_channel(spec(jch, name))
        te.create_channel(spec(tch, name))
        if spec(tch, name).join == "param":
            both(je, te, "subscribe_bulk", spec(tch, name).name,
                 rng.integers(0, 50, subs), rng.integers(0, 2, subs))


def batches():
    """make_batch for each package: the reference generator's draws, 30%
    drug matches, locations on the 0.5 grid."""
    return (_batcher(JR, lambda R, f, loc: R.RecordBatch.from_numpy(f, loc)),
            _batcher(TR, lambda R, f, loc: R.RecordBatch.from_numpy(
                f, loc, device="cpu")))


def ingest(je, te, rng, n, t0):
    mj, mt = batches()
    if je is not None:
        state = rng.bit_generator.state
        je.ingest(mj(rng, n, t0))
        rng.bit_generator.state = state
    te.ingest(mt(rng, n, t0))


def assert_sharded(a, b, tag):
    """Merged reports equal, every shard's report exact (pair grids,
    counts, DeliveryStats, payload and notify buffers, dtypes included),
    and the routed buffers exact."""
    assert list(a) == list(b), tag
    for name in a:
        x, y = a[name], b[name]
        t = f"{tag} {name}"
        assert (x.num_results, x.num_notified, x.scanned) == \
            (y.num_results, y.num_notified, y.scanned), t
        assert (x.overflow is None) == (y.overflow is None), t
        if x.overflow is not None:
            assert stats_tuple(x.overflow) == stats_tuple(y.overflow), t
        assert len(x.per_shard) == len(y.per_shard), t
        deliver = x.overflow is not None
        for i, (rx, ry) in enumerate(zip(x.per_shard, y.per_shard)):
            _assert_reports({name: rx}, {name: ry}, f"{t} shard {i}",
                            deliver=deliver)
            if deliver and rx.notify is not None:
                assert_same(rx.notify, ry.notify, f"{t} shard {i} notify")
                assert_same(rx.payload, ry.payload, f"{t} shard {i} payload")
        assert (x.routed is None) == (y.routed is None), t
        if x.routed is not None:
            assert_same(x.routed, y.routed, f"{t} routed")


def assert_drained(a, b, tag):
    assert list(a) == list(b), tag
    for key in a:
        assert stats_tuple(a[key].stats) == stats_tuple(b[key].stats), \
            (tag, key)
        for f in ("payload", "notify"):
            x, y = getattr(a[key], f), getattr(b[key], f)
            assert (x is None) == (y is None), (tag, key, f)
            if x is not None:
                assert_same(x, y, f"{tag} {key} {f}")


def counters(eng):
    return [(m.rebuilds, m.patches) for m in eng.per_shard_maintenance()]


def delivered(reports, sink, pw=PW):
    """Fold one tick's per-shard delivered content into ``sink``'s
    (channel, row, sID) pairs and (channel, sID) lists."""
    for name, rep in reports.items():
        for r in rep.per_shard:
            o = r.overflow
            sink["pairs"] += [(name,) + tuple(x) for x in
                              payload_notifications(to_np(r.payload),
                                                    o.delivered_pairs,
                                                    pw).tolist()]
            sink["sids"] += [(name, s) for s in
                             to_np(r.notify)[:o.delivered_sids].tolist()]


def drained(reports, sink, pw=PW, allow_drops=False):
    """Fold DrainReports (keys ``chan`` or ``chan@s{i}[#r{k}]``) into
    ``sink``; exactly-once unless staleness is expected."""
    for key, dr in reports.items():
        name = key.split("@")[0]
        if not allow_drops:
            assert dr.stats.dropped_pairs == dr.stats.dropped_sids == 0, key
        if dr.payload is not None and dr.stats.delivered_pairs:
            sink["pairs"] += [(name,) + tuple(x) for x in
                              payload_notifications(to_np(dr.payload),
                                                    dr.stats.delivered_pairs,
                                                    pw).tolist()]
        if dr.notify is not None and dr.stats.delivered_sids:
            sink["sids"] += [(name, s) for s in to_np(dr.notify)[
                :dr.stats.delivered_sids].tolist()]


def settle(eng, sink, pw=PW):
    """Flush every ring and drain to empty against unchanged tables
    (nothing may drop)."""
    eng.flush_rings()
    rounds = 0
    while eng.spill.pending_pairs() + eng.spill.pending_sids() > 0:
        rounds += 1
        assert rounds < 500, "drain did not converge"
        drained(eng.drain_spilled(), sink, pw)
    assert eng.ring_pending_pairs() + eng.ring_pending_sids() == 0


def sub_multiset(small, big):
    return not (collections.Counter(small) - collections.Counter(big))


def assert_partitioned(eng, name, num_shards):
    """The shards' aggregator-held live sIDs are the registry's population,
    each on its hash shard."""
    from repro_torch.distributed import partition
    live = eng.live_sids(name)
    per_shard = eng.shard_live_sids(name)
    np.testing.assert_array_equal(np.sort(np.concatenate(per_shard)), live)
    owner = partition.shard_for_sids(live, num_shards)
    for i, shard_sids in enumerate(per_shard):
        np.testing.assert_array_equal(shard_sids, np.sort(live[owner == i]))
