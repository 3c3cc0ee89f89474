"""The benchmark's frozen generators give the program's arrays bit for bit
(as the program stands when they were frozen)."""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bad_bench import traffic as T  # noqa: E402
from repro_torch.core import churn as C  # noqa: E402
from repro_torch.data import synthetic as S  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("n", [1, 513, 8192])
def test_tweet_arrays_and_tweak_equal_the_program(n):
    a = T.tweet_arrays(np.random.default_rng(7), n, 11)
    b = S.tweet_arrays(np.random.default_rng(7), n, 11)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))
    fa = T.drug_tweak(a[0].copy(), np.random.default_rng(8), 0.05)
    fb = S.drug_tweak(b[0].copy(), np.random.default_rng(8), 0.05)
    assert np.array_equal(fa, fb)


def test_subscriptions_equal_the_program():
    a = T.subscriptions_by_population(np.random.default_rng(3), 10_000, 4)
    b = S.subscriptions_by_population(np.random.default_rng(3), 10_000, 4)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(a, b))


def test_retweet_override_is_real_worlds():
    src = (ROOT / "benchmarks" / "real_world.py").read_text()
    assert ("np.where(rng.random(f.shape[0]) < 0.05,\n"
            "                                     rng.integers(100_001, "
            "5_000_000, f.shape[0]),\n"
            "                                     rng.integers(0, 100_001, "
            "f.shape[0]))") in src
    f = np.zeros((4096, T.NUM_FIELDS), np.int32)
    T.trending_retweets(f, np.random.default_rng(1))
    big = f[:, T.RETWEET_COUNT] > 100_000
    assert 0.03 < big.mean() < 0.07


def test_live_pool_equals_the_program():
    a, b = T.LivePool(np.arange(50, dtype=np.int32)), \
        C._LivePool(np.arange(50, dtype=np.int32))
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for i in range(20):
        a.add(np.arange(100 + 7 * i, 107 + 7 * i, dtype=np.int32))
        b.add(np.arange(100 + 7 * i, 107 + 7 * i, dtype=np.int32))
        assert np.array_equal(a.sample_remove(ra, 9),
                              b.sample_remove(rb, 9))
        assert a.n == b.n and np.array_equal(a.buf[:a.n], b.buf[:b.n])


class _Recorder:
    """Stands in for the engine under ``core/churn._Tally.churn``: records
    each call, numbers new sIDs as the aggregator does."""

    def __init__(self, users, next_sid):
        self.user_locations = np.zeros((users, 2), np.float32)
        self.next_sid = dict(next_sid)
        self.calls = []

    def subscribe_bulk(self, ch, params, brokers):
        n = len(params)
        sids = np.arange(self.next_sid[ch], self.next_sid[ch] + n,
                         dtype=np.int32)
        self.next_sid[ch] += n
        self.calls.append(("subscribe_bulk", ch, sids, params, brokers))
        return sids

    def remove_subscriptions(self, ch, sids):
        self.calls.append(("remove_subscriptions", ch, np.asarray(sids)))
        return len(sids)

    def subscribe_users(self, ch, uids):
        self.calls.append(("subscribe_users", ch, np.asarray(uids)))
        return len(uids)

    def unsubscribe_users(self, ch, uids):
        self.calls.append(("unsubscribe_users", ch, np.asarray(uids)))
        return len(uids)


def test_churn_batches_equal_run_ticks():
    spec = {"rounds": 4, "workloads": [
        {"channel": "A", "adds": 25, "removes": 25, "user_channel": "U",
         "user_churn": 8},
        {"channel": "B", "adds": 5, "removes": 5}]}
    initial = {"A": 300, "B": 60}
    ours = T.Churn(9, spec, initial, {"A": 50, "B": 50}, 4, 100)
    eng = _Recorder(100, initial)
    wl = [C.ChurnWorkload("A", 25, 25, num_brokers=4, user_channel="U",
                          user_churn_per_tick=8),
          C.ChurnWorkload("B", 5, 5, num_brokers=4)]
    live = C._live_pools(wl, {k: np.arange(v, dtype=np.int32)
                              for k, v in initial.items()})
    rng = T.rng_for(9, T.CHURN)
    for _ in range(3):
        want = ours.tick()
        eng.calls.clear()
        C._Tally().churn(eng, wl, live, rng, 4, True)
        assert len(want) == len(eng.calls)
        for m, call in zip(want, eng.calls):
            assert (m.op, m.channel) == call[:2]
            assert np.array_equal(m.ids, call[2])
            if m.op == "subscribe_bulk":
                assert np.array_equal(m.params, call[3])
                assert np.array_equal(m.brokers, call[4])


def test_seeds_past_64_bits_and_negative_key_the_streams():
    for seed in (2 ** 31 + 5, 2 ** 70 + 1, -3):
        a = T.batch(seed, T.POOL, 0, 64, 0, "paper", 0.05)
        b = T.batch(seed, T.POOL, 0, 64, 0, "paper", 0.05)
        assert np.array_equal(a[0], b[0])
    assert not np.array_equal(T.batch(1, T.POOL, 0, 64, 0, "paper", 0)[0],
                              T.batch(2, T.POOL, 0, 64, 0, "paper", 0)[0])
