"""Traffic of the benchmark's cells, generated from ``--seed``.

Frozen copies of the stream and subscription generators the port ships
(``repro_torch.data.synthetic``: ``tweet_arrays``, ``drug_tweak``,
``subscriptions_by_population``; ``benchmarks/real_world.py``'s retweet
override; ``repro_torch.core.churn``'s churn batches and ``_LivePool``), so
a change to the program cannot change what the benchmark offers it. The
tests hold the copies bit for bit against the program's generators as they
stand.

Every array is drawn from ``numpy.random.Generator`` streams keyed by the
seed and a purpose, so the reference regenerates any of them after the
window without storing them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# EnrichedTweet field positions (repro_torch.core.records)
(STATE, ABOUT_COUNTRY, RETWEET_COUNT, THREATENING_RATE, HATE_SPEECH_RATE,
 WEAPON_MENTIONED, DRUG_ACTIVITY, LANG, COUNTRY, TIMESTAMP) = range(10)
NUM_FIELDS = 10
FIELDS = {"about_country": ABOUT_COUNTRY, "retweet_count": RETWEET_COUNT,
          "hate_speech_rate": HATE_SPEECH_RATE,
          "threatening_rate": THREATENING_RATE,
          "weapon_mentioned": WEAPON_MENTIONED,
          "drug_activity": DRUG_ACTIVITY, "state": STATE, "lang": LANG,
          "country": COUNTRY, "timestamp": TIMESTAMP}
STREAM_RATE = 2000      # tweets a second of the stream's timestamps (§5.1)

# rough relative US state populations (paper §5.2's skew)
STATE_WEIGHTS = np.array([
    39, 30, 22, 21, 13, 12.8, 11.8, 10.8, 10.7, 10.0,
    9.3, 8.9, 7.9, 7.3, 7.2, 6.9, 6.3, 6.2, 6.1, 5.9,
    5.8, 5.1, 4.9, 4.6, 4.5, 4.4, 3.4, 3.2, 3.2, 3.1,
    3.0, 2.9, 2.3, 2.2, 2.1, 2.0, 1.9, 1.9, 1.8, 1.5,
    1.4, 1.3, 1.1, 1.1, 1.0, 0.97, 0.91, 0.78, 0.65, 0.58,
])
LANG_WEIGHTS = np.array([0.62, 0.18, 0.08, 0.06, 0.06])  # en, pt, es, ar, ja

# purposes of the seeded streams (the second word of each key)
SUBS, USERS, PRELOAD, POOL, CHURN, COHORT, SAMPLE = range(7)


def rng_for(seed: int, purpose: int, *more: int) -> np.random.Generator:
    """The generator of one purpose; any whole-number seed, negative or
    past 64 bits included, keys it."""
    return np.random.default_rng([int(seed) % 2 ** 64, purpose, *more])


def tweet_arrays(rng: np.random.Generator, n: int, t0: int,
                 rate_per_s: int = 2000) -> Tuple[np.ndarray, np.ndarray]:
    """One ingest window of EnrichedTweets: (fields (n, 10) int32,
    location (n, 2) float32)."""
    f = np.zeros((n, NUM_FIELDS), dtype=np.int32)
    f[:, STATE] = rng.choice(50, size=n, p=STATE_WEIGHTS / STATE_WEIGHTS.sum())
    f[:, ABOUT_COUNTRY] = (rng.random(n) > 0.5).astype(np.int32)
    f[:, RETWEET_COUNT] = np.where(rng.random(n) < 0.5,
                                   rng.integers(10001, 200000, n),
                                   rng.integers(0, 10001, n))
    f[:, HATE_SPEECH_RATE] = np.where(rng.random(n) < 0.5,
                                      rng.integers(6, 11, n),
                                      rng.integers(0, 6, n))
    f[:, THREATENING_RATE] = np.where(rng.random(n) < 0.2,
                                      rng.integers(6, 11, n),
                                      rng.integers(0, 6, n))
    f[:, WEAPON_MENTIONED] = (rng.random(n) < 0.2).astype(np.int32)
    f[:, DRUG_ACTIVITY] = rng.integers(0, 5, n)
    f[:, LANG] = rng.choice(5, size=n, p=LANG_WEIGHTS)
    f[:, COUNTRY] = rng.integers(0, 200, n)
    f[:, TIMESTAMP] = t0 + (np.arange(n) // max(1, rate_per_s))
    loc = rng.uniform(-100, 100, size=(n, 2)).astype(np.float32)
    return f, loc


def drug_tweak(fields: np.ndarray, rng: np.random.Generator,
               match_rate: float = 0.1) -> np.ndarray:
    """Force a share of records to match TweetsAboutDrugs' fixed predicates
    (mutates and returns ``fields``)."""
    hit = rng.random(fields.shape[0]) < match_rate
    fields[hit, THREATENING_RATE] = 10
    fields[hit, DRUG_ACTIVITY] = 3
    return fields


def trending_retweets(fields: np.ndarray, rng: np.random.Generator,
                      share: float = 0.05) -> np.ndarray:
    """``benchmarks/real_world.py``'s override: ``retweet_count`` above
    100,000 for ``share`` of the tweets (mutates and returns ``fields``)."""
    n = fields.shape[0]
    fields[:, RETWEET_COUNT] = np.where(rng.random(n) < share,
                                        rng.integers(100_001, 5_000_000, n),
                                        rng.integers(0, 100_001, n))
    return fields


def subscriptions_by_population(rng: np.random.Generator, n: int,
                                num_brokers: int = 1
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """(params, brokers) of ``n`` subscriptions keyed by state, skewed by
    population (paper §5.2)."""
    params = rng.choice(50, size=n, p=STATE_WEIGHTS / STATE_WEIGHTS.sum())
    brokers = rng.integers(0, num_brokers, n)
    return params.astype(np.int32), brokers.astype(np.int32)


def subscriptions_uniform(rng: np.random.Generator, n: int, domain: int,
                          num_brokers: int) -> Tuple[np.ndarray, np.ndarray]:
    """(params, brokers) of ``n`` subscriptions keyed uniformly over
    ``domain`` values (the trending channels' countries)."""
    params = rng.integers(0, domain, n).astype(np.int32)
    return params, rng.integers(0, num_brokers, n).astype(np.int32)


STREAMS = {"paper": None, "trending": trending_retweets}


def batch(seed: int, purpose: int, index: int, n: int, t0: int,
          stream: str, tweak: float) -> Tuple[np.ndarray, np.ndarray]:
    """Batch ``index`` of a purpose (the pre-load's chunks or the pool of
    tick batches): the stream's fields and locations, with the drug tweak
    at ``tweak`` (none at 0)."""
    rng = rng_for(seed, purpose, index)
    f, loc = tweet_arrays(rng, n, t0)
    if STREAMS[stream] is not None:
        STREAMS[stream](f, rng)
    if tweak:
        drug_tweak(f, rng, tweak)
    return f, loc


def initial_subscriptions(cfg: Dict, seed: int) -> Dict[str, tuple]:
    """Each param channel's initial (params, brokers), sIDs 0, 1, ..."""
    out = {}
    for i, ch in enumerate(cfg["channels"]):
        if ch["join"] != "param":
            continue
        rng = rng_for(seed, SUBS, i)
        if ch["keys"] == "population":
            out[ch["name"]] = subscriptions_by_population(
                rng, ch["subscriptions"], cfg["brokers"])
        else:
            out[ch["name"]] = subscriptions_uniform(
                rng, ch["subscriptions"], ch["param_domain"], cfg["brokers"])
    return out


def users(cfg: Dict, seed: int) -> tuple:
    """(locations (U, 2) float32, brokers (U,) int32) of the users."""
    rng = rng_for(seed, USERS)
    n = cfg["users"]
    locs = rng.uniform(-100, 100, (n, 2)).astype(np.float32)
    return locs, rng.integers(0, cfg["brokers"], n).astype(np.int32)


def initial_cohort(cfg: Dict, cell: Dict, seed: int) -> Optional[np.ndarray]:
    c = cell.get("cohort")
    if not c:
        return None
    return rng_for(seed, COHORT).choice(cfg["users"], c["users"],
                                            replace=False).astype(np.int32)


def tick_rows(cfg: Dict, cell: Dict, k: int) -> int:
    """Row id of tick ``k``'s first record (the pre-load holds rows
    0 .. preload - 1)."""
    return cfg["preload_rows"] + k * cell["tweets_per_tick"]


def tick_t0(cfg: Dict, cell: Dict, k: int) -> int:
    return 1 + (cfg["preload_rows"] // STREAM_RATE) + k * 100


class Pool:
    """The cell's tick batches: ``pool`` distinct batches drawn from the
    seed, tick ``k`` takes batch ``k mod pool`` with its own timestamps."""

    def __init__(self, cfg: Dict, cell: Dict, seed: int):
        n = cell["tweets_per_tick"]
        self.batches = [batch(seed, POOL, j, n, 0, cfg["stream"],
                                cell.get("tweak", 0.0))
                        for j in range(cell["pool"])]
        self.offsets = (np.arange(n) // STREAM_RATE).astype(np.int32)
        self.cfg, self.cell = cfg, cell

    def get(self, k: int) -> tuple:
        f, loc = self.batches[k % len(self.batches)]
        f[:, TIMESTAMP] = tick_t0(self.cfg, self.cell, k) + self.offsets
        return f, loc


def preload_chunks(cfg: Dict):
    n = cfg["preload_rows"]
    chunk = min(n, cfg["preload_chunk"])
    return [(i, chunk) for i in range(n // chunk)]


def preload_batch(cfg: Dict, cell: Dict, seed: int, i: int, chunk: int):
    f, loc = batch(seed, PRELOAD, i, chunk,
                     1 + (i * chunk) // STREAM_RATE, cfg["stream"],
                     cell.get("tweak", 0.0))
    return f, loc



def sample_ticks(seed: int, first: int, seconds: float, tick_s: float,
                 n: int) -> set:
    """``n`` ticks of the window drawn from the seed, among the first
    four fifths of the ticks the warm-up's pace predicts."""
    expect = max(1, int(0.8 * seconds / max(tick_s, 1e-6)))
    rng = rng_for(seed, SAMPLE)
    picks = rng.choice(expect, size=min(n, expect), replace=False)
    return {first + int(p) for p in picks}


class LivePool:
    """``core/churn._LivePool``: amortized append and O(k) swap-remove
    sample over the live sIDs."""

    def __init__(self, init: np.ndarray):
        self.n = len(init)
        self.buf = np.empty((max(1024, 2 * self.n),), np.int32)
        self.buf[:self.n] = init

    def add(self, new: np.ndarray) -> None:
        need = self.n + len(new)
        if need > len(self.buf):
            nb = np.empty((max(need, 2 * len(self.buf)),), np.int32)
            nb[:self.n] = self.buf[:self.n]
            self.buf = nb
        self.buf[self.n:need] = new
        self.n = need

    def sample_remove(self, rng: np.random.Generator,
                      n_rm: int) -> np.ndarray:
        """Remove about ``n_rm`` random live sIDs (duplicates in the draw
        collapse) and return them."""
        pick = np.unique(rng.integers(0, self.n, n_rm))
        out = self.buf[pick].copy()
        k = len(pick)
        n0 = self.n - k
        mark = np.zeros((k,), bool)
        mark[pick[pick >= n0] - n0] = True
        self.buf[pick[pick < n0]] = self.buf[n0:self.n][~mark]
        self.n = n0
        return out


@dataclasses.dataclass
class Mutation:
    """One control-plane call of a churn round, as the engine receives it:
    ``op`` is ``subscribe_bulk``, ``remove_subscriptions``,
    ``unsubscribe_users`` or ``subscribe_users``."""

    op: str
    channel: str
    ids: np.ndarray                  # sIDs added or removed, or user ids
    params: np.ndarray = None        # subscribe_bulk only
    brokers: np.ndarray = None


class Churn:
    """The churn mix of ``core/churn.run_ticks``: per round, per channel,
    bulk adds then bulk removes of live sIDs; on the cohort channel, users
    out then users in. New sIDs are numbered by the benchmark, after the
    channel's initial ones, so the reference knows every subscription
    without reading the program."""

    def __init__(self, seed: int, churn: Dict, initial: Dict[str, int],
                 domains: Dict[str, int], num_brokers: int, num_users: int):
        self.rng = rng_for(seed, CHURN)
        self.spec = churn
        self.domains = domains
        self.num_brokers = num_brokers
        self.num_users = num_users
        self.live = {name: LivePool(np.arange(n, dtype=np.int32))
                     for name, n in initial.items()}
        self.next_sid = dict(initial)

    def tick(self) -> List[Mutation]:
        """The control-plane calls of one tick, in order."""
        out, rng = [], self.rng
        for _ in range(self.spec["rounds"]):
            for w in self.spec["workloads"]:
                name, adds = w["channel"], w["adds"]
                if adds:
                    params = rng.integers(0, self.domains[name],
                                          adds).astype(np.int32)
                    brokers = rng.integers(0, self.num_brokers,
                                           adds).astype(np.int32)
                    sids = np.arange(self.next_sid[name],
                                     self.next_sid[name] + adds,
                                     dtype=np.int32)
                    self.next_sid[name] += adds
                    self.live[name].add(sids)
                    out.append(Mutation("subscribe_bulk", name, sids,
                                        params, brokers))
                n_rm = min(w["removes"], self.live[name].n)
                if n_rm:
                    out.append(Mutation("remove_subscriptions", name,
                                        self.live[name].sample_remove(
                                            rng, n_rm)))
                k = w.get("user_churn", 0)
                if k:
                    out.append(Mutation("unsubscribe_users",
                                        w["user_channel"],
                                        rng.integers(0, self.num_users, k)))
                    out.append(Mutation("subscribe_users", w["user_channel"],
                                        rng.integers(0, self.num_users, k)))
        return out
