"""Synthetic EnrichedTweets streams (paper §5.1/§5.4) and the LM token
stream, numpy-generated.

Field distributions reproduce the paper's stated selectivities: predicates
I-III are 50% each, IV-V are 20% each; states follow a US-census-like skew
so subscription aggregation sees realistic group sizes (§5.2). The same
generator calls with the same ``numpy.random.Generator`` state give the
same arrays as the reference package, so both packages can be fed
identical batches; ``TokenStream`` gives the reference's token batches bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core import records as R
from repro_torch.device import DeviceLike

# Rough relative US state populations (50 entries, normalized at use).
STATE_WEIGHTS = np.array([
    39, 30, 22, 21, 13, 12.8, 11.8, 10.8, 10.7, 10.0,
    9.3, 8.9, 7.9, 7.3, 7.2, 6.9, 6.3, 6.2, 6.1, 5.9,
    5.8, 5.1, 4.9, 4.6, 4.5, 4.4, 3.4, 3.2, 3.2, 3.1,
    3.0, 2.9, 2.3, 2.2, 2.1, 2.0, 1.9, 1.9, 1.8, 1.5,
    1.4, 1.3, 1.1, 1.1, 1.0, 0.97, 0.91, 0.78, 0.65, 0.58,
])

LANG_WEIGHTS = np.array([0.62, 0.18, 0.08, 0.06, 0.06])  # en, pt, es, ar, ja


def tweet_arrays(rng: np.random.Generator, n: int, t0: int,
                 rate_per_s: int = 2000) -> Tuple[np.ndarray, np.ndarray]:
    """One ingest window of EnrichedTweets as host arrays:
    (fields (n, F) int32, location (n, 2) float32)."""
    f = np.zeros((n, R.ENRICHED_TWEET_SCHEMA.num_fields), dtype=np.int32)
    f[:, R.STATE] = rng.choice(50, size=n, p=STATE_WEIGHTS / STATE_WEIGHTS.sum())
    f[:, R.ABOUT_COUNTRY] = (rng.random(n) > 0.5).astype(np.int32)         # I: 50%
    f[:, R.RETWEET_COUNT] = np.where(rng.random(n) < 0.5,                   # II: 50%
                                     rng.integers(10001, 200000, n),
                                     rng.integers(0, 10001, n))
    f[:, R.HATE_SPEECH_RATE] = np.where(rng.random(n) < 0.5,                # III: 50%
                                        rng.integers(6, 11, n),
                                        rng.integers(0, 6, n))
    f[:, R.THREATENING_RATE] = np.where(rng.random(n) < 0.2,                # IV: 20%
                                        rng.integers(6, 11, n),
                                        rng.integers(0, 6, n))
    f[:, R.WEAPON_MENTIONED] = (rng.random(n) < 0.2).astype(np.int32)       # V: 20%
    f[:, R.DRUG_ACTIVITY] = rng.integers(0, 5, n)
    f[:, R.LANG] = rng.choice(5, size=n, p=LANG_WEIGHTS)
    f[:, R.COUNTRY] = rng.integers(0, 200, n)
    f[:, R.TIMESTAMP] = t0 + (np.arange(n) // max(1, rate_per_s))
    loc = rng.uniform(-100, 100, size=(n, 2)).astype(np.float32)
    return f, loc


def tweet_batch(rng: np.random.Generator, n: int, t0: int,
                rate_per_s: int = 2000,
                device: DeviceLike = "cuda") -> R.RecordBatch:
    """``tweet_arrays`` as a RecordBatch on ``device``."""
    f, loc = tweet_arrays(rng, n, t0, rate_per_s)
    return R.RecordBatch.from_numpy(f, loc, device=device)


def drug_tweak(batch_fields: np.ndarray, rng: np.random.Generator,
               match_rate: float = 0.1) -> np.ndarray:
    """Force a fraction of records to match TweetsAboutDrugs' fixed preds
    (mutates and returns the host array)."""
    n = batch_fields.shape[0]
    hit = rng.random(n) < match_rate
    batch_fields[hit, R.THREATENING_RATE] = 10
    batch_fields[hit, R.DRUG_ACTIVITY] = 3
    return batch_fields


def subscriptions_by_population(rng: np.random.Generator, n: int,
                                num_brokers: int = 1
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """1M-style subscription set skewed by state population (paper §5.2)."""
    params = rng.choice(50, size=n, p=STATE_WEIGHTS / STATE_WEIGHTS.sum())
    brokers = rng.integers(0, num_brokers, n)
    return params.astype(np.int32), brokers.astype(np.int32)


# ---------------------------------------------------------------------------
# LM token pipeline (sharded-host loading pattern)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic next-token stream: each host generates only its
    shard (seeded by (host_id, step)), mirroring per-host data loading.
    Batches are numpy int32 arrays; the caller moves them to its device."""

    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    def batch(self, step: int) -> dict:
        per_host = self.global_batch // self.num_hosts
        rng = np.random.default_rng(
            (self.seed, self.host_id, step, 0xBADDA7A))
        # Markov-ish structure so the LM has something learnable.
        base = rng.integers(0, self.vocab_size, (per_host, self.seq_len + 1))
        run = rng.random((per_host, self.seq_len + 1)) < 0.5
        toks = base.copy()
        for t in range(1, self.seq_len + 1):
            toks[:, t] = np.where(run[:, t],
                                  (toks[:, t - 1] + 1) % self.vocab_size,
                                  toks[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
