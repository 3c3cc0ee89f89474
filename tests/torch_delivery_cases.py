"""Inputs of ``deliver_all`` from one numpy generator, for the tests of the
``deliver`` kernel against its plain version (CPU and card alike). Imports
neither JAX nor the reference package."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import broker, plans

I32 = np.int32


def group_table(rng, c: int, t: int, s: int) -> np.ndarray:
    """(C, T, S) int32 sID rows, each a -1-padded prefix of random length
    (empty rows and full rows included)."""
    n = rng.integers(0, s + 1, (c, t))
    n[:, :1] = s
    if t > 1:
        n[:, 1] = 0
    sids = rng.integers(0, 2 ** 31 - 1, (c, t, s), dtype=I32)
    return np.where(np.arange(s)[None, None] < n[..., None], sids, -1)


def case(rng, C: int, rm: int, max_t: int, *, table: str = "group",
         T: int = 24, S: int = 7, density: float = 0.3,
         max_pairs: int = 16, max_notify: int = 64, spill_cap: int = 5,
         payload_words: int = 3, brokers: int = 4, counts: str = "given",
         caps: Optional[str] = None, ring: Optional[int] = None,
         stale: float = 0.3, device="cpu") -> dict:
    """Keyword arguments of one ``deliver_all`` call on ``device``.

    ``table``: "group" (a (C, T, S) table), "identity" ((C, 0): the target
    is the sID), "empty" ((C, 0, S): a group table with no row). ``counts``:
    "given" (each row's live sIDs), "none" (the callee counts), "past"
    (some counts past S, so members repeat the row's last word). ``caps``:
    None, "low", "at" or "high" per-channel caps against what each channel
    produces. ``ring``: the ring's window (None: ring-less), pre-loaded
    with entries of which about ``stale`` carry an old epoch."""
    n_t = 0 if table == "empty" else T
    valid = rng.random((C, rm, max_t)) < density
    valid[:, :, -1] &= rng.random((C, rm)) < 0.5
    tg = rng.integers(0, max(n_t, 1), (C, rm, max_t), dtype=I32)
    if table == "identity":
        tg = rng.integers(-2, 3 * max_notify, (C, rm, max_t), dtype=I32)
    rows = rng.integers(0, 1 << 30, (C, rm, max_t), dtype=I32)
    rows = np.where(valid, rows, -1)
    tg = np.where(valid, tg, -1)
    if table == "identity":
        sids = np.zeros((C, 0), I32)
        cnt = None
    else:
        sids = group_table(rng, C, n_t, S)
        cnt = (sids >= 0).sum(-1).astype(I32)
        if counts == "past":
            cnt = (cnt + (rng.random(cnt.shape) < 0.3) * (S + 2)).astype(I32)
    tb = rng.integers(0, brokers, (C, max(n_t, 1) if table != "identity"
                                   else 3 * max_notify), dtype=I32)
    if table == "identity":
        members = (valid & (tg >= 0)).sum((1, 2))
    else:
        members = np.array([cnt[c][np.clip(tg[c][valid[c]], 0,
                                           max(n_t - 1, 0))].sum()
                            if n_t else 0 for c in range(C)])
    pairs = valid.sum((1, 2))
    args = dict(payload_words=payload_words, max_pairs=max_pairs,
                max_notify=max_notify, spill_cap=spill_cap)
    if caps is not None:
        pick = {"low": lambda n: n // 2, "at": lambda n: n,
                "high": lambda n: n + 3}[caps]
        args["caps_pairs"] = torch.as_tensor([pick(int(n)) for n in pairs],
                                             dtype=torch.int32)
        args["caps_notify"] = torch.as_tensor(
            [pick(int(n)) for n in members], dtype=torch.int32)
    dev = torch.device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    zero = torch.zeros((C,), dtype=torch.int32, device=dev)
    result = plans.ChannelResult(
        t(rows), t(tg), t(valid), t(np.zeros((C, rm), I32)),
        t(np.zeros((C, rm), bool)), zero, zero, zero,
        t(np.zeros((C, brokers), I32)), t(np.zeros((C, brokers), I32)))
    args.update(result=result, group_sids=t(sids),
                target_brokers=t(tb), num_brokers=brokers,
                counts=None if cnt is None or counts == "none" else t(cnt))
    for k in ("caps_pairs", "caps_notify"):
        if k in args:
            args[k] = args[k].to(dev)
    if ring is not None:
        epochs = rng.integers(1, 5, C).astype(I32)
        pc = rng.integers(0, ring + 1, C).astype(I32)
        pc[0] = ring
        ep = np.where(rng.random((C, ring)) < stale, epochs[:, None] - 1,
                      epochs[:, None]).astype(I32)
        r_rows = rng.integers(0, 1 << 30, (C, ring), dtype=I32)
        r_tgts = rng.integers(0, max(n_t, 1), (C, ring), dtype=I32)
        if table == "identity":
            r_tgts = rng.integers(0, 3 * max_notify, (C, ring), dtype=I32)
        sc = rng.integers(0, ring + 1, C).astype(I32)
        sc[-1] = ring
        r_sids = rng.integers(0, 1 << 30, (C, ring), dtype=I32)
        live = np.arange(ring)[None] < pc[:, None]
        args["ring"] = broker.RetryRing(
            t(np.where(live, r_rows, -1)), t(np.where(live, r_tgts, -1)),
            t(np.where(live, ep, 0)), t(pc),
            t(np.where(np.arange(ring)[None] < sc[:, None], r_sids, -1)),
            t(sc))
        args["epochs"] = [int(e) for e in epochs]
    return args


# every case the tests hold the kernel to its plain version on: (name,
# keyword arguments of ``case``)
CASES = [
    ("ringless-group", dict(C=2, rm=9, max_t=5)),
    ("ringless-identity", dict(C=1, rm=20, max_t=16, table="identity",
                               max_notify=200, max_pairs=128)),
    ("ringless-empty-table", dict(C=2, rm=6, max_t=4, table="empty")),
    ("ringless-counts-none", dict(C=3, rm=7, max_t=3, counts="none")),
    ("ringless-counts-past", dict(C=2, rm=7, max_t=6, counts="past")),
    ("caps-low", dict(C=3, rm=11, max_t=4, caps="low", max_pairs=64,
                      max_notify=400)),
    ("caps-at", dict(C=2, rm=11, max_t=4, caps="at", max_pairs=64,
                     max_notify=400)),
    ("caps-high", dict(C=2, rm=11, max_t=4, caps="high", max_pairs=64,
                       max_notify=400)),
    ("ring-group", dict(C=2, rm=10, max_t=6, ring=6)),
    ("ring-identity", dict(C=3, rm=12, max_t=16, table="identity", ring=8,
                           max_notify=40, max_pairs=24)),
    ("ring-stale", dict(C=2, rm=10, max_t=4, ring=12, stale=0.7)),
    ("ring-past-the-spill", dict(C=3, rm=40, max_t=8, ring=4, max_pairs=8,
                                 max_notify=24, spill_cap=3)),
    ("ring-caps-low", dict(C=2, rm=30, max_t=4, ring=6, caps="low",
                           max_pairs=64, max_notify=300)),
    ("ring-caps-high", dict(C=1, rm=30, max_t=4, ring=6, caps="high",
                            max_pairs=64, max_notify=300)),
    ("ring-counts-none", dict(C=2, rm=9, max_t=5, ring=5, counts="none")),
    ("wide-vector", dict(C=2, rm=64, max_t=64, S=40, payload_words=8,
                         max_pairs=512, max_notify=4096, density=0.05,
                         ring=16)),
    ("wide-scalar", dict(C=2, rm=64, max_t=64, S=41, payload_words=8,
                         max_pairs=512, max_notify=4095, density=0.05,
                         ring=16)),
    ("big-groups", dict(C=2, rm=32, max_t=16, T=8, S=300, payload_words=8,
                        max_pairs=300, max_notify=20000, density=0.2,
                        ring=64, spill_cap=100)),
    ("big-groups-overflow", dict(C=2, rm=32, max_t=16, T=8, S=300,
                                 payload_words=8, max_pairs=40,
                                 max_notify=6000, density=0.2, ring=64,
                                 spill_cap=100)),
    ("many-tiles", dict(C=2, rm=600, max_t=32, table="identity",
                        max_pairs=4096, max_notify=8192, density=0.02,
                        ring=32)),
    # more valid pairs than lines in every channel: no line is dead
    ("every-line-live", dict(C=2, rm=40, max_t=16, S=40, payload_words=8,
                             max_pairs=96, max_notify=2048, density=0.5,
                             ring=8)),
]


def small_engine(device, seed: int, plans_by_channel=None, **caps):
    """A port-only engine (two param channels, 200 subscriptions each, and
    TweetsAboutCrime3 over 24 users) on ``device``, with small delivery
    buffers so that rings and spills fill; and its generator."""
    from repro_torch.core import channel
    from repro_torch.core.engine import BADEngine
    rng = np.random.default_rng(seed)
    common = dict(dataset_capacity=1024, index_capacity=512, max_window=512,
                  max_candidates=128, brokers=("B1", "B2"),
                  max_deliver_pairs=24, max_notify=90, max_spill=12,
                  spill_capacity=150, group_cap=8, ring_capacity=16)
    common.update(caps)
    eng = BADEngine(device=device, **common)
    eng.create_channel(channel.tweets_about_drugs())
    eng.create_channel(channel.most_threatening_tweets())
    eng.create_channel(channel.tweets_about_crime(3))
    for name in ("TweetsAboutDrugs", "MostThreateningTweets"):
        eng.subscribe_bulk(name, rng.integers(0, 50, 200),
                           rng.integers(0, 2, 200))
    users = (np.round(rng.normal(size=(24, 2)) * 60) / 2).astype(np.float32)
    eng.set_user_locations(users, rng.integers(0, 2, 24))
    for name, plan in (plans_by_channel or {}).items():
        eng.set_plan(name, plan)
    return eng, rng


def ingest(eng, rng, n: int, t0: int, match: float = 0.4) -> None:
    """One batch of ``n`` tweets, a share ``match`` of them made to match
    TweetsAboutDrugs."""
    from repro_torch.core import records
    from repro_torch.data import synthetic
    f, loc = synthetic.tweet_arrays(rng, n, t0)
    f = synthetic.drug_tweak(f, rng, match)
    loc = (np.round(loc * 2) / 2).astype(np.float32)
    eng.ingest(records.RecordBatch.from_numpy(f, loc, device=eng.device))


# the param plan-group of paper-1m as the fused tick delivers it: two
# channels of 16,384 stream entries x 16 targets, 10,240-sID frames, 8
# payload words, 131,072 wire lines and 2^25 notify slots a channel, a
# 4,096-entry ring and 8,192 spill slots; a few thousand live pairs
PARAM_GROUP = dict(C=2, rm=16384, max_t=16, T=2048, S=10240, density=0.0115,
                   max_pairs=131072, max_notify=2 ** 25, spill_cap=8192,
                   payload_words=8, ring=4096, stale=0.1)
# the same shape with more valid pairs than wire lines in each channel:
# every one of the 262,144 lines is live
PARAM_GROUP_FULL = dict(PARAM_GROUP, density=0.6)
