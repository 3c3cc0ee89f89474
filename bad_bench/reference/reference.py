"""The plain reference of a BAD deployment: what every tick of a run must
produce, worked out from the configuration, the cell and the seed alone.

It keeps plain, un-aggregated subscriptions (sID -> state or country,
broker, live) and the spatial channel's users, replays the cell's churn
batches on them, evaluates each channel's fixed predicates on the regenerated
batches with numpy, and joins:

- a param channel notifies every live subscription whose key equals the
  record's key field, on the subscription's broker;
- a spatial channel pairs a record with every user (of its cohort, where it
  has one) within the radius, ``(t.t + u.u) - 2 t.u < r^2`` evaluated
  operation by operation in float32, the precision the configuration
  states; each pair notifies the user's id on the user's broker.

It imports nothing of the program and takes nothing the program made: the
batches, subscriptions and users come from ``bad_bench.traffic`` and the
seed. The spatial products run in blocks on the device given (the card once
the program's state is freed, or the CPU).

``narrow=True`` is the control: the same computation one precision step
down, record fields as int16 (a narrowing cast wraps) and locations and
distances in bfloat16, the storage a later change could be tempted to use.

For a scored deployment ``plain_scores`` scores, with the plain scorer the
configuration names (``bad_bench/reference/scorers/``), every record that
gives a channel a pair on a sampled tick, on weights it draws from the seed
itself.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

import numpy as np
import torch

from bad_bench import traffic as T

OPS = {"==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
       ">": np.greater, ">=": np.greater_equal}
SID_BITS = 26           # a (row, sID) pair's key: row << SID_BITS | sID


@dataclasses.dataclass
class Expected:
    """What the reference says a run must show."""

    # tick -> channel -> (matched rows, results (spatial) or None,
    #                     notified, notified per broker (B,), results per
    #                     broker (spatial) or records with a subscriber on
    #                     the broker (param))
    ticks: List[Dict[str, tuple]]
    # tick -> [(op, channel, expected return)]
    control: List[List[tuple]]
    # sampled tick -> channel -> (sorted (row, sID) keys, sorted sIDs,
    #                             sID -> broker table)
    sampled: Dict[int, Dict[str, tuple]]
    ring_fields: np.ndarray
    ring_location: np.ndarray
    rows: int


class _Channel:
    def __init__(self, ch: Dict, narrow: bool):
        self.ch = ch
        self.name = ch["name"]
        self.spatial = ch["join"] == "spatial"
        self.preds = [(T.FIELDS[f], OPS[op], v) for f, op, v in ch["predicates"]]
        self.key = None if self.spatial else T.FIELDS[ch["param_field"]]
        self.narrow = narrow

    def match(self, f: np.ndarray) -> np.ndarray:
        ok = np.ones(f.shape[0], bool)
        for field, op, v in self.preds:
            x = f[:, field]
            if self.narrow:
                x = x.astype(np.int16)
            ok &= op(x, v)
        return ok


class _Subs:
    """A param channel's plain subscriptions."""

    def __init__(self, params, brokers, domain: int, num_brokers: int):
        n = len(params)
        self.param = np.array(params, np.int32)
        self.broker = np.array(brokers, np.int32)
        self.live = np.ones(n, bool)
        self.count = np.zeros((domain, num_brokers), np.int64)
        np.add.at(self.count, (self.param, self.broker), 1)

    def add(self, sids, params, brokers) -> int:
        need = int(sids.max()) + 1
        if need > len(self.param):
            grow = max(need, 2 * len(self.param))
            for name, fill in (("param", 0), ("broker", 0), ("live", False)):
                old = getattr(self, name)
                new = np.full(grow, fill, old.dtype)
                new[:len(old)] = old
                setattr(self, name, new)
        fresh = ~self.live[sids]
        self.param[sids], self.broker[sids] = params, brokers
        self.live[sids] = True
        np.add.at(self.count, (params[fresh], brokers[fresh]), 1)
        return int(fresh.sum())

    def remove(self, sids) -> int:
        u = np.unique(sids)
        u = u[(u < len(self.live))]
        gone = u[self.live[u]]
        self.live[gone] = False
        np.add.at(self.count, (self.param[gone], self.broker[gone]), -1)
        return len(gone)


def _hits(rows_loc: np.ndarray, users: np.ndarray, radius: float, dev,
          narrow: bool) -> torch.Tensor:
    """(R, U) bool: the spatial predicate, operation by operation."""
    dt = torch.bfloat16 if narrow else torch.float32
    t = torch.as_tensor(rows_loc, device=dev).to(dt)
    u = torch.as_tensor(users, device=dev).to(dt)
    t0, t1 = t[:, 0:1], t[:, 1:2]
    u0, u1 = u[None, :, 0], u[None, :, 1]
    dist2 = (t0 * t0 + t1 * t1 + (u0 * u0 + u1 * u1)) \
        - torch.tensor(2.0, dtype=dt, device=dev) * (t0 * u0 + t1 * u1)
    r2 = torch.tensor(np.float32(radius) ** 2, device=dev).to(dt)
    return dist2 < r2


def _sorted(x, dev) -> np.ndarray:
    return torch.sort(torch.as_tensor(x, device=dev))[0].cpu().numpy()


def expected(cfg: Dict, cell: Dict, seed: int, n_ticks: int,
             sampled: set, dev, narrow: bool = False) -> Expected:
    """The reference's account of ticks 0 .. n_ticks - 1 of a run."""
    chans = [_Channel(ch, narrow) for ch in cfg["channels"]]
    nb = cfg["brokers"]
    subs = {name: _Subs(p, b, ch.ch["param_domain"], nb)
            for ch in chans if not ch.spatial
            for name, (p, b) in [(ch.name,
                                  T.initial_subscriptions(cfg, seed)[ch.name])]}
    ulocs, ubrokers = T.users(cfg, seed)
    if narrow:
        ulocs = torch.as_tensor(ulocs).to(torch.bfloat16).float().numpy()
    cohort_ch = (cell.get("cohort") or {}).get("channel")
    cohort = None
    if cohort_ch is not None:
        cohort = np.zeros(cfg["users"], bool)
        cohort[T.initial_cohort(cfg, cell, seed)] = True
    churn = None
    if cell.get("churn"):
        churn = T.Churn(seed, cell["churn"],
                        {n: len(s.param) for n, s in subs.items()},
                        {c.name: c.ch.get("param_domain", 0) for c in chans},
                        nb, cfg["users"])
    pool = T.Pool(cfg, cell, seed)
    n = cell["tweets_per_tick"]
    out_ticks, out_control, out_sampled = [], [], {}
    for k in range(n_ticks):
        control = []
        for m in (churn.tick() if churn is not None else []):
            if m.op == "subscribe_bulk":
                want = subs[m.channel].add(m.ids, m.params, m.brokers)
            elif m.op == "remove_subscriptions":
                want = subs[m.channel].remove(m.ids)
            elif m.op == "subscribe_users":
                u = np.unique(m.ids)
                want = int((~cohort[u]).sum())
                cohort[u] = True
            else:
                u = np.unique(m.ids)
                want = int(cohort[u].sum())
                cohort[u] = False
            control.append((m.op, m.channel, want))
        out_control.append(control)
        f, loc = pool.get(k)
        row0 = T.tick_rows(cfg, cell, k)
        per = {}
        keep = k in sampled
        got_sampled = {}
        for c in chans:
            hit_rows = c.match(f)
            idx = np.flatnonzero(hit_rows)
            if c.spatial:
                uid = (np.flatnonzero(cohort) if c.name == cohort_ch
                       else np.arange(cfg["users"]))
                h = _hits(loc[idx], ulocs[uid], c.ch["radius"], dev, narrow)
                per_user = h.sum(0).cpu().numpy()
                rb = np.bincount(ubrokers[uid], weights=per_user,
                                 minlength=nb).astype(np.int64)
                total = int(per_user.sum())
                per[c.name] = (len(idx), total, total, rb, rb)
                if keep:
                    r, u = torch.nonzero(h, as_tuple=True)
                    r = torch.as_tensor(row0 + idx, device=dev)[r].long()
                    u = torch.as_tensor(uid, device=dev)[u].long()
                    got_sampled[c.name] = (
                        _sorted((r << SID_BITS) | u, dev), _sorted(u, dev),
                        ubrokers)
                continue
            s = subs[c.name]
            key = f[idx, c.key]
            if narrow:
                key = key.astype(np.int16).astype(np.int64)
            key = np.clip(key, 0, s.count.shape[0] - 1)
            nb_k = s.count[key].sum(0) if len(idx) else np.zeros(nb, np.int64)
            # records a broker has any subscriber of (the fewest lines)
            lines_b = ((s.count[key] > 0).sum(0) if len(idx)
                       else np.zeros(nb, np.int64))
            per[c.name] = (len(idx), None, int(nb_k.sum()), nb_k, lines_b)
            if keep:
                live = np.flatnonzero(s.live)
                order = np.argsort(s.param[live], kind="stable")
                by = live[order]
                start = np.searchsorted(s.param[by], np.arange(
                    s.count.shape[0]))
                stop = np.searchsorted(s.param[by], np.arange(
                    s.count.shape[0]), side="right")
                lens = stop[key] - start[key]
                rows = np.repeat(row0 + idx, lens).astype(np.int64)
                pos = (np.repeat(start[key] - np.cumsum(lens) + lens, lens)
                       + np.arange(int(lens.sum())))
                sids = by[pos].astype(np.int64)
                got_sampled[c.name] = (
                    _sorted((rows << SID_BITS) | sids, dev),
                    _sorted(sids, dev), s.broker.copy())
        if keep:
            out_sampled[k] = got_sampled
        out_ticks.append(per)
    # the ring: slot r mod capacity holds the last row written there
    cap = cfg["engine"]["dataset_capacity"]
    rows_total = T.tick_rows(cfg, cell, n_ticks)
    ring_f = np.zeros((cap, T.NUM_FIELDS), np.int32)
    ring_l = np.zeros((cap, 2), np.float32)
    first = max(0, rows_total - cap)
    for i, chunk in T.preload_chunks(cfg):
        lo = i * chunk
        if lo + chunk <= first:
            continue
        f, loc = T.preload_batch(cfg, cell, seed, i, chunk)
        _place(ring_f, ring_l, lo, f, loc, first)
    for k in range(n_ticks):
        lo = T.tick_rows(cfg, cell, k)
        if lo + n <= first:
            continue
        f, loc = pool.get(k)
        _place(ring_f, ring_l, lo, f, loc, first)
    if narrow:
        ring_f = ring_f.astype(np.int16).astype(np.int32)
        ring_l = torch.as_tensor(ring_l).to(torch.bfloat16).float().numpy()
    return Expected(out_ticks, out_control, out_sampled, ring_f, ring_l,
                    rows_total)


def _place(ring_f, ring_l, lo: int, f, loc, first: int) -> None:
    cap = ring_f.shape[0]
    rows = np.arange(lo, lo + f.shape[0])
    keep = rows >= first
    slots = rows[keep] % cap
    ring_f[slots] = f[keep]
    ring_l[slots] = loc[keep]


def plain_scores(cfg: Dict, cell: Dict, seed: int, want: Expected,
                 dev) -> Dict[int, Dict[int, float]]:
    """Sampled tick -> record row -> the plain scorer's score of the
    record, for every row that gives a channel of the tick a pair. The
    prompt is the record's field vector, regenerated from the seed; the
    weights are the plain module's ``init`` of the seed on ``dev``."""
    block = cfg["enrichment"]
    mod = importlib.import_module(
        f"bad_bench.reference.scorers.{block['plain']}")
    model = {**block["model"], **block.get("overrides", {})}
    weights = mod.init(model, seed, dev)
    pool = T.Pool(cfg, cell, seed)
    out = {}
    for k in sorted(want.sampled):
        keys = [np.asarray(v[0]) >> SID_BITS for v in want.sampled[k].values()]
        rows = np.unique(np.concatenate(keys)) if keys else \
            np.zeros(0, np.int64)
        f, _ = pool.get(k)
        at = rows - T.tick_rows(cfg, cell, k)
        if len(at) and (at.min() < 0 or at.max() >= f.shape[0]):
            raise ValueError(f"tick {k}: a pair's row lies outside the "
                             f"tick's batch")
        got = mod.score(weights, torch.as_tensor(f[at], device=dev),
                        int(block["lanes"]))
        out[k] = dict(zip(rows.tolist(), got.cpu().tolist()))
    return out
