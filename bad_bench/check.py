"""The comparison that decides ``correct``: what a run recorded against
the reference's account of the same ticks. Every number is exact, so every
limit is 0; ``correct`` holds when no number passes its limit.

A scored deployment (an ``enrichment`` block in the configuration) adds
``SCORED_LIMITS``'s numbers, and only it. Its budget's pruned pairs and
their sIDs (``DeliveryStats.ranked_*``, inside ``dropped_*``) are the
budget's, not losses: ``dropped`` and ``undelivered`` leave them out. The
notified count, the result count and the broker bytes that a tick reports
are the whole join's, before the budget (the engine's reports take them
from the join's result, not the ranked one: ``_materialize_group``), so
``count_mismatch`` holds them to the reference's account before the
budget; the per-broker line count of ``line_broker_mismatch``, which the
broker bytes imply, is compared only where nothing was ranked. On the
sampled ticks the selection is judged exactly, by the program's own
scores, and the scores by the configuration's tolerance against the plain
scorer's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bad_bench.reference.reference import SID_BITS, Expected

LIMITS = {
    # (tick, channel) whose notified count, spatial result count, or
    # broker bytes disagree with the reference
    "count_mismatch": 0,
    # (tick, channel) whose delivery stats do not add up, per stage:
    # delivered + spilled + dropped == produced (fresh + retried)
    "conservation_break": 0,
    # pairs and sIDs dropped, in ticks, drains, the final drain and ring
    # flushes, a budget's ranked ones left out
    "dropped": 0,
    # produced sIDs and pairs of the run never delivered by its end, a
    # budget's ranked ones left out
    "undelivered": 0,
    # sampled ticks: delivered (row, sID) and sID multisets against the
    # reference's (size of the symmetric difference)
    "pair_mismatch": 0,
    "sid_mismatch": 0,
    # sampled ticks: wire lines whose members span brokers, plus the
    # per-broker line counts off the counts the broker bytes imply
    "line_broker_mismatch": 0,
    # 1 when the window held none of the sampled ticks
    "no_sample": 0,
    # ring slots whose record differs from the last one ingested there
    "ring_row_mismatch": 0,
    # control-plane calls whose return differs from the reference's
    "control_mismatch": 0,
    # ticks that raised
    "raised": 0,
}

SCORED_LIMITS = {
    # (tick, channel) whose ranked pairs differ from max(0, produced pairs -
    # budget): the engine keeps exactly min(budget, produced)
    "budget_mismatch": 0,
    # sampled ticks: slots holding a valid pair whose program score is
    # missing, not finite, or further than atol + rtol |plain| from the
    # plain scorer's
    "score_mismatch": 0,
    # sampled ticks, by the program's scores: slots with a kept pair that
    # score below a slot with a pruned pair, plus each channel with more
    # than one partly kept slot
    "rank_order_break": 0,
}


def multiset_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Size of the symmetric difference of two sorted multisets."""
    if a.shape == b.shape and np.array_equal(a, b):
        return 0
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    _, ia, ib = np.intersect1d(ua, ub, assume_unique=True,
                               return_indices=True)
    common = int(np.minimum(ca[ia], cb[ib]).sum())
    return len(a) + len(b) - 2 * common


def line_keys(lines: np.ndarray, dev):
    """(row << SID_BITS | sID) keys of delivered wire lines, sorted, and
    each line's member sIDs: (keys, members (L,), sids (L, W))."""
    t = torch.as_tensor(lines, device=dev)
    rows, members, sids = t[:, 0].long(), t[:, 2].long(), t[:, 4:].long()
    mask = (torch.arange(sids.shape[1], device=dev)[None, :]
            < members[:, None])
    keys = ((rows[:, None] << SID_BITS) | sids)[mask]
    return torch.sort(keys)[0].cpu().numpy(), mask, sids


def compare(run, want: Expected, cfg: Dict, dev,
            plain_scores: Dict = None) -> Dict[str, tuple]:
    """Each number compared, with its limit: {name: (value, limit)}.
    ``plain_scores`` (sampled tick -> record row -> the plain scorer's
    score) is the reference's for a scored deployment."""
    chans = {ch["name"]: ch for ch in cfg["channels"]}
    block = cfg.get("enrichment")
    limits = dict(LIMITS, **(SCORED_LIMITS if block else {}))
    got = dict.fromkeys(limits, 0)
    produced_s = delivered_s = produced_p = delivered_p = 0
    for k, tick in enumerate(run.ticks):
        if tick.error is not None:
            got["raised"] += 1
            continue
        ref = want.ticks[k]
        for name, (results, notified, bbytes, st) in tick.reports.items():
            ch = chans[name]
            matched, r_res, r_not, r_nb, r_rb = ref[name]
            bb = np.asarray(bbytes, np.int64)
            pay = ch["payload_bytes"]
            ok = notified == r_not
            if ch["join"] == "spatial":
                ok &= results == r_res and np.array_equal(
                    bb % 2 ** 32, (pay * r_rb) % 2 ** 32)
            elif ch["plan"]["aggregation"]:
                rest = bb - 4 * r_nb
                ok &= bool((rest >= 0).all() and (rest % pay == 0).all()
                           and (rest // pay).sum() == results)
            else:
                ok &= results == notified and np.array_equal(bb, pay * r_nb)
            got["count_mismatch"] += int(not ok)
            dp, sp, xp, ds, ss, xs, rp, rs, kp, ks = st
            got["conservation_break"] += int(
                dp + sp + xp != results + rp or ds + ss + xs != notified + rs)
            got["dropped"] += xp - kp + xs - ks
            if block:
                got["budget_mismatch"] += int(
                    kp != max(0, results - int(block["budget"])))
            produced_p += results - kp
            produced_s += r_not - ks
            delivered_p += dp
            delivered_s += ds
        for st in tick.drained.values():
            got["dropped"] += st[2] - st[8] + st[5] - st[9]
            delivered_p += st[0]
            delivered_s += st[3]
        for (op, ch_name, value), (_, _, ref_value) in zip(
                tick.control, want.control[k]):
            got["control_mismatch"] += int(value != ref_value)
        got["control_mismatch"] += abs(len(tick.control)
                                       - len(want.control[k]))
    for drains in run.final_drains:
        for st in drains.values():
            got["dropped"] += st[2] - st[8] + st[5] - st[9]
            delivered_p += st[0]
            delivered_s += st[3]
    got["dropped"] += run.flush_drops
    got["undelivered"] = (abs(produced_s - delivered_s)
                          + abs(produced_p - delivered_p) + run.pending_after)
    got["no_sample"] = int(not run.sampled)
    for k, per in run.sampled.items():
        tick = run.ticks[k]
        slots = _slots(run, k) if block else {}
        for name, (lines, sids) in per.items():
            r_keys, r_sids, brokers = want.sampled[k][name]
            keys, mask, members = line_keys(lines, dev)
            sids = np.sort(sids.astype(np.int64))
            ranked = tick.reports[name][3][8]
            if block:
                bad = scored(keys, sids, r_keys, r_sids, slots.get(name),
                             plain_scores.get(k, {}), block["tolerance"],
                             ranked)
                for key, v in bad.items():
                    got[key] += v
            else:
                got["pair_mismatch"] += multiset_diff(keys, r_keys)
                got["sid_mismatch"] += multiset_diff(sids, r_sids)
            table = torch.as_tensor(brokers, device=dev).long()
            safe = members.clamp(0, table.shape[0] - 1)
            b = table[safe]
            first = b[:, :1].expand_as(b)
            mixed = ((b != first) & mask).any(1)
            got["line_broker_mismatch"] += int(mixed.sum())
            nb = cfg["brokers"]
            per_broker = torch.bincount(b[:, 0], minlength=nb)[:nb]
            ch = chans[name]
            bb = np.asarray(tick.reports[name][2], np.int64)
            r_nb = want.ticks[k][name][3]
            if ch["join"] == "spatial":
                implied = (bb % 2 ** 32) // ch["payload_bytes"]
            elif ch["plan"]["aggregation"]:
                implied = (bb - 4 * r_nb) // ch["payload_bytes"]
            else:
                implied = bb // ch["payload_bytes"]
            retried = tick.reports[name][3][6]
            if retried == 0 and ranked == 0:
                got["line_broker_mismatch"] += int(np.abs(
                    per_broker.cpu().numpy() - implied).sum())
    ring_bad = ((run.ring_fields != want.ring_fields).any(1)
                | (run.ring_location.view(np.int32)
                   != want.ring_location.view(np.int32)).any(1))
    if run.size_rows != want.rows:
        ring_bad[:] = True
    got["ring_row_mismatch"] = int(ring_bad.sum())
    return {k: (v, limits[k]) for k, v in got.items()}


def _slots(run, k: int) -> Dict[str, tuple]:
    """The stage's calls of sampled tick ``k`` by channel: (slot index in
    the channel's candidates, record row, program score), the slots that
    hold a candidate (row >= 0) only."""
    out: Dict[str, tuple] = {}
    for ch_rows, rows, scores in run.scores.get(k, []):
        for c in np.unique(ch_rows):
            at = np.flatnonzero(ch_rows == c)
            slot = at - at[0]
            keep = rows[at] >= 0
            out[run.channel_rows[int(c)]] = (slot[keep], rows[at][keep],
                                             scores[at][keep])
    return out


def score_errors(run, plain_scores: Dict, tol: Dict) -> Dict[str, float]:
    """The sampled slots' program scores against the plain scorer's, for
    the log: the slots the stage scored a sampled tick, how many held a
    pair and were compared, the largest absolute error, and the largest
    share of its own tolerance (atol + rtol |plain|) an error took."""
    err, share, n = 0.0, 0.0, 0
    scored = sum(len(c[0]) for calls in run.scores.values() for c in calls)
    for k in run.scores:
        plain = plain_scores.get(k, {})
        for _, rows, scores in _slots(run, k).values():
            for r, v in zip(rows.tolist(), scores.tolist()):
                if r in plain:
                    e = abs(v - plain[r])
                    err = max(err, e)
                    share = max(share, e / (tol["atol"]
                                            + tol["rtol"] * abs(plain[r])))
                    n += 1
    return {"per_tick": scored / max(1, len(run.scores)), "slots": n,
            "largest_error": err, "largest_share": share}


def _common(a: np.ndarray, b: np.ndarray):
    """The multiset intersection of sorted ``a`` and ``b``: (values,
    counts)."""
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    v, ia, ib = np.intersect1d(ua, ub, assume_unique=True,
                               return_indices=True)
    return v, np.minimum(ca[ia], cb[ib])


def scored(keys, sids, r_keys, r_sids, slots, plain: Dict, tol: Dict,
           ranked: int) -> Dict[str, int]:
    """One scored channel of a sampled tick: delivered (row, sID) keys and
    sIDs, the reference's, the program's slots (slot, row, score) and the
    plain scorer's score by row. A slot is a record row with a pair in the
    reference. Unranked, delivery must equal the reference's. Ranked, by
    the program's own scores: every slot with a kept pair scores at least
    as high as every slot with a pruned one, at most one slot is partly
    kept, and it may only be the lowest-ranked kept slot (score, then the
    higher slot index), whose delivered pairs are a sub-multiset of its
    own; every other kept slot is delivered whole, and nothing is
    delivered that the reference does not produce."""
    out = dict.fromkeys(("score_mismatch", "rank_order_break",
                         "pair_mismatch", "sid_mismatch"), 0)
    rows, total = np.unique(r_keys >> SID_BITS, return_counts=True)
    prog = {}
    if slots is not None:
        for s, r, v in zip(*slots):
            prog.setdefault(int(r), (float(v), int(s)))
    for r in rows.tolist():
        want, have = plain.get(r), prog.get(r)
        if want is None or have is None or not np.isfinite(have[0]) or \
                abs(have[0] - want) > tol["atol"] + tol["rtol"] * abs(want):
            out["score_mismatch"] += 1
    if not ranked:
        out["pair_mismatch"] = multiset_diff(keys, r_keys)
        out["sid_mismatch"] = multiset_diff(sids, r_sids)
        return out
    v, c = _common(keys, r_keys)
    kept = np.zeros(len(rows), np.int64)
    np.add.at(kept, np.searchsorted(rows, v >> SID_BITS), c)
    extra = len(keys) - int(c.sum())
    score = np.array([prog.get(r, (-np.inf, 0))[0] for r in rows.tolist()])
    slot = np.array([prog.get(r, (0, 0))[1] for r in rows.tolist()])
    has = kept > 0
    cut = kept < total
    if cut.any():
        out["rank_order_break"] += int((has & (score < score[cut].max()))
                                       .sum())
    out["rank_order_break"] += int((has & cut).sum() > 1)
    full = has.copy()
    if has.any():
        at = np.flatnonzero(has)
        last = at[np.lexsort((-slot[at], score[at]))[0]]
        full[last] = False
        part = v[(v >> SID_BITS) == rows[last]]
        part = np.repeat(part, c[(v >> SID_BITS) == rows[last]])
    else:
        part = np.zeros(0, np.int64)
    out["pair_mismatch"] = extra + int((total - kept)[full].sum())
    # r_keys is sorted, so grouped by row in the order of ``rows``
    whole = np.repeat(full, total)
    expect = np.concatenate([r_keys[whole], part]) & ((1 << SID_BITS) - 1)
    out["sid_mismatch"] = multiset_diff(sids, np.sort(expect))
    return out


def correct(numbers: Dict[str, tuple]) -> bool:
    return all(v <= lim for v, lim in numbers.values())


def lines_for_stderr(numbers: Dict[str, tuple]) -> List[str]:
    return [f"check {k}: {v} (limit {lim})" for k, (v, lim) in
            numbers.items()]
