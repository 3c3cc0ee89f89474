"""The comparison that decides ``correct``: what a run recorded against
the reference's account of the same ticks. Every number is exact, so every
limit is 0; ``correct`` holds when no number passes its limit.
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
    # flushes
    "dropped": 0,
    # produced sIDs and pairs of the run never delivered by its end
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


def compare(run, want: Expected, cfg: Dict, dev) -> Dict[str, tuple]:
    """Each number compared, with its limit: {name: (value, limit)}."""
    chans = {ch["name"]: ch for ch in cfg["channels"]}
    got = dict.fromkeys(LIMITS, 0)
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
            dp, sp, xp, ds, ss, xs, rp, rs = st
            got["conservation_break"] += int(
                dp + sp + xp != results + rp or ds + ss + xs != notified + rs)
            got["dropped"] += xp + xs
            produced_p += results
            produced_s += r_not
            delivered_p += dp
            delivered_s += ds
        for st in tick.drained.values():
            got["dropped"] += st[2] + st[5]
            delivered_p += st[0]
            delivered_s += st[3]
        for (op, ch_name, value), (_, _, ref_value) in zip(
                tick.control, want.control[k]):
            got["control_mismatch"] += int(value != ref_value)
        got["control_mismatch"] += abs(len(tick.control)
                                       - len(want.control[k]))
    for drains in run.final_drains:
        for st in drains.values():
            got["dropped"] += st[2] + st[5]
            delivered_p += st[0]
            delivered_s += st[3]
    got["dropped"] += run.flush_drops
    got["undelivered"] = (abs(produced_s - delivered_s)
                          + abs(produced_p - delivered_p) + run.pending_after)
    got["no_sample"] = int(not run.sampled)
    for k, per in run.sampled.items():
        tick = run.ticks[k]
        for name, (lines, sids) in per.items():
            r_keys, r_sids, brokers = want.sampled[k][name]
            keys, mask, members = line_keys(lines, dev)
            got["pair_mismatch"] += multiset_diff(keys, r_keys)
            got["sid_mismatch"] += multiset_diff(np.sort(sids.astype(
                np.int64)), r_sids)
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
            if retried == 0:
                got["line_broker_mismatch"] += int(np.abs(
                    per_broker.cpu().numpy() - implied).sum())
    ring_bad = ((run.ring_fields != want.ring_fields).any(1)
                | (run.ring_location.view(np.int32)
                   != want.ring_location.view(np.int32)).any(1))
    if run.size_rows != want.rows:
        ring_bad[:] = True
    got["ring_row_mismatch"] = int(ring_bad.sum())
    return {k: (v, LIMITS[k]) for k, v in got.items()}


def correct(numbers: Dict[str, tuple]) -> bool:
    return all(v <= lim for v, lim in numbers.values())


def lines_for_stderr(numbers: Dict[str, tuple]) -> List[str]:
    return [f"check {k}: {v} (limit {lim})" for k, (v, lim) in
            numbers.items()]
