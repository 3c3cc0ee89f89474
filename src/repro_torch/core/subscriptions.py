"""Subscriptions + Algorithm 1 subscription aggregation (paper §4.1).

Control plane (this module) is host-side numpy — subscriptions arrive one at a
time between channel executions, exactly as in the paper ("all grouping is
completed before the execution of the next channel begins"). The data plane
consumes the dense, padded arrays produced here. The module is the
reference package's numpy control plane transliterated line for line, so
both packages group the same subscriptions into the same slots.

Frame-size rule: AsterixDB frames hold whole records, so the paper caps a
subscription-group record at the frame size ``f``. Here frames are tensor
rows; the analogous rule is a per-group sID capacity ``cap`` rounded down to
a multiple of 128 (``LANE``), the rounding the reference applies, so group
capacities — and with them every wire-buffer width — match it.
``cap_from_frame_bytes`` reproduces the paper's rule (group record size ~
frame size), ``lane_align`` applies the rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

SID_BYTES = 4          # sIDs are int32
LANE = 128             # group-capacity rounding unit (matches the reference)


def cap_from_frame_bytes(frame_bytes: int, align: bool = True) -> int:
    """Paper rule: optimal subgroup record size == frame size (Figs. 12-13)."""
    cap = max(1, frame_bytes // SID_BYTES)
    return lane_align(cap) if align else cap


def lane_align(cap: int) -> int:
    if cap <= LANE:
        return cap
    return (cap // LANE) * LANE


@dataclasses.dataclass
class SubscriptionTable:
    """Flat (un-aggregated) subscriptions — the *original* BAD layout."""

    sids: np.ndarray      # (S,) int32
    params: np.ndarray    # (S,) int32 -- encoded channel parameter
    brokers: np.ndarray   # (S,) int32 -- broker id

    @property
    def num_subscriptions(self) -> int:
        return int(self.sids.shape[0])

    @staticmethod
    def empty() -> "SubscriptionTable":
        z = np.zeros((0,), dtype=np.int32)
        return SubscriptionTable(z.copy(), z.copy(), z.copy())

    @staticmethod
    def build(params: np.ndarray, brokers: np.ndarray) -> "SubscriptionTable":
        params = np.asarray(params, dtype=np.int32)
        brokers = np.asarray(brokers, dtype=np.int32)
        sids = np.arange(params.shape[0], dtype=np.int32)
        return SubscriptionTable(sids, params, brokers)


@dataclasses.dataclass
class SubscriptionGroups:
    """Aggregated subscription-group records (paper Fig. 7b).

    group_params: (G,) int32     -- the shared parameter
    group_brokers: (G,) int32
    group_sids:   (G, cap) int32 -- member sIDs, padded with -1
    group_counts: (G,) int32
    """

    group_params: np.ndarray
    group_brokers: np.ndarray
    group_sids: np.ndarray
    group_counts: np.ndarray
    cap: int

    @property
    def num_groups(self) -> int:
        return int(self.group_params.shape[0])

    @property
    def num_subscriptions(self) -> int:
        return int(self.group_counts.sum())


@dataclasses.dataclass
class GroupDelta:
    """Control-plane churn since the last ``take_delta()``.

    ``slots`` are group SLOT indices (stable row ids in the aggregator's
    slot space) whose content changed — opened, mutated, or freed; ``params``
    are the parameter values whose live-slot membership changed. The FLAT
    layout has its own slot space (one stable row per subscription):
    ``flat_slots`` are its touched rows and ``flat_cells`` the touched
    (param, position) cells of its per-param join-map rows. Consumers
    re-read the aggregator's CURRENT content for every touched
    slot/param/cell, so consecutive deltas compose by set union
    (``merge``)."""

    slots: Set[int] = dataclasses.field(default_factory=set)
    params: Set[int] = dataclasses.field(default_factory=set)
    flat_slots: Set[int] = dataclasses.field(default_factory=set)
    flat_cells: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)
    # "everything moved" (a whole-table adopt): consumers must rebuild —
    # recorded as a flag instead of enumerating O(S) slots/cells
    full: bool = False

    def merge(self, other: "GroupDelta") -> None:
        self.slots |= other.slots
        self.params |= other.params
        self.flat_slots |= other.flat_slots
        self.flat_cells |= other.flat_cells
        self.full = self.full or other.full

    @property
    def empty(self) -> bool:
        return not (self.slots or self.params or self.flat_slots
                    or self.flat_cells or self.full)


class Aggregator:
    """Incremental Algorithm 1 over a STABLE-SLOT group table.

    Each group occupies a slot row of a dense (slots, cap) member matrix —
    the same layout the device caches hold — so batch mutations are
    vectorized numpy over the touched rows, never per-subscription Python.
    Freed slots (all members removed, or merged away by compaction) go on a
    free list and are reused by later opens, so long-lived churn never leaks
    slot rows into ``build()`` capacity. Every mutation is O(Δ·cap): O(1)
    sid->slot routing per sID, one row rewrite per touched group. Touched
    slots/params accumulate into a ``GroupDelta`` (consumed via
    ``take_delta``) so derived state — device group arrays, join maps — can
    be patched in place instead of rebuilt.

    ``compact_slack``: after removals, a key whose live groups exceed the
    minimal ``ceil(members / cap)`` by at least this many is re-chopped in
    slot order and the surplus slots freed (Algorithm-1 output is preserved
    up to group-boundary choices; the paper fixes group *capacity*, not
    boundary placement)."""

    def __init__(self, cap: int, compact_slack: int = 2):
        if cap < 1:
            raise ValueError("group capacity must be >= 1")
        self.cap = cap
        self.compact_slack = max(1, compact_slack)
        # (param, broker) -> list of LIVE slot indices (fill-scan order)
        self._by_key: Dict[Tuple[int, int], List[int]] = {}
        # (param, broker) -> live member count: O(1) compaction triggering
        self._key_subs: Dict[Tuple[int, int], int] = {}
        # param -> set of LIVE slot indices across brokers (join-map rows)
        self._by_param: Dict[int, Set[int]] = {}
        self._n = 0                       # slot table height (live + free)
        self._params = np.full((8,), -1, np.int32)     # per slot; -1 free
        self._brokers = np.full((8,), -1, np.int32)
        self._counts = np.zeros((8,), np.int32)
        self._msids = np.full((8, cap), -1, np.int32)  # -1-padded prefixes
        self._free: List[int] = []
        # live sID -> slot, as a dense -1-filled array (sIDs are small dense
        # ints): O(1) vectorized routing for whole batches. Grows with the
        # highest sID ever issued (4 bytes per sID) — the O(Δ) removal path
        # trades that bounded memory for zero per-sID Python
        self._sid_map = np.full((1024,), -1, np.int32)
        self._n_subs = 0
        self._next_sid = 0
        self._delta = GroupDelta()
        # FLAT layout: one stable slot per SUBSCRIPTION (the original
        # non-aggregated device rows), with its own free list, and per-param
        # positional join rows (stable (param, position) cells, -1 holes) so
        # flat device caches are patched cell-wise instead of rebuilt
        self._flat_params = np.zeros((8,), np.int32)
        self._flat_brokers = np.zeros((8,), np.int32)
        self._flat_sids = np.full((8,), -1, np.int32)   # -1 == free slot
        self._fpos = np.full((8,), -1, np.int32)        # slot -> row position
        self._flat_n = 0
        self._flat_free: List[int] = []
        self._sid_flat = np.full((1024,), -1, np.int32)  # sid -> flat slot
        self._frow: Dict[int, np.ndarray] = {}   # param -> flat slots, -1 holes
        self._frow_len: Dict[int, int] = {}      # param -> extent (high-water)
        self._frow_free: Dict[int, List[int]] = {}

    # -- slot bookkeeping ------------------------------------------------

    @property
    def num_slots(self) -> int:
        """Slot-table height (live + free) — the capacity derived arrays
        must be padded to."""
        return self._n

    @property
    def num_live_groups(self) -> int:
        return self._n - len(self._free)

    @property
    def num_subscriptions(self) -> int:
        return self._n_subs

    def slot_rows(self, slots) -> Tuple[np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]:
        """(params, brokers, counts, sids) rows for the given slots — one
        vectorized gather (free slots read zero-count, all -1 members);
        the delta-patch fill path."""
        sl = np.asarray(slots, dtype=np.int64)
        c = self._counts[sl]
        live = c > 0
        return (np.where(live, self._params[sl], 0).astype(np.int32),
                np.where(live, self._brokers[sl], 0).astype(np.int32),
                c.copy(), self._msids[sl].copy())

    def slot_row(self, gi: int) -> Tuple[int, int, int, np.ndarray]:
        """Current (param, broker, count, padded member sIDs) of one slot;
        free slots read as (0, 0, 0, all -1)."""
        p, b, c, s = self.slot_rows([gi])
        return int(p[0]), int(b[0]), int(c[0]), s[0]

    def slot_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """The whole slot table as dense arrays (params, brokers, counts,
        sids) — free slots zero-count. Row index == slot index, so deltas
        patch rows of exactly these arrays."""
        return self.slot_rows(np.arange(self._n, dtype=np.int64))

    def slot_members(self, gi: int) -> np.ndarray:
        return self._msids[gi, :self._counts[gi]].copy()

    def param_slots(self, param: int) -> np.ndarray:
        """Live slots holding groups for ``param`` (any broker), ascending —
        the delta-maintained equivalent of a ``param_to_targets`` row."""
        s = self._by_param.get(int(param), ())
        return np.sort(np.fromiter(s, np.int64, len(s)))

    def param_items(self):
        """(param, ascending live slots) for every param holding live
        groups — the public view of the per-param join-map rows."""
        for p in self._by_param:
            yield p, self.param_slots(p)

    def max_param_fanout(self) -> int:
        """Largest live-slot count any single param value maps to."""
        return max((len(s) for s in self._by_param.values()), default=1)

    def live_sids(self) -> np.ndarray:
        """Every live member sID (group-major order) — vectorized."""
        m = self._msids[:self._n]
        return m[m >= 0]

    def sid_slots(self, sids: np.ndarray) -> np.ndarray:
        """Slot of each sID (-1 for unknown/removed) — one gather."""
        sids = np.asarray(sids, dtype=np.int64).ravel()
        ok = (sids >= 0) & (sids < self._sid_map.shape[0])
        return np.where(ok, self._sid_map[np.where(ok, sids, 0)], -1)

    def _ensure_sid_map(self, max_sid: int) -> None:
        # _grow_to doubles (at least) and no-ops when already large enough
        self._sid_map = self._grow_to(self._sid_map, max_sid + 1, -1)
        self._sid_flat = self._grow_to(self._sid_flat, max_sid + 1, -1)

    # -- flat stable slots ------------------------------------------------

    @property
    def num_flat_slots(self) -> int:
        """Flat slot-table height (live + free) — the capacity flat device
        caches must be padded to."""
        return self._flat_n

    def flat_slot_rows(self, slots) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
        """(params, brokers, live-counts, sids) rows for the given FLAT
        slots — free slots read zero-count / -1 sid; the flat delta-patch
        fill path."""
        sl = np.asarray(slots, dtype=np.int64)
        sids = self._flat_sids[sl]
        live = sids >= 0
        return (np.where(live, self._flat_params[sl], 0).astype(np.int32),
                np.where(live, self._flat_brokers[sl], 0).astype(np.int32),
                live.astype(np.int32), sids.copy())

    def flat_slot_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
        """The whole flat slot table as dense arrays — row index == flat
        slot, free slots zero-count. The flat analogue of
        ``slot_arrays``."""
        return self.flat_slot_rows(np.arange(self._flat_n, dtype=np.int64))

    def flat_param_rows(self):
        """(param, positional row of flat slots up to its extent) for every
        param that ever held flat positions — -1 holes stay in place so
        (param, position) cells are stable under churn."""
        for p, row in self._frow.items():
            yield p, row[:self._frow_len[p]]

    def flat_row_extent(self, param: int) -> int:
        return self._frow_len.get(int(param), 0)

    def max_flat_extent(self) -> int:
        """Largest positional-row extent any param ever reached."""
        return max(self._frow_len.values(), default=1)

    def flat_cell_rows(self, cells) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        """(params, positions, current flat-slot values) for the given
        (param, position) cells — the cell-wise flat join-map patch read
        (-1 where the cell is a hole)."""
        n = len(cells)
        ps = np.empty((n,), np.int32)
        pos = np.empty((n,), np.int32)
        vals = np.full((n,), -1, np.int32)
        for i, (p, j) in enumerate(cells):
            ps[i], pos[i] = p, j
            row = self._frow.get(p)
            if row is not None and j < self._frow_len.get(p, 0):
                vals[i] = row[j]
        return ps, pos, vals

    @staticmethod
    def _grow_to(arr: np.ndarray, need: int, fill) -> np.ndarray:
        if need <= arr.shape[0]:
            return arr
        new = np.full((max(need, 2 * arr.shape[0]),) + arr.shape[1:], fill,
                      arr.dtype)
        new[:arr.shape[0]] = arr
        return new

    def _flat_add_key(self, param: int, broker: int,
                      sids: np.ndarray) -> None:
        """Assign stable flat slots + positional cells to one key's new
        members — free-list reuse first, then append; O(Δ) numpy."""
        k = len(sids)
        free = self._flat_free
        r = min(k, len(free))
        slots = np.empty((k,), np.int64)
        if r:
            slots[:r] = free[len(free) - r:]
            del free[len(free) - r:]
        if k > r:
            slots[r:] = np.arange(self._flat_n, self._flat_n + k - r)
            self._flat_n += k - r
            self._flat_params = self._grow_to(self._flat_params,
                                              self._flat_n, 0)
            self._flat_brokers = self._grow_to(self._flat_brokers,
                                               self._flat_n, 0)
            self._flat_sids = self._grow_to(self._flat_sids, self._flat_n, -1)
            self._fpos = self._grow_to(self._fpos, self._flat_n, -1)
        self._flat_params[slots] = param
        self._flat_brokers[slots] = broker
        self._flat_sids[slots] = sids
        self._sid_flat[sids] = slots
        row = self._frow.get(param)
        if row is None:
            row = np.full((8,), -1, np.int32)
            self._frow[param] = row
            self._frow_len[param] = 0
            self._frow_free[param] = []
        pf = self._frow_free[param]
        r2 = min(k, len(pf))
        pos = np.empty((k,), np.int64)
        if r2:
            pos[:r2] = pf[len(pf) - r2:]
            del pf[len(pf) - r2:]
        if k > r2:
            ln = self._frow_len[param]
            pos[r2:] = np.arange(ln, ln + k - r2)
            self._frow_len[param] = ln + k - r2
            if self._frow_len[param] > row.shape[0]:
                self._frow[param] = row = self._grow_to(
                    row, self._frow_len[param], -1)
        row[pos] = slots
        self._fpos[slots] = pos
        self._delta.flat_slots.update(slots.tolist())
        self._delta.flat_cells.update(
            (param, int(j)) for j in pos.tolist())

    def _flat_remove_sids(self, sids: np.ndarray) -> None:
        """Free the flat slots + positional cells of removed sIDs (callers
        pass unique, known-live sIDs)."""
        slots = self._sid_flat[np.asarray(sids, np.int64)].astype(np.int64)
        params = self._flat_params[slots]
        pos = self._fpos[slots]
        self._sid_flat[sids] = -1
        self._flat_sids[slots] = -1
        self._fpos[slots] = -1
        self._flat_free.extend(slots.tolist())
        self._delta.flat_slots.update(slots.tolist())
        order = np.argsort(params, kind="stable")
        ps, po = params[order], pos[order]
        starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
        for s, e in zip(starts.tolist(),
                        np.append(starts[1:], len(ps)).tolist()):
            p = int(ps[s])
            prun = po[s:e]
            self._frow[p][prun] = -1
            self._frow_free[p].extend(prun.tolist())
            self._delta.flat_cells.update(
                (p, int(j)) for j in prun.tolist())

    def take_delta(self) -> GroupDelta:
        """Pop the accumulated churn record (and reset it)."""
        d = self._delta
        self._delta = GroupDelta()
        return d

    def _touch(self, gi: int, param: int) -> None:
        self._delta.slots.add(gi)
        self._delta.params.add(int(param))

    def _new_slot(self) -> int:
        if self._free:
            return self._free.pop()
        if self._n == self._params.shape[0]:
            grow = max(8, self._params.shape[0])
            self._params = np.concatenate(
                [self._params, np.full((grow,), -1, np.int32)])
            self._brokers = np.concatenate(
                [self._brokers, np.full((grow,), -1, np.int32)])
            self._counts = np.concatenate(
                [self._counts, np.zeros((grow,), np.int32)])
            self._msids = np.concatenate(
                [self._msids, np.full((grow, self.cap), -1, np.int32)])
        gi = self._n
        self._n += 1
        return gi

    def _alloc_slot(self, param: int, broker: int,
                    members: np.ndarray) -> int:
        gi = self._new_slot()
        self._params[gi] = param
        self._brokers[gi] = broker
        self._msids[gi] = -1
        self._msids[gi, :len(members)] = members
        self._counts[gi] = len(members)
        self._by_key.setdefault((param, broker), []).append(gi)
        self._by_param.setdefault(param, set()).add(gi)
        self._touch(gi, param)
        return gi

    def _release_slot(self, gi: int, unregister_key: bool = True) -> None:
        param, broker = int(self._params[gi]), int(self._brokers[gi])
        if unregister_key:
            lst = self._by_key.get((param, broker))
            if lst is not None:
                lst.remove(gi)
                if not lst:
                    del self._by_key[(param, broker)]
        ps = self._by_param.get(param)
        if ps is not None:
            ps.discard(gi)
            if not ps:
                del self._by_param[param]
        self._params[gi] = -1
        self._brokers[gi] = -1
        self._counts[gi] = 0
        self._msids[gi] = -1
        self._free.append(gi)
        self._touch(gi, param)

    # -- mutations -------------------------------------------------------

    def add_subscription(self, param: int, broker: int,
                         sid: Optional[int] = None) -> int:
        """Paper Algorithm 1. Returns the sID assigned."""
        if sid is None:
            sid = self._next_sid
        self._next_sid = max(self._next_sid, sid + 1)
        param, broker = int(param), int(broker)
        key = (param, broker)
        self._ensure_sid_map(sid)
        self._key_subs[key] = self._key_subs.get(key, 0) + 1
        for gi in self._by_key.get(key, ()):           # AddToExistingGroup
            c = int(self._counts[gi])
            if c < self.cap:
                self._msids[gi, c] = sid
                self._counts[gi] = c + 1
                self._sid_map[sid] = gi
                self._n_subs += 1
                self._touch(gi, param)
                self._flat_add_key(param, broker, np.asarray([sid], np.int32))
                return sid
        gi = self._alloc_slot(param, broker,            # open a new group
                              np.asarray([sid], np.int32))
        self._sid_map[sid] = gi
        self._n_subs += 1
        self._flat_add_key(param, broker, np.asarray([sid], np.int32))
        return sid

    def _place_key(self, param: int, broker: int, sids: np.ndarray) -> None:
        """Place one key's new members: top up the key's non-full groups in
        fill order, then chop the remainder into fresh cap-sized groups —
        Algorithm-1 semantics, numpy work per touched GROUP only."""
        pos, n = 0, len(sids)
        self._n_subs += n
        key = (param, broker)
        self._key_subs[key] = self._key_subs.get(key, 0) + n
        self._flat_add_key(param, broker, sids)
        lst = self._by_key.get(key)
        if lst:
            # ONE vectorized fill across every open group of the key:
            # scattered removals leave scattered slack, and walking those
            # groups one by one in Python was the bulk-add hot spot
            arr = np.asarray(lst, dtype=np.int64)
            open_slots = arr[self._counts[arr] < self.cap]
            if open_slots.size:
                cnts = self._counts[open_slots].astype(np.int64)
                rooms = self.cap - cnts
                cum = np.cumsum(rooms)
                take = int(min(n, cum[-1]))
                if take:
                    j = np.arange(take, dtype=np.int64)
                    g = np.searchsorted(cum, j, side="right")
                    col = cnts[g] + j - (cum[g] - rooms[g])
                    rows = open_slots[g]
                    self._msids[rows, col] = sids[:take]
                    filled = np.bincount(g, minlength=open_slots.size)
                    touched = open_slots[filled > 0]
                    self._counts[touched] += filled[filled > 0].astype(
                        np.int32)
                    self._sid_map[sids[:take]] = rows.astype(np.int32)
                    self._delta.slots.update(touched.tolist())
                    self._delta.params.add(int(param))
                    pos = take
        while pos < n:
            chunk = sids[pos:pos + self.cap]
            gi = self._alloc_slot(param, broker, chunk)
            self._sid_map[chunk] = gi
            pos += len(chunk)

    def add_bulk(self, params: np.ndarray, brokers: np.ndarray,
                 sids: Optional[np.ndarray] = None) -> np.ndarray:
        """Incremental bulk load: O(Δ log Δ) sort of the batch, then per
        TOUCHED (param, broker) key only — existing untouched groups are
        never revisited (the pre-churn-engine path re-aggregated old + new
        members from scratch, O(S) per batch). Per-key output is Algorithm-1
        equivalent: non-full groups top up first, the remainder chops into
        minimal cap-sized groups. Returns the sIDs assigned to the batch."""
        params = np.asarray(params, dtype=np.int32).ravel()
        brokers = np.asarray(brokers, dtype=np.int32).ravel()
        if params.shape != brokers.shape:
            raise ValueError("params and brokers must have the same length")
        n = params.shape[0]
        if sids is None:
            sids = self._next_sid + np.arange(n, dtype=np.int32)
        else:
            sids = np.asarray(sids, dtype=np.int32).ravel()
            if sids.shape[0] != n:   # before _next_sid moves: fail unmutated
                raise ValueError("sids must have the same length as params")
        if n == 0:
            return sids
        self._next_sid = max(self._next_sid, int(sids.max()) + 1)
        self._ensure_sid_map(int(sids.max()))
        if self._n == 0:
            # from-empty fast path: the pure vectorized sort+chop (initial
            # bulk loads are the control plane's cold-start hot path and
            # produce the identical partition)
            self._adopt(aggregate(SubscriptionTable(sids, params, brokers),
                                  self.cap))
            return sids
        key = _sort_key(params, brokers)
        order = np.argsort(key, kind="stable")
        k = key[order]
        new_run = np.empty(n, dtype=bool)
        new_run[0] = True
        new_run[1:] = k[1:] != k[:-1]
        starts = np.flatnonzero(new_run)
        ends = np.append(starts[1:], n)
        for s, e in zip(starts.tolist(), ends.tolist()):
            run = order[s:e]
            self._place_key(int(params[run[0]]), int(brokers[run[0]]),
                            sids[run])
        return sids

    def _adopt(self, g: SubscriptionGroups) -> None:
        """Replace the whole slot table with freshly aggregated groups
        (vectorized registration of every index); delta-touches every slot."""
        self._n = g.num_groups
        self._params = g.group_params.copy()
        self._brokers = g.group_brokers.copy()
        self._counts = g.group_counts.copy()
        self._msids = g.group_sids.copy()
        self._free = []
        self._by_key = {}
        self._by_param = {}
        self._key_subs = {}
        for gi, (key, c) in enumerate(zip(zip(self._params.tolist(),
                                              self._brokers.tolist()),
                                          self._counts.tolist())):
            self._by_key.setdefault(key, []).append(gi)
            self._by_param.setdefault(key[0], set()).add(gi)
            self._key_subs[key] = self._key_subs.get(key, 0) + int(c)
        members = self._msids[self._msids >= 0]
        self._ensure_sid_map(int(members.max()) if members.size else 0)
        self._sid_map[members] = np.repeat(
            np.arange(self._n, dtype=np.int32), self._counts)
        self._n_subs = int(self._counts.sum())
        # flat slot table: slot i == i-th member in group-major order;
        # positional rows assigned per param in slot order — all vectorized
        n = self._n_subs
        self._flat_n = n
        size = max(8, n)
        self._flat_params = np.zeros((size,), np.int32)
        self._flat_brokers = np.zeros((size,), np.int32)
        self._flat_sids = np.full((size,), -1, np.int32)
        self._fpos = np.full((size,), -1, np.int32)
        self._flat_free = []
        self._sid_flat.fill(-1)
        self._frow, self._frow_len, self._frow_free = {}, {}, {}
        if n:
            self._flat_params[:n] = np.repeat(g.group_params, g.group_counts)
            self._flat_brokers[:n] = np.repeat(g.group_brokers,
                                               g.group_counts)
            self._flat_sids[:n] = members
            self._sid_flat[members] = np.arange(n, dtype=np.int32)
            order = np.argsort(self._flat_params[:n],
                               kind="stable").astype(np.int64)
            sp = self._flat_params[order]
            starts = np.flatnonzero(np.r_[True, sp[1:] != sp[:-1]])
            ends = np.append(starts[1:], n)
            run_id = np.cumsum(np.r_[True, sp[1:] != sp[:-1]]) - 1
            self._fpos[order] = (np.arange(n, dtype=np.int64)
                                 - starts[run_id]).astype(np.int32)
            for s, e in zip(starts.tolist(), ends.tolist()):
                p = int(sp[s])
                self._frow[p] = order[s:e].astype(np.int32)
                self._frow_len[p] = e - s
                self._frow_free[p] = []
        # everything moved: record a FULL delta instead of enumerating O(S)
        # touched slots/cells — consumers rebuild
        self._delta = GroupDelta(full=True)

    def remove_subscription(self, param: int, broker: int, sid: int) -> bool:
        gi = int(self.sid_slots([sid])[0])
        if gi < 0 or self._params[gi] != int(param) \
                or self._brokers[gi] != int(broker):
            return False
        self._flat_remove_sids(np.asarray([sid], np.int64))
        self._sid_map[sid] = -1
        self._n_subs -= 1
        key = (int(param), int(broker))
        self._key_subs[key] -= 1
        c = int(self._counts[gi])
        row = self._msids[gi]
        pos = int(np.flatnonzero(row[:c] == sid)[0])
        row[pos:c - 1] = row[pos + 1:c]       # keep the -1-padded prefix
        row[c - 1] = -1
        self._counts[gi] = c - 1
        if c == 1:
            self._release_slot(gi)
        else:
            self._touch(gi, int(param))
        self._maybe_compact((int(param), int(broker)))
        return True

    def remove_bulk(self, sids: np.ndarray) -> np.ndarray:
        """Remove a batch of subscriptions by sID — O(Δ·cap) total: O(1)
        sid->slot routing per sID, then ONE vectorized rewrite of the
        touched slot rows. Unknown/already-removed sIDs are ignored.
        Returns the param value of every subscription actually removed (for
        refcount upkeep); freed groups release their slots and fragmented
        keys compact past ``compact_slack``."""
        sids_arr = np.asarray(sids, dtype=np.int32).ravel()
        if sids_arr.size == 0:
            return np.zeros((0,), np.int32)
        slots = self.sid_slots(sids_arr)
        found = slots >= 0
        if not found.any():
            return np.zeros((0,), np.int32)
        rm_sids = sids_arr[found]
        self._flat_remove_sids(np.unique(rm_sids))
        self._sid_map[rm_sids] = -1          # idempotent for batch dupes
        uniq = np.unique(slots[found])
        # one batched row rewrite: mark removed members, stable-compact the
        # survivors to the row front (prefix-sum destinations, no per-row
        # sort), re-pad the tail with -1
        sub = self._msids[uniq]                         # (k, cap)
        hit = np.isin(sub, rm_sids)                     # sids are unique
        keep = ~hit & (sub >= 0)
        dest = np.cumsum(keep, axis=1, dtype=np.int64) - 1
        out = np.full_like(sub, -1)
        rows = np.broadcast_to(
            np.arange(uniq.size, dtype=np.int64)[:, None], sub.shape)
        out[rows[keep], dest[keep]] = sub[keep]
        n_rm = hit.sum(axis=1).astype(np.int32)
        new_c = self._counts[uniq] - n_rm
        self._msids[uniq] = out
        self._counts[uniq] = new_c
        u_params = self._params[uniq]
        u_brokers = self._brokers[uniq]
        removed = np.repeat(u_params, n_rm).astype(np.int32)
        self._n_subs -= int(n_rm.sum())
        self._delta.slots.update(uniq.tolist())
        self._delta.params.update(u_params.tolist())
        # per-key removal totals, vectorized to the ~#keys scale
        kk = (u_params.astype(np.int64) << 32) | (
            u_brokers.astype(np.int64) & 0xFFFFFFFF)
        uk, inv = np.unique(kk, return_inverse=True)
        per_key = np.bincount(inv, weights=n_rm).astype(np.int64)
        touched_keys = []
        for key_pk, k in zip(uk.tolist(), per_key.tolist()):
            b = key_pk & 0xFFFFFFFF
            key = (key_pk >> 32, b - (1 << 32) if b >= 1 << 31 else b)
            touched_keys.append(key)
            self._key_subs[key] -= int(k)
        for gi in uniq[new_c == 0].tolist():
            self._release_slot(gi)
        for key in touched_keys:
            self._maybe_compact(key)
        return removed

    def _maybe_compact(self, key: Tuple[int, int]) -> None:
        """Re-chop one fragmented key in slot order: keep the first
        ``ceil(members / cap)`` slots, free the rest. Triggered only when the
        key carries >= ``compact_slack`` surplus groups, so steady churn is
        not forever re-shuffling group boundaries."""
        slots = self._by_key.get(key)
        if not slots or len(slots) <= 1:
            return
        total = self._key_subs.get(key, 0)
        minimal = -(-total // self.cap)
        if len(slots) - minimal < self.compact_slack:
            return               # O(1) in the common no-compaction case
        param = key[0]
        sl = np.asarray(sorted(slots), dtype=np.int64)
        rows = self._msids[sl]
        members = rows[rows >= 0]            # slot order, then member order
        keep, drop = sl[:minimal], sl[minimal:]
        mat = np.full((minimal, self.cap), -1, np.int32)
        idx = np.arange(total, dtype=np.int64)
        mat[idx // self.cap, idx % self.cap] = members
        self._msids[keep] = mat
        counts = np.diff(np.append(np.arange(0, total, self.cap), total))
        self._counts[keep] = counts.astype(np.int32)
        self._by_key[key] = keep.tolist()
        self._sid_map[members] = np.repeat(keep, counts).astype(np.int32)
        self._delta.slots.update(keep.tolist())
        self._delta.params.add(int(param))
        for gi in drop.tolist():
            self._release_slot(gi, unregister_key=False)

    def rebuild_bulk(self, params: np.ndarray, brokers: np.ndarray,
                     sids: Optional[np.ndarray] = None) -> np.ndarray:
        """The PRE-churn-engine bulk load, kept as the rebuild baseline the
        churn suite measures against: old + new members re-aggregated from
        scratch through ``aggregate`` — O(S) per batch, group identity not
        preserved. Leaves no usable delta (callers must treat every derived
        cache as invalid)."""
        params = np.asarray(params, dtype=np.int32).ravel()
        brokers = np.asarray(brokers, dtype=np.int32).ravel()
        if params.shape != brokers.shape:
            raise ValueError("params and brokers must have the same length")
        n = params.shape[0]
        if sids is None:
            sids = self._next_sid + np.arange(n, dtype=np.int32)
        else:
            sids = np.asarray(sids, dtype=np.int32).ravel()
            if sids.shape[0] != n:   # before _next_sid moves: fail unmutated
                raise ValueError("sids must have the same length as params")
        if n == 0:
            return sids
        self._next_sid = max(self._next_sid, int(sids.max()) + 1)
        old = flatten_groups(self.build())
        table = SubscriptionTable(
            np.concatenate([old.sids, sids]),
            np.concatenate([old.params, params]),
            np.concatenate([old.brokers, brokers]))
        self._adopt(aggregate(table, self.cap))
        self._delta = GroupDelta()   # unusable: everything moved
        return sids

    # -- export ----------------------------------------------------------

    def build(self) -> SubscriptionGroups:
        """Dense live-group arrays, compacted in slot order (free slots are
        skipped, so the k-th built row is the k-th live slot)."""
        live = np.flatnonzero(self._counts[:self._n] > 0)
        return SubscriptionGroups(
            self._params[live].astype(np.int32),
            self._brokers[live].astype(np.int32),
            self._msids[live].copy(),
            self._counts[live].copy(), self.cap)


def _sort_key(params: np.ndarray, brokers: np.ndarray) -> np.ndarray:
    """Fused (param, broker) sort key in the narrowest dtype that holds it —
    numpy's stable sort is radix for narrow integers, comparison otherwise."""
    if params.size and (int(params.min()) < 0 or int(brokers.min()) < 0):
        return (params.astype(np.int64) << 32) | (
            brokers.astype(np.int64) & 0xFFFFFFFF)
    span = int(brokers.max()) + 1 if brokers.size else 1
    key_range = (int(params.max()) + 1) * span if params.size else 1
    if key_range <= (1 << 15):
        return (params * span + brokers).astype(np.int16)
    if key_range <= (1 << 31):
        return (params.astype(np.int64) * span + brokers).astype(np.int32)
    return (params.astype(np.int64) << 32) | brokers.astype(np.int64)


def aggregate(table: SubscriptionTable, cap: int) -> SubscriptionGroups:
    """Bulk aggregation (vectorized equivalent of replaying Algorithm 1).

    Sort by (param, broker) — one stable argsort of a fused 64-bit key — then
    chop each run into cap-sized subgroups. Per-key group counts equal the
    incremental replay's ``ceil(n_key / cap)``; no per-subscription Python.
    """
    n = table.num_subscriptions
    if n == 0:
        return SubscriptionGroups(*(np.zeros((0,), np.int32),) * 2,
                                  np.zeros((0, cap), np.int32),
                                  np.zeros((0,), np.int32), cap)
    key = _sort_key(table.params, table.brokers)
    order = np.argsort(key, kind="stable")   # radix for narrow integer keys
    k = key[order]
    s = table.sids[order]
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = k[1:] != k[:-1]
    run_starts = np.flatnonzero(new_run)
    run_id = np.cumsum(new_run, dtype=np.int32) - 1
    pos_in_run = np.arange(n, dtype=np.int64) - run_starts[run_id]
    sub_id = pos_in_run // cap
    # a group starts at every run start and every cap boundary within a run
    new_group = new_run.copy()
    new_group[1:] |= sub_id[1:] != sub_id[:-1]
    group_starts = np.flatnonzero(new_group)
    g = group_starts.shape[0]
    gid = np.cumsum(new_group, dtype=np.int32) - 1
    group_sids = np.full((g, cap), -1, dtype=np.int32)
    group_sids[gid, pos_in_run % cap] = s
    group_counts = np.diff(np.append(group_starts, n)).astype(np.int32)
    return SubscriptionGroups(table.params[order[group_starts]],
                              table.brokers[order[group_starts]],
                              group_sids, group_counts, cap)


def flatten_groups(groups: SubscriptionGroups) -> SubscriptionTable:
    """Vectorized inverse of ``aggregate``: groups -> flat member table.

    Rows come out group-by-group in member order — the same order the old
    per-group Python loop produced — with no per-subscription work.
    """
    counts = groups.group_counts.astype(np.int64)
    member_mask = np.arange(groups.cap)[None, :] < counts[:, None]
    return SubscriptionTable(
        groups.group_sids[member_mask].astype(np.int32),
        np.repeat(groups.group_params, counts).astype(np.int32),
        np.repeat(groups.group_brokers, counts).astype(np.int32))


def param_to_targets(params: np.ndarray, domain: int,
                     pad: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Dense join map: param value -> row indices of targets holding it.

    Returns (map (domain, maxd) int32 padded, counts (domain,) int32). This is
    the dense realization of the index nested-loop join in the augmented plan —
    the join against a small categorical domain becomes a gather. Pure numpy:
    a stable argsort ranks each target within its param run, so the scatter
    preserves the ascending-row order the incremental fill produced.
    """
    params = np.asarray(params, dtype=np.int32)
    counts = np.bincount(params, minlength=domain).astype(np.int32)
    maxd = max(1, int(counts.max()) if counts.size else 1)
    out = np.full((domain, maxd), pad, dtype=np.int32)
    if params.size:
        order = np.argsort(params, kind="stable")
        sorted_p = params[order]
        run_start = np.cumsum(counts) - counts          # (domain,)
        pos = np.arange(params.size, dtype=np.int64) - run_start[sorted_p]
        out[sorted_p, pos] = order.astype(np.int32)
    return out, counts
