"""Sequence-parallel decode rules and the BAD engine's entity partitioning.

``Rules`` holds the model axis as a list of ``torch.device``s: the sequence
shards of the KV cache, slice ``j`` on ``model_devices[j]`` (a device may
repeat, so one card holds several slices). ``use_rules`` makes a rule set
active for the model code (``models/attention.attn_decode`` reads it through
``active_rules``); without one the decode runs on one device.

Subscriptions and spatial cohort users are assigned to shards by a STABLE
hash of their global id: the owner of an entity is a pure function of
(id, num_shards), never of load order or of what else is live, so churn
deltas route without a directory lookup, and re-partitioning after a
channel drop or a reshard recomputes the same assignment for every
surviving id. Knuth's multiplicative hash decorrelates the assignment from
the sequential id allocation (consecutive sIDs spread across shards instead
of landing in contiguous runs); users get a different odd multiplier so a
uid and an equal-valued sID do not co-locate. Host code (numpy), bit for
bit the reference's ``repro/distributed/partition.py``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

_STATE = threading.local()


class Rules:
    """The model axis of a decode: ``model_devices`` are the KV cache's
    sequence shards (None or empty: no model axis). ``batch_axes`` stays
    None: the port shards no batch dimension."""

    def __init__(self, model_devices: Optional[Sequence] = None):
        self.model_devices: List[torch.device] = [
            torch.device(d) for d in (model_devices or ())]
        self.model_axis = "model" if self.model_devices else None
        self.batch_axes = None

    @property
    def model_size(self) -> int:
        return len(self.model_devices)


def active_rules() -> Optional[Rules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


_SID_MULT = np.uint64(2654435761)    # Knuth 2^32 / phi
_UID_MULT = np.uint64(2246822519)    # xxhash PRIME32_2


def _multiplicative_shard(ids: np.ndarray, num_shards: int,
                          mult: np.uint64) -> np.ndarray:
    ids = np.asarray(ids)
    if ids.size and int(ids.min()) < 0:
        raise ValueError("entity ids must be non-negative")
    if num_shards <= 1:
        return np.zeros(ids.shape, np.int32)
    h = (ids.astype(np.uint64) * mult) & np.uint64(0xFFFFFFFF)
    return (h % np.uint64(num_shards)).astype(np.int32)


def shard_for_sids(sids: np.ndarray, num_shards: int) -> np.ndarray:
    """Owning shard for each subscription id (vectorized, stable)."""
    return _multiplicative_shard(sids, num_shards, _SID_MULT)


def shard_for_users(uids: np.ndarray, num_shards: int) -> np.ndarray:
    """Owning shard for each spatial-cohort user id."""
    return _multiplicative_shard(uids, num_shards, _UID_MULT)


def broker_owner(broker_ids: np.ndarray, num_shards: int) -> np.ndarray:
    """The shard hosting each broker endpoint. Brokers are few and
    enumerated densely, so round-robin placement is balanced by
    construction; notifications whose subscription lives elsewhere are
    routed here by ``collectives.shuffle_notify``."""
    if num_shards <= 1:
        return np.zeros(np.asarray(broker_ids).shape, np.int32)
    return (np.asarray(broker_ids).astype(np.int64)
            % num_shards).astype(np.int32)
