"""Logical-axis sharding rules, partition specs, placement on a mesh, and
the BAD engine's entity partitioning.

A partition spec (``PartitionSpec``, alias ``P``) is a tuple with one entry
a tensor dimension: an axis name, ``None`` or a tuple of names, as the
reference's ``jax.sharding.PartitionSpec``. ``_specs`` maps the model
code's logical names to specs for a rule set (Megatron-style TP over
``model`` and (pod, data) DP):

  batch   -> ("pod", "data")        activations, inputs
  heads   -> "model"                attention q heads / ffn hidden / experts
  vocab   -> "model"                embedding + lm head vocab dim
  kv_seq  -> "model"                KV cache sequence dim (flash-decode SP)

``sanitize_spec`` drops the axes that do not divide a dimension, reading
only ``mesh.shape``. ``NamedSharding(mesh, spec).devices_indices_map``
gives each mesh position its block of a global tensor, as JAX's does, and
``device_put`` cuts a tensor into those blocks on their devices
(``ShardedTensor``, whose ``gather`` puts them back together). Positions,
not devices, key the blocks: a device may fill several positions of a
port's mesh (``launch/mesh.py``).

``shard(x, name)`` is the reference's activation-constraint hook. The
port's models do not call it: eager PyTorch in one process has no
compiler to pass a constraint to, and the spec table's users are the
parameter, cache and optimizer-state specs and the dry run. So it checks
that ``name`` is a spec name and returns ``x``.

``Rules`` also holds the decode's model axis as a list of
``torch.device``s: the sequence shards of the KV cache, slice ``j`` on
``model_devices[j]`` (a device may repeat, so one card holds several
slices). ``use_rules`` makes a rule set active for the model code
(``models/attention.attn_decode`` reads it through ``active_rules``);
without one the decode runs on one device. ``make_rules(mesh)`` takes the
devices along the mesh's ``model`` axis.

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
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_STATE = threading.local()

Position = Tuple[int, ...]


def _entry(entry):
    """An entry as JAX keeps it: a list becomes a tuple, a tuple of one
    name that name, an empty tuple None."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


class PartitionSpec(tuple):
    """One entry a dimension: an axis name, ``None`` (not sharded) or a
    tuple of names (sharded over their product, the first name major),
    normalized as JAX's. A leaf of ``repro_torch.tree``."""

    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, map(_entry, entries))

    def __getnewargs__(self):           # copy and pickle: the entries
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def _specs(batch_axes, model_axis) -> Dict[str, P]:
    """Spec name -> spec for the given batch axes and model axis."""
    b = batch_axes
    m = model_axis
    return {
        # activations
        "act_btd": P(b, None, None),          # (batch, seq, d_model)
        "act_btd_sp": P(b, m, None),          # sequence-parallel variant
        "act_ff": P(b, None, m),              # (batch, seq, d_ff)
        "act_heads": P(b, None, m, None),     # (batch, seq, heads, head_dim)
        "act_bhtd": P(b, m, None, None),      # (batch, heads, seq, head_dim)
        "act_bhtd_cp": P(b, None, m, None),   # context-parallel q: seq over
                                              # model (head count need not
                                              # divide the axis)
        "act_btv": P(b, None, m),             # logits (batch, seq, vocab)
        "act_bd": P(b, None),                 # (batch, d_model)
        "act_bhd": P(b, m, None),             # decode q (batch, heads, head_dim)
        "act_moe": P(m, None, None),          # (experts, capacity, d_model)
        # params
        "p_embed": P(m, None),                # (vocab, d_model)
        "p_out": P(None, m),                  # (d_model, vocab|ff|heads*hd)
        "p_in": P(m, None),                   # (ff|heads*hd, d_model)
        "p_norm": P(None),
        "p_bias_m": P(m),
        "p_expert_out": P(m, None, None),     # (E, d_model, d_ff)
        "p_expert_in": P(m, None, None),      # (E, d_ff, d_model)
        "p_router": P(None, m),
        # kv cache: (batch, kv_heads, seq, head_dim), sequence-sharded on model
        "kv_cache": P(b, None, m, None),
        "kv_prefill": P(b, None, None, None),
        "replicated": P(),
    }


SPEC_NAMES = frozenset(_specs(None, None))


class Rules:
    """A rule set: the spec table for ``batch_axes`` and ``model_axis`` of
    ``mesh`` (``make_rules`` builds one from a mesh), and the decode's
    model axis as devices. ``Rules(model_devices)`` alone is a decode's
    sequence shards with no mesh: ``model_axis`` is ``"model"`` when the
    list is not empty, ``batch_axes`` None. ``seq_shard`` puts the residual
    stream's sequence dimension on ``model`` (Megatron-SP); ``ws_decode``
    puts d_model on the batch axes (weight-stationary serving), MoE
    dispatch buffers too."""

    def __init__(self, model_devices: Optional[Sequence] = None, *,
                 mesh=None, batch_axes=None, model_axis: Optional[str] = None,
                 seq_shard: bool = False, ws_decode: bool = False):
        self.model_devices: List[torch.device] = [
            torch.device(d) for d in (model_devices or ())]
        if model_axis is None and self.model_devices:
            model_axis = "model"
        self.mesh = mesh
        self.table = _specs(batch_axes, model_axis)
        if seq_shard:
            self.table["act_btd"] = self.table["act_btd_sp"]
        if ws_decode:
            self.table["act_bd"] = P(None, batch_axes)
            self.table["act_moe"] = P(model_axis, None, batch_axes)
        self.batch_axes = batch_axes
        self.model_axis = model_axis
        self.seq_shard = seq_shard
        self.ws_decode = ws_decode

    @property
    def model_size(self) -> int:
        return len(self.model_devices)

    def spec(self, name: str) -> P:
        return self.table[name]

    def sharding(self, name: str) -> "NamedSharding":
        if self.mesh is None:
            raise ValueError("rules built from model_devices have no mesh; "
                             "make_rules(mesh) builds rules with one")
        return NamedSharding(self.mesh, self.table[name])


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


def make_rules(mesh, seq_shard: bool = False,
               ws_decode: bool = False) -> Rules:
    """The reference's rules for ``mesh``: ``model`` as the model axis
    (its devices the decode's sequence shards), ``pod`` and ``data`` as
    the batch axes, each where the mesh has it."""
    axes = mesh.axis_names
    model_axis = "model" if "model" in axes else None
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return Rules(mesh.axis_devices("model") if model_axis else None,
                 mesh=mesh, batch_axes=batch if batch else None,
                 model_axis=model_axis, seq_shard=seq_shard,
                 ws_decode=ws_decode)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec, shape: Sequence[int], mesh) -> P:
    """Drop mesh axes that do not evenly divide the corresponding dim.

    Keeps specs legal for every architecture uniformly (e.g. 28 attention
    heads or batch=1 on a 16-way axis fall back to replication on that dim
    instead of relying on GSPMD padding). Reads only ``mesh.shape``.
    """
    out = []
    for i, entry in enumerate(spec):
        if i >= len(shape):
            break                      # spec longer than rank: truncate
        if entry is None:
            out.append(entry)
            continue
        size = 1
        kept = []
        for a in _axes(entry):
            if a not in mesh.shape:
                continue
            n = mesh.shape[a]
            if shape[i] % (size * n) == 0:
                kept.append(a)
                size *= n
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def shard(x: torch.Tensor, spec_name: str) -> torch.Tensor:
    """The reference's sharding constraint: checks ``spec_name`` and
    returns ``x`` (the port's models place nothing by name)."""
    if spec_name not in SPEC_NAMES:
        raise KeyError(spec_name)
    return x


class NamedSharding:
    """``spec`` over ``mesh``: which block of a global tensor each mesh
    position holds. A dimension named by axes splits into as many equal
    blocks as their sizes' product; the others are whole at every
    position."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)
        used = [a for entry in self.spec for a in _axes(entry)]
        for a in used:
            if a not in mesh.shape:
                raise ValueError(f"axis {a!r} of {self.spec} is not in the "
                                 f"mesh's {tuple(mesh.shape)}")
        if len(set(used)) != len(used):
            raise ValueError(f"{self.spec} names an axis twice")

    def _tiling(self, shape: Sequence[int]) -> List[Tuple[str, ...]]:
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} is longer than the rank of "
                             f"{tuple(shape)}")
        axes = [_axes(e) for e in self.spec]
        axes += [()] * (len(shape) - len(axes))
        for dim, names in zip(shape, axes):
            n = math.prod(self.mesh.shape[a] for a in names)
            if dim % n:
                raise ValueError(f"{self.spec} splits a dimension of "
                                 f"{tuple(shape)} {n} ways unevenly")
        return axes

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one position's block."""
        return tuple(dim // math.prod(self.mesh.shape[a] for a in names)
                     for dim, names in zip(shape, self._tiling(shape)))

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[Position, Tuple[slice, ...]]:
        """Mesh position -> its block of a ``shape`` tensor, one slice a
        dimension (``slice(None)`` where the dimension is not split), as
        JAX's map keyed by device."""
        tiling = self._tiling(shape)
        names = list(self.mesh.shape)
        sizes = self.mesh.shape
        out = {}
        for pos in self.mesh.positions():
            index = []
            for dim, axes in zip(shape, tiling):
                n = math.prod(sizes[a] for a in axes)
                if n == 1:
                    index.append(slice(None))
                    continue
                block = 0
                for a in axes:
                    block = block * sizes[a] + pos[names.index(a)]
                step = dim // n
                index.append(slice(block * step, (block + 1) * step))
            out[pos] = tuple(index)
        return out


def device_bytes(leaves, specs, mesh) -> int:
    """Bytes that one mesh position holds of ``leaves`` (tensors or
    ``TensorSpec``s: a shape and a dtype each) under ``specs``, one a leaf
    in order, each sanitized for its leaf and ``mesh`` first."""
    total = 0
    for x, spec in zip(leaves, specs, strict=True):
        shape = tuple(x.shape)
        sharding = NamedSharding(mesh, sanitize_spec(spec, shape, mesh))
        total += math.prod(sharding.shard_shape(shape)) * x.dtype.itemsize
    return total


def _block_key(index: Tuple[slice, ...]) -> Tuple:
    return tuple((s.start, s.stop) for s in index)


class ShardedTensor:
    """A global tensor's blocks on a mesh: ``blocks[position]`` on
    ``sharding.mesh.devices[position]``. Positions that hold the same block
    on the same device share one tensor."""

    def __init__(self, sharding: NamedSharding, shape: Tuple[int, ...],
                 dtype: torch.dtype, blocks: Dict[Position, torch.Tensor]):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = blocks

    def gather(self) -> torch.Tensor:
        """The global tensor, on the first position's device."""
        index_map = self.sharding.devices_indices_map(self.shape)
        first = next(iter(self.blocks.values()))
        out = torch.empty(self.shape, dtype=self.dtype, device=first.device)
        done = set()
        for pos, index in index_map.items():
            if _block_key(index) not in done:
                done.add(_block_key(index))
                out[index].copy_(self.blocks[pos])
        return out


def device_put(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` cut into ``sharding``'s blocks, each copied to its position's
    device."""
    blocks, made = {}, {}
    for pos, index in sharding.devices_indices_map(x.shape).items():
        dev = sharding.mesh.devices[pos]
        key = (str(dev), _block_key(index))
        if key not in made:
            part = x[index]
            made[key] = torch.empty(part.shape, dtype=x.dtype,
                                    device=dev).copy_(part)
        blocks[pos] = made[key]
    return ShardedTensor(sharding, tuple(x.shape), x.dtype, blocks)


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
