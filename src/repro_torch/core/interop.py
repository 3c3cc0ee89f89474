"""Carry device state across from the reference engine.

The reference's device state after ingestion is the ActiveDataset
(fields, location, size) and the BADIndexState (row_ids, counts,
watermarks, overflowed). Handed over as numpy arrays, ``state_from_numpy``
rebuilds both on a device, so the port can continue from any point of the
reference's run — after a ring wraparound, for instance. The subscription
control plane is rebuilt by replaying the same control-plane calls on the
port's engine; ``load_engine_state`` then installs the device state and the
few host marks that go with it (``now``, ``size_host``, each channel's last
execution point). ``params_from_numpy`` carries a model's initialised
parameters across the same way.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import bad_index as bidx
from repro_torch.core import records as R
from repro_torch.device import DeviceLike, resolve_device


def state_from_numpy(fields: np.ndarray, location: np.ndarray, size,
                     row_ids: np.ndarray, counts: np.ndarray,
                     watermarks: np.ndarray, overflowed: np.ndarray,
                     device: DeviceLike = "cuda"
                     ) -> Tuple[R.ActiveDataset, bidx.BADIndexState]:
    """(ActiveDataset, BADIndexState) on ``device`` from the reference's
    arrays; dtypes are checked against the reference's (int32 / float32 /
    bool) and every array is copied."""
    dev = resolve_device(device)

    def put(a, dtype, ndim, name):
        a = np.asarray(a)
        if a.dtype != dtype or a.ndim != ndim:
            raise ValueError(f"{name}: expected {ndim}-d {np.dtype(dtype)}, "
                             f"got {a.ndim}-d {a.dtype}")
        return torch.tensor(a, device=dev)

    ds = R.ActiveDataset(put(fields, np.int32, 2, "fields"),
                         put(location, np.float32, 2, "location"),
                         put(size, np.int32, 0, "size"))
    index = bidx.BADIndexState(put(row_ids, np.int32, 2, "row_ids"),
                               put(counts, np.int32, 1, "counts"),
                               put(watermarks, np.int32, 1, "watermarks"),
                               put(overflowed, np.bool_, 1, "overflowed"))
    return ds, index


def load_engine_state(engine, dataset: R.ActiveDataset,
                      index: bidx.BADIndexState, now: int,
                      marks: Dict[str, Tuple[int, int, int]]) -> None:
    """Install carried-over state on a port engine whose channels and
    subscriptions were created by the same calls as the reference's.

    ``now`` is the reference engine's ingest clock and ``marks`` maps each
    channel to its ``(last_exec_ts, last_exec_size, executions)``; the
    engine's ``size_host`` follows the dataset. The engine must be on the
    state's device, and its shapes must match."""
    if dataset.fields.shape != engine.dataset.fields.shape:
        raise ValueError("dataset capacity or schema differs from the engine")
    if index.row_ids.shape != engine.index_state.row_ids.shape:
        raise ValueError("BAD-index shape differs from the engine")
    if dataset.device != engine.device:
        raise ValueError(f"state on {dataset.device}, engine on {engine.device}")
    if set(marks) != set(engine.channels):
        raise ValueError(f"marks for {sorted(marks)}, engine has "
                         f"{sorted(engine.channels)}")
    engine.dataset = dataset
    engine.index_state = index
    engine.size_host = int(dataset.size.item())
    engine.now = int(now)
    for name, (ts, size, executions) in marks.items():
        st = engine.channels[name]
        st.last_exec_ts, st.last_exec_size, st.executions = \
            int(ts), int(size), int(executions)


def params_from_numpy(cfg, tree, device: DeviceLike = "cuda"):
    """The reference's model parameter tree, as numpy arrays, as the port's
    parameters on ``device``. The trees the reference stacks on axis 0 and
    scans become the port's lists with one tree per depth: ``layers`` (an
    LM's superlayers) and an enc-dec's ``dec_layers`` over
    ``superlayer_repeat``, ``enc_layers`` over ``n_enc_layers``. Every other
    entry (``embed``, the norms, ``head``, and zamba2's un-stacked
    ``shared`` block) keeps its name and nesting. Dtypes carry over
    (bfloat16 included: numpy holds it as ml_dtypes' bfloat16, which is
    moved bit for bit). ``jax.random`` cannot be reproduced in torch, so the
    parity tests carry the reference's initialised parameters across with
    this."""
    dev = resolve_device(device)
    depth = {"layers": cfg.superlayer_repeat,
             "dec_layers": cfg.superlayer_repeat,
             "enc_layers": cfg.n_enc_layers}

    def put(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.view(np.int16), device=dev).view(
                torch.bfloat16)
        return torch.tensor(a, device=dev)

    def tmap(fn, node):
        if isinstance(node, dict):
            return {k: tmap(fn, v) for k, v in node.items()}
        return fn(node)

    out = {}
    for key, node in tree.items():
        if key in depth:
            out[key] = [tmap(lambda a, i=i: put(np.asarray(a)[i]), node)
                        for i in range(depth[key])]
        else:
            out[key] = tmap(put, node)
    return out
