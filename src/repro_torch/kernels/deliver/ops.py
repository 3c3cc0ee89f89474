"""Launcher of the deliver kernel (``csrc/deliver.cu``): ``core/broker.py
deliver_all``, the broker's fused convert and send stages with spill
capture and the retry ring, on a CUDA card.

``broker.deliver_all`` picks the version by the tensor's device: a CUDA
tensor comes here (``deliver`` launches the kernel, or raises), a ``cpu``
or ``meta`` tensor runs the plain version, ``broker.deliver_plain``. Both
give the same ``FusedDelivery`` bit for bit (everything is integer), but
for the wire lines past each channel's delivered count: the kernel leaves
them as the buffer held them, where the plain version writes zeros. No
reader looks past a channel's ``delivered`` lines.

The kernel writes only the live wire lines, handed out from a counter over
every channel to a grid sized to the card (``LINE_BLOCKS_PER_SM`` blocks an
SM), not to the buffer; it writes them with 16-byte stores where ``vector_ok``
holds for the payload buffer and the line width, a word a thread otherwise;
notify's tail likewise; the validity flags are read 16 to a load where
``P % 16 == 0`` and the flags start on a 16-byte boundary. A group table
given without its member counts has them counted here, ``(sids >= 0)``
summed over each row, as the plain version does.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import broker, plans, records

# deliver calls that launched the kernels (never the plain version), of
# them those whose wire lines took the 16-byte path, and the largest
# (C, max_pairs, width) launched
LAUNCHES = 0
VECTOR_LAUNCHES = 0
SHAPE = None
ALIGN = 16          # bytes: the 16-byte loads and stores
QUAD = 4            # int32 words a 16-byte store
THREADS = 256       # threads a block of count, scatter, write (kThreads)
SCAN_THREADS = 1024  # threads of scan's block a channel (kScanThreads)
TILE = 4096         # pairs a block of the count and scatter kernels
FAN_BLOCKS = 1024   # at most this many blocks fill notify and copy members
LINE_BLOCKS_PER_SM = 8  # blocks of the line walk an SM (kLineBlocksPerSm)
SMALL = 32          # a pair with more members is copied by a block of its own
MAX_BLOCKS = 2 ** 31 - 1
MAX_BROKERS = 12288  # the per-broker tally lives in shared memory
I32 = torch.int32
# rows of the kernel's per-channel counters (csrc/deliver.cu Stat); after
# them the queued items, the two spill totals and the line walk's counter
(DELIV_P, PROD_P, DELIV_S, PROD_S, STALE, RING_P, RING_S, N_RING, OV_P, OV_S,
 CAP_P, SID_BASE, N_STAT) = range(13)


class _Args(ctypes.Structure):
    """csrc/deliver.cu's ``Args``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "valid", "rows", "tgts", "sids", "counts", "brokers", "caps_p",
        "caps_n", "ring_rows", "ring_tgts", "ring_epochs", "ring_pcount",
        "ring_sids", "ring_scount", "epochs", "payload", "notify", "stats",
        "per_broker", "spill_mask", "ps_rows", "ps_ch", "ps_tgts", "ps_valid",
        "ss_vals", "ss_ch", "ss_valid", "nr_rows", "nr_tgts", "nr_epochs",
        "nr_sids", "tile_sums", "tile_offs", "slots", "items")]
        + [(name, ctypes.c_int64) for name in (
            "C", "P", "T", "S", "Tc", "Tb", "B", "W", "spill_cap",
            "max_pairs", "max_notify", "width", "payload_words", "items_cap",
            "tiles", "identity", "ring", "vector_valid", "vector_lines",
            "vector_notify", "sms")])


def vector_ok(tensors: Sequence[torch.Tensor], words: int) -> bool:
    """Whether 16-byte stores take a buffer of rows ``words`` int32 wide:
    ``words % 4 == 0`` and every tensor given starting on a 16-byte
    boundary."""
    return words % QUAD == 0 and all(t.data_ptr() % ALIGN == 0
                                     for t in tensors)


def grid(channels: int, max_pairs: int, width: int, max_notify: int,
         vector: bool, sms: int) -> Tuple[int, int, int, int, int]:
    """The write kernel's launch on a card of ``sms`` SMs, as the C entry
    sizes it: (fan blocks, line blocks, threads a block, threads a line,
    lines a block). A line takes a block where it has at least THREADS
    units (16-byte quads on the vector path, words off it); a narrower line
    takes as many threads as it has units and a block takes THREADS //
    units lines. The line blocks take the live lines from a counter:
    LINE_BLOCKS_PER_SM an SM, fewer where the buffer holds fewer line
    blocks. The fan blocks, one a 1,024 words of notify and at most
    FAN_BLOCKS, come first."""
    units = width // QUAD if vector else width
    span = min(max(units, 1), THREADS)
    per_block = THREADS // span
    fan = min(max(-(-channels * max_notify // (QUAD * THREADS)), 1),
              FAN_BLOCKS)
    line = min(-(-channels * max_pairs // per_block), sms * LINE_BLOCKS_PER_SM)
    return fan, line, THREADS, span, per_block


def sm_count(dev: torch.device) -> int:
    """The SMs of the card ``dev``, which size the line walk's grid."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


_FALSE: Dict[torch.device, torch.Tensor] = {}


def _all_false(dev: torch.device, shape) -> torch.Tensor:
    """An all-False bool tensor of ``shape`` that takes no memory: the
    ring-aware stage's spill mask, False by construction."""
    if dev not in _FALSE:
        _FALSE[dev] = torch.zeros((), dtype=torch.bool, device=dev)
    return _FALSE[dev].expand(shape)


def _on_device(x, dev: torch.device) -> Optional[torch.Tensor]:
    """(C,) int32 on ``dev``: a tensor as it is (cast if it must be), a
    host sequence copied without blocking the host."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=I32).contiguous()
    return records.to_device(np.asarray(x, dtype=np.int32).reshape(-1), dev)


def _carve(dev: torch.device, dtype: torch.dtype, sizes: Sequence[int]):
    """One allocation cut into 1-D views of ``sizes`` elements, each
    starting on a 16-byte boundary."""
    per = ALIGN // dtype.itemsize
    parts = []
    for n in sizes:
        parts += [n, -n % per]
    buf = torch.empty(sum(parts), dtype=dtype, device=dev)
    return buf.split_with_sizes(parts)[::2]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def deliver(result: plans.ChannelResult, group_sids: torch.Tensor,
            payload_words: int, max_pairs: int, max_notify: int,
            spill_cap: int, caps_pairs=None, caps_notify=None,
            target_brokers: Optional[torch.Tensor] = None,
            num_brokers: int = 0, counts: Optional[torch.Tensor] = None,
            ring: Optional[broker.RetryRing] = None, epochs=None,
            out: Optional[Dict[str, torch.Tensor]] = None
            ) -> broker.FusedDelivery:
    """One kernel call, with ``broker.deliver_all``'s arguments and result.
    ``out`` may give the ``payload``, ``notify`` and (ring-less)
    ``spill_mask`` buffers: the card-only tests pass views whose neighbours,
    and whose payload lines past each channel's delivered count, hold a
    sentinel. Everything else is new."""
    global LAUNCHES, VECTOR_LAUNCHES, SHAPE
    from repro_torch.kernels import _build
    dev = result.pair_valid.device
    if dev.type != "cuda":
        raise ValueError(f"deliver: the kernel runs on a CUDA card, got {dev}")
    C = result.pair_valid.shape[0]
    valid2 = result.pair_valid.reshape(C, -1)
    rows2 = result.pair_rows.reshape(C, -1)
    tgt2 = result.pair_targets.reshape(C, -1)
    P = valid2.shape[1]
    identity = group_sids.shape[-1] == 0
    if identity:
        T = S = 0
        width = broker.HEADER_WORDS + 1 + payload_words
    else:
        if group_sids.dim() != 3:
            raise ValueError("deliver: a group table must be (C, T, S), got "
                             f"{tuple(group_sids.shape)}")
        T, S = group_sids.shape[1:]
        if counts is None:
            counts = (group_sids >= 0).sum(dim=-1, dtype=I32)
        width = broker.HEADER_WORDS + S + payload_words
    nb = int(num_brokers) if target_brokers is not None else 0
    W = ring.window if ring is not None else 0
    checks = [("valid", valid2, torch.bool, (C, P)),
              ("rows", rows2, I32, (C, P)), ("targets", tgt2, I32, (C, P))]
    if not identity:
        checks += [("group_sids", group_sids, I32, (C, T, S)),
                   ("counts", counts, I32, (C, counts.shape[-1]))]
    if nb:
        checks.append(("target_brokers", target_brokers, I32,
                       (C, target_brokers.shape[-1])))
    if ring is not None:
        checks += [(f"ring {name}", t, I32, (C,) if t.dim() == 1 else (C, W))
                   for name, t in zip(ring._fields, ring)]
    out = dict(out or {})
    shapes = {"payload": (I32, (C, max_pairs, width)),
              "notify": (I32, (C, max_notify)),
              "spill_mask": (torch.bool, (C, P))}
    checks += [(f"out {name}", t, *shapes[name]) for name, t in out.items()]
    for name, t, dtype, shape in checks:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"deliver: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if P == 0 or C == 0:
        raise ValueError("deliver: the result holds no pair slot")
    if nb > MAX_BROKERS:
        raise ValueError(f"deliver: at most {MAX_BROKERS} brokers, got {nb}")
    caps_p = _on_device(caps_pairs, dev)
    caps_n = _on_device(caps_notify, dev)
    ep = _on_device(epochs, dev) if ring is not None else None
    for name, t in (("caps_pairs", caps_p), ("caps_notify", caps_n),
                    ("epochs", ep)):
        if t is not None and t.shape != (C,):
            raise ValueError(f"deliver: {name} must hold {C} values, got "
                             f"{tuple(t.shape)}")

    for name, (dtype, shape) in shapes.items():
        if name not in out and (name != "spill_mask" or ring is None):
            out[name] = torch.empty(shape, dtype=dtype, device=dev)
    payload, notify = out["payload"], out["notify"]
    tiles = -(-P // TILE)
    items_cap = 0 if identity else min(
        C * P, C * (-(-(max_notify + W + spill_cap) // (SMALL + 1)) + 1))
    sc = C * spill_cap
    (stats, per_broker, ps_rows, ps_ch, ps_tgts, ss_vals, ss_ch, nr_rows,
     nr_tgts, nr_epochs, nr_sids, tile_sums, tile_offs, slots,
     items) = _carve(dev, I32, [
         N_STAT * C + 4, C * nb, sc, sc, sc, sc, sc, C * W, C * W, C * W,
         C * W, 2 * C * tiles, 2 * C * tiles, 2 * C * max_pairs,
         4 * items_cap])
    spill_mask = (out["spill_mask"] if ring is None
                  else _all_false(dev, (C, P)))
    ps_valid, ss_valid = _carve(dev, torch.bool, [sc, sc])

    # the flags are read, and the ring-less mask written, 16 bytes at once
    vector_valid = P % 16 == 0 and all(
        t.data_ptr() % ALIGN == 0
        for t in ([valid2] if ring is not None else [valid2, spill_mask]))
    vector_lines = vector_ok([payload], width)
    vector_notify = vector_ok([notify], max_notify)
    r = ring if ring is not None else (None,) * 6
    args = _Args(
        _ptr(valid2), _ptr(rows2), _ptr(tgt2),
        None if identity else _ptr(group_sids),
        None if identity else _ptr(counts),
        _ptr(target_brokers) if nb else None, _ptr(caps_p), _ptr(caps_n),
        *(_ptr(t) for t in r), _ptr(ep),
        _ptr(payload), _ptr(notify), _ptr(stats), _ptr(per_broker),
        None if ring is not None else _ptr(spill_mask),
        _ptr(ps_rows), _ptr(ps_ch), _ptr(ps_tgts), _ptr(ps_valid),
        _ptr(ss_vals), _ptr(ss_ch), _ptr(ss_valid),
        _ptr(nr_rows), _ptr(nr_tgts), _ptr(nr_epochs), _ptr(nr_sids),
        _ptr(tile_sums), _ptr(tile_offs), _ptr(slots), _ptr(items),
        C, P, T, S, 0 if identity else counts.shape[-1],
        target_brokers.shape[-1] if nb else 0, nb, W, spill_cap, max_pairs,
        max_notify, width, payload_words, items_cap, tiles, int(identity),
        int(ring is not None), int(vector_valid), int(vector_lines),
        int(vector_notify), sm_count(dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.deliver_launch(ctypes.byref(args), ctypes.c_void_p(stream))
    _build.check(code, "deliver")
    LAUNCHES += 1
    VECTOR_LAUNCHES += vector_lines
    SHAPE = _build.larger(SHAPE, (C, max_pairs, width))

    row = stats[:N_STAT * C].view(N_STAT, C).unbind(0)
    total_p, total_s = stats[N_STAT * C + 1], stats[N_STAT * C + 2]
    pack = broker.PackedDelivery(payload, row[DELIV_P], row[PROD_P],
                                 spill_mask, per_broker.view(C, nb))
    fan = broker.FanoutDelivery(notify, row[DELIV_S], row[PROD_S])
    pair_spill = plans.PairStream(ps_rows, ps_ch, ps_tgts, ps_valid, total_p)
    sid_spill = plans.ValueStream(ss_vals, ss_ch, ss_valid, total_s)
    if ring is None:
        return broker.FusedDelivery(pack, fan, pair_spill, sid_spill)
    new_ring = broker.RetryRing(nr_rows.view(C, W), nr_tgts.view(C, W),
                                nr_epochs.view(C, W), row[RING_P],
                                nr_sids.view(C, W), row[RING_S])
    counters = broker.RingCounters(ring.pair_count, row[STALE], row[RING_P],
                                   ring.sid_count, row[RING_S])
    return broker.FusedDelivery(pack, fan, pair_spill, sid_spill, new_ring,
                                counters)
