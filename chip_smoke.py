#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository's ``src/`` beside this file; it
exits non-zero, printing no result, without them. Phases:

1. Build the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, started together; the ``-Xptxas -v`` lines are printed with a
   summary of each kernel's registers and spills, and the HGMMA count of
   each bf16 ``flash_attention`` instantiation from ``cuobjdump -sass``) and
   hold every kernel entry against its plain PyTorch version on the card,
   exactly, on edge cases (``join_compact`` on both of its paths, between
   sentinels).
2. The per-channel main path at a size users would call real: one engine,
   three channels (TweetsAboutDrugs with 1,000,000 subscriptions,
   MostThreateningTweets with 200,000, TweetsAboutCrime3 over 10,000 users),
   40 ticks of 65,536 tweets (the 2M-row ring buffer wraps once), each tick
   executing every channel through ``execute_channel`` under the fully
   optimized plan with broker delivery.
3. The fused main path on the same configuration: ``execute_all(None,
   deliver=True)`` with the two param channels on ``compact_pallas`` and
   TweetsAboutCrime3 on ``pallas`` (two plan-groups per tick), then
   ``drain_spilled()``, every tick. Both main paths check per-stage
   delivery conservation (ring counters included), notified counts against
   a numpy count, spatial hits against a numpy evaluation and each kernel's
   launches per tick; the fused reports of the first tick must equal
   ``execute_channel`` on a second engine built the same way.
4. The compact join at a real grid: six TweetsAboutDrugs copies on a window
   scan, flat layout, population-skewed subscriptions, 2% match, sized so
   that ``join_compact``'s four output grids exceed 1 GB; ``compact_pallas``
   against ``pallas``, count for count.
5. Every plan: the seven plans of the paper's plan-equivalence test through
   ``execute_channel`` on both padded backends and through ``execute_all``
   on all four; all notify the same subscribers and match the same rows.
6. Serve: qwen2-1.5b at its published width and depth (28 layers, bf16,
   seeded weights) through ``launch/serve.py::serve`` at batch 8, prompt
   512, 32 generated tokens: 28 ``flash_attention`` launches in the prefill
   and 28 x 31 ``flash_decode`` in the decode; then cached decode against
   the teacher-forced forward for 3 tokens.
7. The enriched fused tick: phase 3's engine with ``LMScorer`` (qwen2-1.5b
   at full width, budget 4,096) attached, ``execute_all(None,
   deliver=True)`` + ``drain_spilled()``: conservation with the ranked
   counts, ``ranked_pairs`` == max(0, produced - budget) per channel, the
   rank rule checked on the host for one tick, 28 ``flash_attention``
   launches per scored group.

8. Churn: phase 3's engine and plans with TweetsAboutCrime3 turned into an
   explicit cohort of 5,000 users, under the reference's churn suite at 1M
   live subscriptions (``benchmarks/churn.py``: 4 batches a tick of 2,500
   TweetsAboutDrugs adds and removes, 500 MostThreateningTweets, 312 cohort
   users) and 65,536 tweets a tick, through ``core/churn.run_ticks``: (a)
   the incremental engine, 2 warmup and 20 timed ticks; (b) the same engine
   built again at ``pipeline_depth=2``, whose counters must equal (a)'s;
   (c) a rebuild engine (``incremental=False``), 4 timed ticks, and the
   ratio of (a)'s subscription mutations a second over (c)'s; (d) (a)'s
   engine for 6 ticks with ``RuntimePlanner`` hooked in. Conservation every
   tick, no rebuilds and some patches in (a) and (b), one
   ``predicate_filter``, ``spatial_match_stacked`` and ``join_compact``
   (quad path) a tick, and the cohort's spatial hits of one tick against
   numpy.
9. Sharded: phase 3's engine, plans and workload (65,536 tweets a tick)
   through ``ShardedBADEngine`` with cross-shard routing at 1 and at 4
   shards on the one card (TweetsAboutCrime3's 10,000 users hash-split
   into per-shard cohorts), 2 + 10 ticks each: per-shard conservation,
   each shard's delivered sIDs on their hash shard, ``routed`` holding
   exactly the delivered sIDs with each row on its broker's shard, S
   launches a tick of ``predicate_filter``, ``spatial_match_stacked`` and
   ``join_compact``; tick by tick the produced sIDs of every channel and
   TweetsAboutCrime3's delivered sID multiset (its sIDs never overflow)
   equal at 1 and 4 shards, and the param channels, whose sIDs overflow
   the per-shard buffers, never deliver an sID more often than the ticks
   produced it (numpy counts). The 4-shard engine reshards to 2 after its
   5th timed tick, rings populated: nothing dropped, the registry equal to
   the shards' live sIDs on their hash shards; its last 5 ticks run on 2
   shards. The same engines at 512 tweets a tick, where no buffer
   overflows, 2 + 4 ticks with a ``reshard(2)`` after the 2nd: every
   tick's delivered sID and (row, sID) multisets equal at 1 and 4 (then
   2) shards. Last, ``sp_decode_attention`` at the serve phase's last
   decode step over 4 sequence slices on the card, against one
   ``flash_decode`` call and the plain version within the bf16
   tolerance, 4 partial launches a call. Each ``[sharded]`` line carries
   the card's line; a tick's host time is split by part (ingest, the
   shards' ``dispatch`` and ``_materialize_group``, the shuffle, the
   drain).
10. Families: each of the MoE, SSM, hybrid, VLM and encoder-decoder
   configurations at its published width, bf16 weights from a seeded
   generator, through ``launch/serve.py::serve`` with 16 greedy tokens:
   phi3.5-moe-42b-a6.6b (8 of 32 layers) and dbrx-132b (2 of 40) at batch
   8, prompt 512; pixtral-12b (40 layers, 512 seeded embeddings, batch 4);
   zamba2-2.7b (9 x 7 blocks, head dim 80) and xlstm-125m (float32
   weights) at batch 8, prompt 512; seamless-m4t-medium (12 + 12 layers,
   1,024 frames and 4 decoder tokens, batch 8). One family at a time, its
   memory freed before the next. Each prints prefill ms, decode ms a token,
   the kernels' launches (exactly one ``flash_attention`` an attention
   block a prefill and one ``flash_decode`` a step, the enc-dec's encoder,
   self and cross attention each; xlstm has none and launches neither) and
   peak memory; its logits are finite; a prefill and 3 decode steps with
   the kernels match the same steps with the plain attention versions
   bound in by this script (every row within phase 6's limits or twice the
   model's rounding floor, measured as the distance that one rounding step
   of the attention moves its logits; in the MoE families 3 rows in 4
   within phase 6's limits, since a row whose expert choice flips differs
   at O(1)); and, without experts, the cached decode matches the
   teacher-forced forward within phase 6's limits in float32 compute.
11. Train: (a) ``launch/train.py::train`` on tinyllama-1.1b at its
   published width and depth (22 layers, bf16 weights from the train
   loop's seeded generator, AdamW, remat): ``TokenStream`` batches of 16 x
   2,048 tokens, accum 8, 8 steps, a checkpoint every 4 (11 GB each, under
   the checkout's ``build/``); then in a fresh directory a run that a
   ``FailureInjector`` stops at step 6 and a second ``train()`` that
   resumes from step 4. Printed: step ms (a loop iteration, the batch's
   build and copy included), tokens/s, MFU, losses,
   grad_norm, peak memory, launches a step (exactly 8 x 22 x 2
   ``flash_attention``: the forward and its remat recompute; the backward
   is the plain version's gradient). Checked: finite losses that fall,
   every parameter leaf with a nonzero gradient on step 1 (wq, wk, wv
   only through the kernel's autograd wrapper), the resumed losses equal
   to the uninterrupted run's bit for bit, no ``.tmp`` left.
   (b) The same model cut to 2 layers, one microbatch: the loss and every
   leaf's gradient with the kernel against the plain attention bound in,
   within phase 6's relative L2 or twice the rounding floor. (c) Train
   steps of pixtral-12b cut to 4 of 40 layers (Adafactor, the ``embed``
   frontend, batch 4 x 1,024) and seamless-m4t-medium whole (AdamW, the
   enc-dec loss, 1,024 frames and 256 decoder tokens, batch 8): a finite
   loss, exactly the leaves without a gradient unmoved (pixtral's token
   table, which its frontend never reads), launches exact, peak memory;
   two steps each, the second timed.
12. Mesh: (a) the parameter, optimizer-state and cache bytes per device
   of all ten arch ids under their sanitized spec trees, over both
   production meshes ((16, 16) and (2, 16, 16) on ``meta``; host
   arithmetic); on qwen2-1.5b at its published width and depth: (b) its
   parameters and AdamW state saved and restored with ``param_pspecs`` /
   ``state_pspecs`` shardings onto a (2, 2) ("data", "model") mesh whose
   four positions are the one card, every 2-d leaf in four blocks, every
   gathered leaf bit-equal to the saved one; (c) its 28 layers pipelined
   (``pipeline_forward``) in 2 and in 4 stages on the card over 8
   microbatches of 2 x 2,048 hidden states, bit-equal to the layers
   applied to each microbatch in turn, 28 x 8 ``flash_attention`` launches
   a run; (d) ``compressed_psum_tree`` over a float32 tree shaped like its
   parameters (1.54 B entries) on a ("pod",) axis of 1, 2 and 4 positions
   of the card: the embedding and layer 0 equal to the port's CPU result,
   every leaf's error-feedback identity; (e) ``selectivity`` of the five
   substrate conditions over 1M tweets on the card equal to the CPU's.
13. Dry run: (a) every (arch x shape x mesh) cell, 10 x 4 x 2, through
   ``launch/dryrun.py run_cell`` on the ``meta`` device (FLOPs by
   ``FlopCounterMode``, argument bytes per device under the sanitized
   specs; the records under ``build/dryrun/``), in this process but for
   xlstm-125m's train_4k and prefill_32k, whose sLSTM loop over every
   token takes the host minutes: those two run in worker processes started
   with phase 11 (the phases before it are bound by the host). One ``[dryrun]`` line a cell, skips exactly where
   ``ModelApi.supports`` is false, and the phase's wall time. (b) The dry run's probes on the card,
   qwen2-1.5b's layer at its published width (bf16, seeded weights) at the
   shapes one data shard of the (16, 16) mesh holds: the train probe
   (grad through one superlayer under remat) at B = 1, S = 4,096 and the
   decode probe at B = 8 over a 32,768-entry cache with 32,767 live. Each
   prints its time by CUDA events, its count on ``meta`` (the reference's
   count, masked causal work included) and that count over the time as a
   share of the bf16 tensor cores' 989 TFLOP/s, its peak memory beside its
   argument bytes and its launches (exactly 2 ``flash_attention`` a train
   probe, the forward and its remat recompute, and 1 ``flash_decode`` a
   decode probe); the same probes with the plain attention bound in hold
   its gradients (phase 11's limits) and outputs (phase 6's).

Phase 1 also holds the two attention kernels against their plain versions
on their edge cases, within a stated tolerance (3e-5 in float32, 2e-2 in
bfloat16, the reference kernel test's), head dim 80 and k/v with their own
length included. Last, every kernel entry is held
against its plain version and timed (a CUDA graph of wrapper calls, the
wrapper and the plain version between CUDA events) beside its bound and,
for the attention kernels, PyTorch's ``scaled_dot_product_attention``, on
seeded inputs at the largest shape a path above gave it (each wrapper keeps
that shape beside its launch count), and at two timing cases where bytes
and not the launch set the time: ``flash_decode`` over a 32,768-key cache
and ``predicate_filter`` over the whole 2M-row ring, and
``flash_decode``'s partial entry at one slice of phase 9's
sequence-parallel decode, and phase 10's new shapes: ``flash_attention``
at zamba2's prefill (head dim 80), seamless's encoder and its
cross-attention (Sk != Sq), ``flash_attention`` at phase 11's training
microbatch, at phase 12's pipeline stage (2 x 2,048 positions of
qwen2-1.5b) and at phase 13's train probe (1 x 4,096),
``flash_decode`` at zamba2's decode and at
seamless's cross step (``flash_decode``'s
cluster size is printed and checked at each shape), ``join_compact``,
``flash_attention`` and ``flash_decode`` beside the floor under their time (the empty kernel of
``csrc/launch_floor.cu`` on the same grid, timed the same way), and
``join_compact``'s path (its quad path at both shapes, asserted from the
wrapper's counts); ``deliver`` (every phase that delivers counts its
launches a tick: a channel a tick on the per-channel path, a plan-group a
tick on the fused ones, the param groups' 10,252-word lines on the 16-byte
path) at the calls of the benchmark's cells, the last of four ticks of
``paper-1m.fused`` (its param and spatial plan-groups) and
``trending-2lang.fused`` on engines built as ``bad_bench/system.py``
builds them, every field of ``FusedDelivery`` against the plain version
bit for bit, timed beside its bound (each output word written once, each
input read where it is needed), the floor of its four grids and the plain
version; then ``torch.profiler``
checks that each ``flash_decode`` entry enqueues one kernel a call (last,
so that its tracing touches no timed phase). The line before the last is a
JSON object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
SEED = 0
# the attention kernels against their plain versions, (atol, rtol) with
# |kernel - plain| <= atol + rtol |plain| per element: the reference kernel
# test's 3e-5 (float32) and 2e-2 (bf16, tests/test_kernels.py), and in bf16
# one more rounding step of the output (2^-7 |plain|): both versions round
# their float32 result to bf16 once, and the plain version's bf16 softmax
# weights move it across a rounding boundary, a step of 0.031 for outputs
# of magnitude 4 to 8 (the scorer's S = 10 averages few values)
FLASH_TOL = {torch.float32: (3e-5, 0.0), torch.bfloat16: (2e-2, 2.0 ** -7)}
# cached decode against the teacher-forced forward at full width in bf16:
# relative L2 error of each compared token's logits, and max abs error
# (the logits' std is about 1 with seeded weights); a wrong cache position,
# RoPE angle or mask gives errors of order 1
DECODE_REL_L2 = 0.05
DECODE_MAX_ABS = 0.5
# what the attention edge cases write around the kernel's output (exact in
# bf16): it must survive every launch
SENTINEL = -12288.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tensor_core_counts(library) -> dict:
    """HGMMA instructions in each bf16 ``flash_attention`` instantiation of
    the built library, by (head dim, key tile), as ``cuobjdump -sass``
    (beside nvcc) shows them."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"bf16_attention_kernelILi(\d+)ELi(\d+)E", line)
            cur = f"D={m[1]} keys={m[2]}" if m else None
            if cur:
                counts[cur] = 0
        elif cur and "HGMMA" in line:
            counts[cur] += 1
    return counts


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls are captured
    in one CUDA graph and replayed between CUDA events, so the graph holds
    only what ``fn`` enqueues on the device (a kernel wrapper's launch) and
    none of its host work (checks, allocation, the ctypes call)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|: in int32 for integer and bool outputs, in float64
    for floating ones; equal infinities count 0, a NaN or an unmatched
    infinity fails."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    if not a.is_floating_point():
        return float((a.to(torch.int32) - b.to(torch.int32)).abs().max())
    a, b = a.double(), b.double()
    same_inf = torch.isinf(a) & (a == b)
    assert not (torch.isnan(a).any() or torch.isnan(b).any()), "NaN"
    assert torch.equal(torch.isinf(a), torch.isinf(b)), "infinities differ"
    return float(torch.where(same_inf, 0.0, a - b).abs().max())


def tol_excess(a: torch.Tensor, b: torch.Tensor, atol: float,
               rtol: float) -> float:
    """The largest amount by which |a - b| passes atol + rtol |b| (<= 0:
    within tolerance); equal infinities count 0."""
    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    same_inf = torch.isinf(b) & (a == b)
    diff = torch.where(same_inf, 0.0, (a - b).abs())
    room = atol + rtol * torch.where(torch.isinf(b), 0.0, b.abs())
    return float((diff - room).max())


def channel_specs():
    from repro_torch.core import channel as ch
    return [ch.tweets_about_drugs(), ch.most_threatening_tweets(),
            ch.tweets_about_crime(3)]


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_conds(rng, c: int, f: int):
    """``c`` channels of one to three seeded predicates over fields < f,
    at most one != per (channel, field), values in [-4, 4]."""
    from repro_torch.core.predicates import Predicate, compile_conditions
    ops = ["==", "!=", "<", "<=", ">", ">="]
    chans = []
    for _ in range(c):
        seen, preds = {}, []
        for _ in range(int(rng.integers(1, 4))):
            fld, op = int(rng.integers(0, f)), ops[int(rng.integers(0, 6))]
            val = int(rng.integers(-4, 5))
            if op == "!=" and seen.setdefault(fld, val) != val:
                continue
            preds.append(Predicate.parse(fld, op, val))
        chans.append(preds)
    return compile_conditions(chans)


def edge_parity(dev) -> dict:
    """Exact parity of every kernel entry with its plain version on its edge
    cases: ``predicate_filter`` on int32 extremes and ragged N (and against
    the engine's ``evaluate_conditions``); ``predicate_filter_rows`` at C = 1
    and 3 with ragged N; both at N off every vector and block boundary with
    F = 1 and 10 (the rows form at C = 1 and 6), with more channels than
    a block holds at once (C = 128 at F = 16, C = 300 at F = 10), and a
    misaligned view refused; ``spatial_match`` in both forms on ragged shapes,
    per-channel radii and +-FAR padding (dist^2 must be inf there, never
    NaN, and no padded pair may hit); ``join_compact`` on S off every block
    size on both of its paths (``join_compact_parity``). Returns
    ``join_compact``'s launches of each path."""
    from repro_torch.core.predicates import (Predicate, compile_conditions,
                                             evaluate_conditions)
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels.predicate_filter import ops as pf_ops
    from repro_torch.kernels.predicate_filter import ref as pf_ref
    from repro_torch.kernels.spatial_match import ops as sm_ops

    rng = np.random.default_rng(SEED)
    specs = channel_specs()
    conds = compile_conditions([list(s.fixed_preds) for s in specs])
    f, _ = syn.tweet_arrays(rng, 4096, t0=1)
    fields = torch.tensor(syn.drug_tweak(f, rng, 0.05), device=dev)
    for n in (1, 7, 255, 257, 1000, 4096):
        x = fields[:n].contiguous()
        assert torch.equal(pf_ops.predicate_filter(x, conds),
                           evaluate_conditions(x, conds)), f"ragged N={n}"
    edge = torch.tensor([[-2**31, 2**31 - 1, 0, 5, 0, 0, 0, 0, 0, 0]],
                        dtype=torch.int32, device=dev)
    econds = compile_conditions([[Predicate.parse(0, "<=", -2**31 + 1)],
                                 [Predicate.parse(1, ">=", 2**31 - 1)],
                                 [Predicate.parse(3, "==", 5),
                                  Predicate.parse(3, "!=", 4)]])
    assert torch.equal(pf_ops.predicate_filter(edge, econds),
                       evaluate_conditions(edge, econds)), "int32 extremes"
    for c in (1, 3):
        conds = compile_conditions([list(sp.fixed_preds)
                                    for sp in (specs * 3)[:c]])
        lo, hi, neq = (torch.tensor(a, device=dev)
                       for a in pf_ops.canonical_arrays(conds, 10))
        for n in (1, 255, 257, 1000, 70001):
            x = torch.tensor(rng.integers(-3, 12, (c, n, 10)).astype(np.int32),
                             device=dev)
            x[..., 3] = torch.tensor(rng.integers(8, 11, (c, n)),
                                     dtype=torch.int32, device=dev)
            got = pf_ops.predicate_filter_rows(x, conds)
            want = pf_ref.predicate_filter_rows(x, lo, hi, neq)
            assert torch.equal(got, want), f"predicate_filter_rows C={c} N={n}"

    # the vectorized pass: N off every 16-byte vector and 256-row block, a
    # record one word wide and the schema's ten, both entries (the rows
    # form at C = 1 and 6), tables past 8 channels or 32 fields (compacted
    # a channel a thread); a view off the 16-byte boundary is refused
    for f, c in ((1, 1), (1, 6), (10, 1), (10, 6), (10, 12), (40, 2)):
        conds = random_conds(rng, c, f)
        lo, hi, neq = (torch.tensor(a, device=dev)
                       for a in pf_ops.canonical_arrays(conds, f))
        for n in (1, 3, 255, 257, 65537):
            x = torch.tensor(rng.integers(-6, 7, (n, f)).astype(np.int32),
                             device=dev)
            assert torch.equal(pf_ops.predicate_filter(x, conds),
                               pf_ref.predicate_filter(x, lo, hi, neq)), \
                f"predicate_filter N={n} F={f} C={c}"
            xr = torch.tensor(rng.integers(-6, 7, (c, n, f))
                              .astype(np.int32), device=dev)
            assert torch.equal(pf_ops.predicate_filter_rows(xr, conds),
                               pf_ref.predicate_filter_rows(xr, lo, hi,
                                                            neq)), \
                f"predicate_filter_rows C={c} N={n} F={f}"
    # more channels than a block's 48 KB of shared memory holds beside its
    # rows (the reference kernel's own budget, C = 128 at F = 16, and 300 at
    # the schema's F = 10): both entries take the channels in chunks; the
    # rows form at N = 1 and 3 puts hundreds of channels in one block
    for f, c in ((16, 128), (10, 300)):
        conds = random_conds(rng, c, f)
        lo, hi, neq = (torch.tensor(a, device=dev)
                       for a in pf_ops.canonical_arrays(conds, f))
        for n in (1, 3, 257, 4099):
            x = torch.tensor(rng.integers(-6, 7, (n, f)).astype(np.int32),
                             device=dev)
            assert torch.equal(pf_ops.predicate_filter(x, conds),
                               pf_ref.predicate_filter(x, lo, hi, neq)), \
                f"predicate_filter N={n} F={f} C={c}"
            xr = torch.tensor(rng.integers(-6, 7, (c, n, f))
                              .astype(np.int32), device=dev)
            assert torch.equal(pf_ops.predicate_filter_rows(xr, conds),
                               pf_ref.predicate_filter_rows(xr, lo, hi,
                                                            neq)), \
                f"predicate_filter_rows C={c} N={n} F={f}"
    if dev.type == "cuda":
        shifted = torch.zeros(257 * 10 + 1, dtype=torch.int32,
                              device=dev)[1:].view(257, 10)
        for fn in (pf_ops.predicate_filter,
                   lambda x, c: pf_ops.predicate_filter_rows(x[None], c)):
            try:
                fn(shifted, conds_for(1))
            except ValueError as e:
                assert "16-byte" in str(e), e
            else:
                raise AssertionError("predicate_filter took a misaligned view")

    def locs(*shape):
        return torch.tensor(rng.uniform(-100, 100, (*shape, 2))
                            .astype(np.float32), device=dev)

    for r, u in ((1, 1), (1, 10000), (300, 700), (16383, 257)):
        a, b = locs(r), locs(u)
        assert torch.equal(sm_ops.spatial_match(a, b, 10.0),
                           sm_ops.spatial_match_plain(a, b, 10.0)), \
            f"spatial_match ragged {r}x{u}"
    for c, r, u in ((1, 1, 1), (1, 300, 700), (3, 257, 10000), (3, 33, 257)):
        t, us = locs(c, r), locs(c, u)
        radius = torch.tensor(rng.uniform(5, 20, c).astype(np.float32),
                              device=dev)
        assert torch.equal(sm_ops.spatial_match(t, us, radius),
                           sm_ops.spatial_match_plain(t, us, radius)), \
            f"spatial_match stacked C={c} R={r} U={u}"
    # the engine pads users at -FAR; the reference pads tweets at +FAR
    far = sm_ops.FAR
    t = torch.tensor([[far, far], [0.0, 0.0], [3.0, -4.0]], device=dev)
    us = torch.tensor([[-far, -far], [0.5, 0.5], [-far, -far]], device=dev)
    want = [[False, False, False], [False, True, False], [False, True, False]]
    assert sm_ops.spatial_match(t, us, 10.0).tolist() == want
    hit = sm_ops.spatial_match(t[None], us[None],
                               torch.tensor([10.0], device=dev))
    d2 = sm_ops.spatial_dist2_plain(t[None], us[None])
    pad = torch.tensor([[[True, True, True], [True, False, True],
                         [True, False, True]]], device=dev)
    assert torch.isinf(d2[pad]).all() and not torch.isnan(d2).any(), d2
    assert hit.tolist() == [want], hit.tolist()

    paths = join_compact_parity(dev, rng)
    torch.cuda.synchronize()
    return paths


# join_compact's edge cases: maxT off and on the 4-column quad, S off every
# block size (256 threads: 256 rows a block on the pair path at maxT 1, 64 on
# the quad path at maxT 16), and one case of three rows 16,384 wide
JOIN_EDGE = [(s, t) for t in (1, 2, 3, 4, 7, 16, 17, 64)
             for s in (1, 37, 4099)] + [(3, 16384)]
# what the join_compact edge cases write around each output (the bool grid's
# buffer holds the byte 0xA5): it must survive every launch
JOIN_SENTINEL = -0x5A5A5A5B
JOIN_PAD = 64       # sentinel elements on each side of an output


def join_inputs(rng, s_len: int, max_t: int) -> list:
    """Seeded numpy inputs of ``join_pairs``: tgt with -1 holes, tgt_n up to
    maxT, 70% valid entries, payloads whose byte sums wrap past int32."""
    return [rng.integers(-1, 20, (s_len, max_t)).astype(np.int32),
            rng.integers(0, max_t + 1, s_len).astype(np.int32),
            rng.integers(0, 9, (s_len, max_t)).astype(np.int32),
            rng.integers(0, 4, (s_len, max_t)).astype(np.int32),
            rng.random(s_len) < 0.7,
            (2 ** 31 - 1 - rng.integers(0, 40, s_len)).astype(np.int32)]


def join_cases(rng):
    """(tag, numpy inputs) of every ``join_compact`` edge case: ``JOIN_EDGE``,
    then at a quad width and off it: no live target, no valid entry,
    tgt_n past maxT (up to int32's largest), and tgt_n 0 with every entry
    valid."""
    for s_len, max_t in JOIN_EDGE:
        yield f"S={s_len} maxT={max_t}", join_inputs(rng, s_len, max_t)
    for s_len, max_t in ((37, 16), (4099, 17)):
        a = join_inputs(rng, s_len, max_t)
        past = max_t + rng.integers(1, 5, s_len).astype(np.int32)
        past[::7] = 2 ** 31 - 1
        every = np.ones_like(a[4])
        for tag, case in (
                ("no live target", [np.full_like(a[0], -1)] + a[1:]),
                ("no valid entry", a[:4] + [np.zeros_like(a[4])] + a[5:]),
                ("tgt_n > maxT", a[:1] + [past] + a[2:4] + [every] + a[5:]),
                ("tgt_n 0, all valid", a[:1] + [np.zeros_like(a[1])]
                 + a[2:4] + [every] + a[5:])):
            yield f"{tag} S={s_len} maxT={max_t}", case


def offset_copy(x: torch.Tensor, lead: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``lead`` elements into a new
    buffer (lead 1: 4 B off the 16-B boundary for int32, 1 B for bool)."""
    buf = torch.empty(x.numel() + lead, dtype=x.dtype, device=x.device)
    view = buf[lead:].view(x.shape)
    view.copy_(x)
    return view


def join_into_sentinel(dv: list, aggregated: bool, lead: int = 0) -> tuple:
    """``join_compact``'s kernel into views of buffers whose ``JOIN_PAD``
    elements on each side hold a sentinel (``lead`` more in front): a store
    past the first or last row would overwrite one. Returns the outputs."""
    from repro_torch.kernels.join_compact import ops as jc_ops
    s_len, max_t = dv[0].shape
    n, dev = s_len * max_t, dv[0].device
    start = JOIN_PAD + lead
    bufs = [torch.full((start + n + JOIN_PAD,), 0xA5, dtype=torch.uint8,
                       device=dev)]
    bufs += [torch.full((start + n + JOIN_PAD,), JOIN_SENTINEL,
                        dtype=torch.int32, device=dev) for _ in range(3)]
    views = [b[start:start + n] for b in bufs]
    out = [views[0].view(torch.bool).view(s_len, max_t)] + \
        [v.view(s_len, max_t) for v in views[1:]]
    got = jc_ops._launch(*dv, 4, aggregated, out=out)
    torch.cuda.synchronize()
    for b, fill in zip(bufs, (0xA5,) + (JOIN_SENTINEL,) * 3):
        assert bool((b[:start] == fill).all() and (b[start + n:] == fill)
                    .all()), f"join_compact wrote past its output S={s_len} " \
            f"maxT={max_t} lead={lead}"
    return got


def join_compact_parity(dev, rng) -> dict:
    """``join_compact`` against its plain version on every ``join_cases``
    case, both layouts, exactly, dtypes included: once on 16-B-aligned
    tensors (the quad path where maxT % 4 == 0) and once on views 1 element
    off the boundary (the pair path). On the card the kernel writes between
    sentinels, and the path each launch took is checked from the wrapper's
    counts. Returns the launches of each path."""
    from repro_torch.kernels.join_compact import ops as jc_ops
    from repro_torch.kernels.join_compact import ref as jc_ref
    cuda = dev.type == "cuda"
    paths = dict(vector=0, scalar=0)
    for tag, case in join_cases(rng):
        max_t = case[0].shape[1]
        for lead in (0, 1):
            dv = [offset_copy(torch.tensor(a, device=dev), lead)
                  for a in case]
            vector = lead == 0 and max_t % jc_ops.QUAD == 0
            for aggregated in (False, True):
                want = jc_ref.join_pairs(*dv, 4, aggregated)
                before = (jc_ops.LAUNCHES, jc_ops.VECTOR_LAUNCHES)
                if cuda:
                    got = join_into_sentinel(dv, aggregated, lead)
                    assert (jc_ops.LAUNCHES, jc_ops.VECTOR_LAUNCHES) == (
                        before[0] + 1, before[1] + vector), (tag, lead)
                    paths["vector" if vector else "scalar"] += 1
                else:
                    got = jc_ops.join_pairs(*dv, 4, aggregated)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), \
                        f"join_compact {tag} lead={lead} agg={aggregated}"
    return paths


def attention_into_sentinel(q, k, v, causal: bool) -> torch.Tensor:
    """``flash_attention`` of (q, k, v), written by the kernel into a view of
    a buffer whose 64 rows on each side hold ``SENTINEL``; asserts they still
    do (a tile stored past its slab's end would overwrite them). On the CPU
    the wrapper's plain version, for rehearsal."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if q.device.type == "cpu":
        return fa_ops.flash_attention(q, k, v, causal=causal)
    pad, n = 64 * q.shape[-1], q.numel()
    buf = torch.full((n + 2 * pad,), SENTINEL, dtype=q.dtype, device=q.device)
    out = buf[pad:pad + n].view(q.shape)
    fa_ops._launch(q, k, v, causal, q.shape[-1] ** -0.5, out=out)
    assert bool((buf[:pad] == SENTINEL).all()
                and (buf[pad + n:] == SENTINEL).all()), (
        "flash_attention stored outside its output", tuple(q.shape),
        tuple(k.shape))
    return out


def decode_into_sentinel(q, k, v, kv_len, normalized: bool):
    """``flash_decode`` of (q, k, v, kv_len), the normalised output (or the
    partial acc, with m and l) written by the kernel into a view of a buffer
    whose 64 rows on each side hold ``SENTINEL``; asserts they still do. On
    the CPU the wrapper's plain version, for rehearsal."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    if q.device.type == "cpu":
        return (fd_ops.decode_attention(q, k, v, kv_len) if normalized
                else fd_ops.decode_attention_partial(q, k, v, kv_len))
    dtype = q.dtype if normalized else torch.float32
    pad, n = 64 * q.shape[-1], q.numel()
    buf = torch.full((n + 2 * pad,), SENTINEL, dtype=dtype, device=q.device)
    out = buf[pad:pad + n].view(q.shape)
    got = fd_ops._launch(q, k, v, kv_len, q.shape[-1] ** -0.5, normalized,
                         out=out)
    assert bool((buf[:pad] == SENTINEL).all()
                and (buf[pad + n:] == SENTINEL).all()), (
        "flash_decode stored outside its output", tuple(q.shape),
        tuple(k.shape), normalized)
    return got


def decode_matches(got, want, normalized: bool, dtype) -> float:
    """Asserts ``flash_decode``'s tolerances and returns the largest error:
    partials within 2e-5 + 1e-5 x max|plain| (m exactly -inf, l = 0 and
    acc = 0 where no key is live), the normalised output within
    ``FLASH_TOL`` (0 where no key is live)."""
    if normalized:
        got, want = got.float(), want.float()
        err = max_abs_err(got, want)
        assert tol_excess(got, want, *FLASH_TOL[dtype]) <= 0, err
        return err
    empty = torch.isneginf(want[1])
    assert torch.isneginf(got[1][empty]).all() and not got[2][empty].any() \
        and not got[0][empty].any(), "flash_decode: the empty partial"
    worst = 0.0
    for g, w in zip(got, want):
        err = max_abs_err(g, w)
        scale = float(torch.where(torch.isinf(w), 0.0, w).abs().max())
        assert err <= 2e-5 + 1e-5 * scale, err
        worst = max(worst, err)
    return worst


def decode_edge_parity(dev, normal) -> dict:
    """``flash_decode``'s edge cases of the clustered kernel, both entries
    and both types, each written between sentinels: every cluster size the
    wrapper can choose on this card (B * KH from the SM count down); a
    ragged batch whose short rows leave most ranks of a cluster without a
    live key; G = 1, 3, 4, 6, 8 and 32 at every head dim (each compiled
    bound of heads a warp, one or two warp groups, one to four warps a
    group); one call captured in a CUDA graph and replayed on new values;
    a misaligned view refused.
    Returns the largest error per type."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref

    worst = {}
    sms, most = 132, 16                 # (the CPU rehearsal's stand-ins)
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        most = fd_ops.plan(_build.library(), dev, 1, 1, 1, 1024, 128,
                           torch.bfloat16)  # (a 1-row call: the largest size)
    sizes = [n for n in fd_ops.CLUSTERS if n <= most]
    cases = []
    for n in sizes:               # B * KH blocks' worth of clusters of n
        slabs = max(1, sms // n)
        cases.append((slabs, 2, 1, 32 * n * 2, 128, n))
    cases += [(8, 12, 2, 1024, 128, None)]          # ragged, below
    for g in (1, 3, 4, 6, 8, 32):
        for d in (16, 32, 64, 80, 128):
            cases.append((3, g, 1, 200, d, None))
    for dtype in (torch.float32, torch.bfloat16):
        name = f"flash_decode_{str(dtype).split('.')[-1]}"
        for b, h, kh, s, d, n in cases:
            q = normal((b, h, d), dtype)
            k, v = normal((b, kh, s, d), dtype), normal((b, kh, s, d), dtype)
            lens = [s, 0, 33, 1, s - 1, 700 % s, 64, 31]
            kv_len = torch.tensor([lens[i % len(lens)] for i in range(b)],
                                  dtype=torch.int32, device=dev)
            for normalized in (True, False):
                got = decode_into_sentinel(q, k, v, kv_len, normalized)
                want = (fd_ref.decode_attention(q, k, v, kv_len) if normalized
                        else fd_ref.decode_attention_partial(q, k, v, kv_len))
                worst[name] = max(worst.get(name, 0.0), decode_matches(
                    got, want, normalized, dtype))
            if n is not None and dev.type == "cuda":
                got_n = fd_ops.plan(_build.library(), dev, b, h, kh, s, d,
                                    dtype)
                assert got_n == n, (b, kh, s, n, got_n)
        if dev.type != "cuda":
            continue
        # a CUDA graph of one call, replayed on new q, cache and kv_len
        b, h, kh, s, d = 4, 12, 2, 544, 128
        q = normal((b, h, d), dtype)
        k, v = normal((b, kh, s, d), dtype), normal((b, kh, s, d), dtype)
        kv_len = torch.tensor([s, 0, 100, 1], dtype=torch.int32, device=dev)
        fd_ops.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fd_ops.decode_attention(q, k, v, kv_len)
            part = fd_ops.decode_attention_partial(q, k, v, kv_len)
        for t in (q, k, v):
            t.copy_(normal(tuple(t.shape), dtype))
        kv_len.copy_(torch.tensor([7, s - 3, 0, 260], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        decode_matches(out, fd_ref.decode_attention(q, k, v, kv_len), True,
                       dtype)
        decode_matches(part, fd_ref.decode_attention_partial(q, k, v, kv_len),
                       False, dtype)
        # a view two bytes off the 16-byte boundary is refused
        flat = torch.zeros(k.numel() + 8, dtype=dtype, device=dev)
        shifted = flat[1:1 + k.numel()].view(k.shape)
        try:
            fd_ops.decode_attention(q, shifted, v, kv_len)
        except ValueError as e:
            assert "16-byte" in str(e), e
        else:
            raise AssertionError("flash_decode took a misaligned k")
    sync(dev)
    return worst


def device_kernels(fn, dev) -> list:
    """The names of the device kernels that ``fn()`` enqueues, as
    ``torch.profiler`` sees them, bracketed by two marker kernels: a window
    in which the profiler shows neither marker (it can miss a process's
    first window) is profiled again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device=dev)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            marker.add_(1)
            fn()
            marker.add_(1)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        marks = [n for n in names if "flash_decode" not in n
                 and "elementwise" in n]
        if len(marks) == 2:
            return [n for n in names if n not in marks]
    raise AssertionError(f"torch.profiler recorded no marker: {names}")


def one_kernel_per_decode_call(dev) -> dict:
    """Each ``flash_decode`` entry on the card enqueues exactly one kernel
    (no merge, no normalisation pass, no memset), as ``torch.profiler``
    sees one call at the serve shape. Returns the kernels' names."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    rng = np.random.default_rng(SEED + 13)
    b, h, kh, s, d = 8, 12, 2, 544, 128

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev).to(torch.bfloat16)

    q, k, v = normal(b, h, d), normal(b, kh, s, d), normal(b, kh, s, d)
    kv_len = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    seen = {}
    for fn in (fd_ops.decode_attention, fd_ops.decode_attention_partial):
        fn(q, k, v, kv_len)
        torch.cuda.synchronize()
        names = device_kernels(lambda: fn(q, k, v, kv_len), dev)
        assert len(names) == 1 and "flash_decode" in names[0], names
        seen[fn.__name__] = names
    return seen


def kernel_key(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, as
    ``flash_decode_kernel<bf16,128,2,8>``: the name is the identifier whose
    length prefix ends where ``_kernel`` does."""
    end = mangled.find("_kernel") + len("_kernel")
    name = mangled
    for start in range(end - len("_kernel"), 0, -1):
        if any(mangled[start - n:start].isdigit()
               and int(mangled[start - n:start]) == end - start
               for n in (1, 2, 3)):
            name = mangled[start:end]
            break
    rest = mangled[end:]
    if not rest.startswith("I"):
        return name
    args = rest[:rest.find("Ev") + 1]
    kind = ("bf16" if "bfloat16" in args else "f32" if args.startswith("If")
            else None)
    values = re.findall(r"L[ib](\d+)E", args)
    return f"{name}<{','.join(([kind] if kind else []) + values)}>"


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each kernel, from nvcc's ``-Xptxas -v``
    lines."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = kernel_key(m[1])
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m[1])
    return out


def flash_edge_parity(dev) -> dict:
    """Both attention kernels against their plain versions on their edge
    cases, within ``FLASH_TOL``: ``flash_attention`` with S = 1, the
    scorer's S = 10, S off every tile (33, 97, 300), a tile-aligned S, each
    head dim (16 to 128), G = 1 and 6, causal and full, float32 and bf16,
    and the bf16 kernel's packed (G * S, D) slabs ending inside a 64-row
    tile (G * S = 66, 60, 40), spanning several (S = 64 full, S = 512),
    G = 1, head dim 80 (the D = 128 plan over 80-wide maps: a column stored
    past 80 would overwrite the next row or a sentinel), and k/v with their
    own length Sk (4 queries over 1,024 keys, ragged either way, Sk <= 16),
    each written between sentinels (``attention_into_sentinel``);
    ``flash_decode`` with kv_len 0, 1, ragged and the full cache, G = 1 and
    6, a cache longer than one split, head dim 80, both types (partials:
    m exactly -inf where no key is live, l = 0 and acc = 0 there;
    elsewhere within 2e-5 + 1e-5 relative), and the clustered kernel's own cases
    (``decode_edge_parity``). Returns the largest error per kernel and
    type."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref

    rng = np.random.default_rng(SEED + 11)

    def normal(shape, dtype):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev).to(dtype)

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        (atol, rtol), name = FLASH_TOL[dtype], str(dtype).split(".")[-1]
        for b, h, kh, s, d, causal, *rest in (
                (1, 1, 1, 1, 16, True), (1, 6, 1, 1, 128, False),
                (3, 12, 2, 10, 128, True), (2, 12, 2, 10, 128, False),
                (2, 6, 6, 33, 32, True), (1, 6, 1, 97, 64, True),
                (1, 12, 2, 300, 128, True), (2, 4, 2, 256, 64, False),
                (1, 2, 1, 128, 16, False), (2, 12, 2, 11, 128, True),
                (1, 6, 1, 64, 128, False), (3, 12, 2, 10, 16, True),
                (1, 12, 2, 512, 128, True), (2, 8, 8, 40, 64, True),
                (2, 32, 32, 512, 80, True), (1, 4, 2, 300, 80, True),
                (2, 4, 2, 97, 80, False), (1, 2, 1, 10, 80, True),
                (2, 16, 16, 4, 64, False, 1024), (1, 6, 2, 7, 32, False, 300),
                (2, 4, 2, 130, 16, False, 3), (2, 8, 8, 5, 80, False, 77),
                (3, 2, 1, 65, 64, False, 16)):
            sk = rest[0] if rest else s
            q = normal((b, h, s, d), dtype)
            k, v = normal((b, kh, sk, d), dtype), normal((b, kh, sk, d), dtype)
            got = attention_into_sentinel(q, k, v, causal).float()
            want = fa_ref.flash_attention(q, k, v, causal=causal).float()
            err = max_abs_err(got, want)
            assert tol_excess(got, want, atol, rtol) <= 0, (
                "flash_attention", b, h, kh, s, sk, d, causal, dtype, err)
            worst[f"flash_attention_{name}"] = max(
                worst.get(f"flash_attention_{name}", 0.0), err)
        for b, h, kh, s, d in ((4, 1, 1, 64, 16), (4, 12, 2, 544, 128),
                               (4, 6, 6, 100, 32), (4, 6, 1, 5000, 64),
                               (4, 32, 32, 528, 80), (4, 16, 16, 1024, 64)):
            q = normal((b, h, d), dtype)
            k, v = normal((b, kh, s, d), dtype), normal((b, kh, s, d), dtype)
            kv_len = torch.tensor([0, 1, s, int(rng.integers(2, s))],
                                  dtype=torch.int32, device=dev)
            got = fd_ops.decode_attention_partial(q, k, v, kv_len)
            want = fd_ref.decode_attention_partial(q, k, v, kv_len)
            assert torch.isneginf(got[1][0]).all() and not got[2][0].any() \
                and not got[0][0].any(), "flash_decode kv_len = 0"
            for g, w in zip(got, want):
                err = max_abs_err(g, w)
                scale = float(torch.where(torch.isinf(w), 0.0, w).abs().max())
                assert err <= 2e-5 + 1e-5 * scale, ("flash_decode", b, h, kh,
                                                     s, d, dtype, err)
            out = fd_ops.decode_attention(q, k, v, kv_len).float()
            want = fd_ref.decode_attention(q, k, v, kv_len).float()
            err = max_abs_err(out, want)
            assert tol_excess(out, want, atol, rtol) <= 0 \
                and not out[0].any(), ("flash_decode", dtype, err)
            worst[f"flash_decode_{name}"] = max(
                worst.get(f"flash_decode_{name}", 0.0), err)
    for key, err in decode_edge_parity(dev, normal).items():
        worst[key] = max(worst.get(key, 0.0), err)
    sync(dev)
    return worst


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# Each case builds seeded inputs at the shape a path gave the entry and
# returns its wrapper and plain version as calls on them, and the bytes and
# operations of its bound.


def conds_for(c: int):
    from repro_torch.core.predicates import compile_conditions
    return compile_conditions([list(sp.fixed_preds)
                               for sp in (channel_specs() * c)[:c]])


def case_predicate_filter(dev, rng, shape) -> dict:
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels.predicate_filter import ops as pf_ops
    from repro_torch.kernels.predicate_filter import ref as pf_ref
    n, f, c = shape
    conds = conds_for(c)
    x, _ = syn.tweet_arrays(rng, n, t0=1)
    x = torch.tensor(syn.drug_tweak(x, rng, 0.05), device=dev)
    assert x.shape == (n, f), x.shape
    lo, hi, neq = (torch.tensor(a, device=dev)
                   for a in pf_ops.canonical_arrays(conds, f))
    return dict(wrapper=lambda: pf_ops.predicate_filter(x, conds),
                plain=lambda: pf_ref.predicate_filter(x, lo, hi, neq),
                bound_bytes=n * f * 4 + 3 * c * f * 4 + n * c,
                bound_ops=4 * n * c * f)


def case_predicate_filter_rows(dev, rng, shape) -> dict:
    from repro_torch.kernels.predicate_filter import ops as pf_ops
    from repro_torch.kernels.predicate_filter import ref as pf_ref
    c, n, f = shape
    conds = conds_for(c)
    x = torch.tensor(rng.integers(0, 11, (c, n, f)).astype(np.int32),
                     device=dev)
    lo, hi, neq = (torch.tensor(a, device=dev)
                   for a in pf_ops.canonical_arrays(conds, f))
    return dict(wrapper=lambda: pf_ops.predicate_filter_rows(x, conds),
                plain=lambda: pf_ref.predicate_filter_rows(x, lo, hi, neq),
                bound_bytes=c * n * f * 4 + 3 * c * f * 4 + c * n,
                bound_ops=4 * c * n * f)


def case_spatial_match(dev, rng, shape) -> dict:
    from repro_torch.kernels.spatial_match import ops as sm_ops
    r, u = shape
    t, us = (torch.tensor(rng.uniform(-100, 100, (k, 2)).astype(np.float32),
                          device=dev) for k in (r, u))
    return dict(wrapper=lambda: sm_ops.spatial_match(t, us, 10.0),
                plain=lambda: sm_ops.spatial_match_plain(t, us, 10.0),
                bound_bytes=r * 8 + u * 8 + r * u,
                bound_ops=7 * r * u + 3 * (r + u))


def case_spatial_match_stacked(dev, rng, shape) -> dict:
    """The users past the main path's 10,000 are the engine's -FAR padding
    of the user bucket."""
    from repro_torch.kernels.spatial_match import ops as sm_ops
    c, r, u = shape
    t = torch.tensor(rng.uniform(-100, 100, (c, r, 2)).astype(np.float32),
                     device=dev)
    us = torch.full((c, u, 2), -sm_ops.FAR, dtype=torch.float32, device=dev)
    real = min(u, MAIN["users"])
    us[:, :real] = torch.tensor(
        rng.uniform(-100, 100, (c, real, 2)).astype(np.float32), device=dev)
    radius = torch.full((c,), 10.0, device=dev)
    return dict(wrapper=lambda: sm_ops.spatial_match(t, us, radius),
                plain=lambda: sm_ops.spatial_match_plain(t, us, radius),
                bound_bytes=c * (r * 8 + u * 8 + 4 + r * u),
                bound_ops=7 * c * r * u + 3 * c * (r + u))


def floor_call(blocks: int, threads: int, smem: int = 0, cluster: int = 1):
    """A call that launches the empty kernel of ``csrc/launch_floor.cu`` on
    the current stream with this grid, block, dynamic shared memory and
    cluster size: timed like the kernel, it is the floor under it."""
    from repro_torch.kernels import _build
    lib = _build.library()

    def launch():
        code = lib.launch_floor_launch(
            blocks, threads, smem, cluster,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        _build.check(code, "launch_floor")
    return launch


def case_join_compact(dev, rng, shape, aggregated: bool) -> dict:
    """Floor: the empty kernel on the grid of the path this launch takes."""
    from repro_torch.kernels.join_compact import ops as jc_ops
    from repro_torch.kernels.join_compact import ref as jc_ref
    s_len, max_t = shape
    dv = [torch.tensor(a, device=dev) for a in (
        rng.integers(-1, 16, (s_len, max_t), dtype=np.int32),
        rng.integers(0, max_t + 1, s_len, dtype=np.int32),
        rng.integers(0, 9, (s_len, max_t), dtype=np.int32),
        rng.integers(0, 4, (s_len, max_t), dtype=np.int32),
        rng.random(s_len) < 0.7,
        rng.integers(1000, 40000, s_len, dtype=np.int32))]
    # the outputs are new tensors, on the boundary like the inputs
    vector = jc_ops.vector_ok(dv, max_t)
    return dict(wrapper=lambda: jc_ops.join_pairs(*dv, 4, aggregated),
                plain=lambda: jc_ref.join_pairs(*dv, 4, aggregated),
                floor=floor_call(*jc_ops.grid(s_len, max_t, vector)),
                info=dict(path="vector" if vector else "scalar"),
                bound_bytes=join_compact_bytes(*dv),
                bound_ops=8 * s_len * max_t)


def case_flash_attention(dev, rng, shape, causal: bool = True,
                         sk: int = None) -> dict:
    """bf16 q at the launched (B, H, KH, S, D), k and v of ``sk`` keys (S
    unless given; non-causal only). Bound: the larger of the live products
    (4 D operations per (query, key) pair under the causal mask) over the
    bf16 tensor-core rate and q, k, v, out once over the memory rate.
    Library: SDPA with GQA (and the causal mask). Floor: the empty kernel
    on the launch's grid."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    b, h, kh, s_len, d = shape
    sk = sk or s_len

    def normal(*sh):
        return torch.tensor(rng.normal(size=sh).astype(np.float32),
                            device=dev).to(torch.bfloat16)

    q, k, v = normal(b, h, s_len, d), normal(b, kh, sk, d), \
        normal(b, kh, sk, d)
    pairs = s_len * (s_len + 1) // 2 if causal else s_len * sk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(wrapper=lambda: fa_ops.flash_attention(q, k, v, causal=causal),
                floor=flash_attention_floor(shape, sk, causal),
                plain=lambda: fa_ref.flash_attention(q, k, v, causal=causal),
                library=lambda: sdpa(q, k, v, is_causal=causal,
                                     enable_gqa=True),
                bound_bytes=2 * (2 * b * h * s_len * d + 2 * b * kh * sk * d),
                bound_ops=4 * b * h * d * pairs,
                ops_per_s=BF16_TENSOR_OPS_PER_S,
                tolerance=FLASH_TOL[torch.bfloat16])


def flash_attention_floor(shape, sk: int, causal: bool):
    """The empty kernel on the launch the bf16 ``flash_attention`` makes at
    (B, H, KH, S, D) with ``sk`` keys: its threads, shared memory and grid,
    as the launch decides them (``flash_attention_block``)."""
    from repro_torch.kernels import _build
    b, h, kh, s_len, d = shape
    lib = _build.library()
    threads, smem, grid = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib.flash_attention_block(
        b, h, kh, s_len, sk, d, int(causal), ctypes.byref(threads),
        ctypes.byref(smem), ctypes.byref(grid)), "flash_attention_block")
    return floor_call(grid.value, threads.value, smem.value)


def case_flash_decode(dev, rng, shape, live: int = None) -> dict:
    """bf16 q and cache at the launched (B, H, KH, S, D), every row live up
    to ``live`` keys (S - 1 unless given: the last decode step of the serve
    phase; S for the cross step over the encoder's frames). Wrapper and
    plain version are the normalised ``decode_attention`` that
    ``attn_decode`` calls. Bound: q, the K/V rows up to kv_len and the
    output once over the memory rate. Library: SDPA with GQA and the
    kv_len mask. Floor: the empty kernel on its grid, block, shared memory
    and cluster size."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    b, h, kh, s_len, d = shape
    live = s_len - 1 if live is None else live

    def normal(*sh):
        return torch.tensor(rng.normal(size=sh).astype(np.float32),
                            device=dev).to(torch.bfloat16)

    q, k, v = normal(b, h, d), normal(b, kh, s_len, d), normal(b, kh, s_len, d)
    kv_len = torch.full((b,), live, dtype=torch.int32, device=dev)
    mask = (torch.arange(s_len, device=dev) < live)[None, None, None, :] \
        .expand(b, 1, 1, s_len)
    q4 = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from repro_torch.kernels import _build
    lib = _build.library()
    n_split = fd_ops.plan(lib, dev, b, h, kh, s_len, d, torch.bfloat16)
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib.flash_decode_block(d, fd_ops.DTYPES[torch.bfloat16],
                                        h // kh, ctypes.byref(threads),
                                        ctypes.byref(smem)),
                 "flash_decode_block")
    return dict(wrapper=lambda: fd_ops.decode_attention(q, k, v, kv_len),
                floor=floor_call(b * kh * n_split, threads.value, smem.value,
                                 n_split),
                plain=lambda: fd_ref.decode_attention(q, k, v, kv_len),
                library=lambda: sdpa(q4, k, v, attn_mask=mask,
                                     enable_gqa=True),
                bound_bytes=2 * (2 * b * h * d + 2 * b * kh * live * d),
                bound_ops=4 * b * h * d * live,
                tolerance=FLASH_TOL[torch.bfloat16])


def case_flash_decode_partial(dev, rng, shape) -> dict:
    """The partial entry that ``sp_decode_attention`` launches once a
    slice: bf16 q and the first of the 4 sequence slices of ``SP_DECODE``'s
    cache, kv_len the slice's share of ``SP_KV_LEN``. Tolerance: the decode
    partials' 2e-5 + 1e-5 x max|plain|. Bound: q, the live K/V rows and the
    float32 partials once over the memory rate. No PyTorch call returns the
    partials."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    b, h, kh, s_len, d = shape

    def normal(*sh):
        return torch.tensor(rng.normal(size=sh).astype(np.float32),
                            device=dev).to(torch.bfloat16)

    q, k, v = normal(b, h, d), normal(b, kh, s_len, d), normal(b, kh, s_len, d)
    lens = np.clip(np.asarray(SP_KV_LEN), 0, s_len)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = fd_ref.decode_attention_partial(q, k, v, kv_len)
    scale = max(float(torch.where(torch.isinf(w), 0.0, w).abs().max())
                for w in want)
    live = int(lens.sum())
    return dict(
        wrapper=lambda: fd_ops.decode_attention_partial(q, k, v, kv_len),
        plain=lambda: fd_ref.decode_attention_partial(q, k, v, kv_len),
        bound_bytes=2 * b * h * d + 2 * 2 * kh * live * d
        + 4 * (b * h * d + 2 * b * h),
        bound_ops=4 * h * d * live, ops_per_s=BF16_TENSOR_OPS_PER_S,
        tolerance=(2e-5 + 1e-5 * scale, 0.0))


def join_compact_bytes(tgt, tgt_n, members, brokers, valid, payload) -> int:
    """The bytes ``join_compact`` must move on these inputs: its four
    outputs (13 B an entry), 9 B of ``valid``, ``tgt_n`` and ``payload`` a
    stream entry, and of the (S, maxT) inputs only what decides or fills a
    live pair, in 32-B sectors (8 entries of a row): ``tgt`` where
    ``valid[s]`` and ``t < tgt_n[s]``, ``members`` and ``brokers`` where the
    pair is live."""
    s_len, max_t = tgt.shape
    col = torch.arange(max_t, device=tgt.device)
    read = valid[:, None] & (col[None, :] < tgt_n[:, None])
    live = read & (tgt >= 0)

    def sectors(mask) -> int:
        pad = mask.new_zeros((s_len, -max_t % 8))
        return int(torch.cat([mask, pad], 1).view(s_len, -1, 8).any(-1).sum())

    return (13 * s_len * max_t + 9 * s_len + 32 * sectors(read)
            + 64 * sectors(live))


# the deliver kernel at the calls of the benchmark's cells
# (bad_bench/configs, bad_bench/cells): every deliver_all of the last of
# DELIVER_TICKS ticks, one a plan-group, with the plan-group's name
DELIVER_CELLS = (("paper-1m.fused", ("param", "spatial")),
                 ("trending-2lang.fused", ("param",)))
DELIVER_SEED = 1
DELIVER_TICKS = 4


def deliver_calls(dev, workload: str) -> list:
    """The arguments (by name) of every ``deliver_all`` of the cell's last
    tick, from its engine as the benchmark builds it."""
    import inspect
    from bad_bench import run as bench_run
    from bad_bench import system
    from bad_bench import traffic as T
    from repro_torch.core import broker
    from repro_torch.core import engine as E
    from repro_torch.core import records as R
    _, _, cell, cfg = bench_run.load(ROOT, workload)
    eng = system.build(cfg, cell, DELIVER_SEED, dev)
    pool = T.Pool(cfg, cell, DELIVER_SEED)
    sig, real, calls = inspect.signature(broker.deliver_plain), \
        E.deliver_all, []

    def keep(*a, **k):
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        calls.append(dict(bound.arguments))
        return real(*a, **k)

    E.deliver_all = keep
    try:
        for k in range(DELIVER_TICKS):
            calls.clear()
            f, loc = pool.get(k)
            eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
            eng.execute_all(None, deliver=True, timed=False)
            eng.drain_spilled()
    finally:
        E.deliver_all = real
    sync(dev)
    del eng
    return list(calls)


def same_delivery(got, want) -> bool:
    """Two ``FusedDelivery`` values equal bit for bit: each channel's first
    ``delivered`` wire lines and every other field (the kernel leaves the
    lines past that count as the buffer held them)."""
    pay, ref = got.pack.payload, want.pack.payload
    if pay.dtype != ref.dtype or pay.shape != ref.shape:
        return False
    if not all(bool(torch.equal(pay[c, :d], ref[c, :d]))
               for c, d in enumerate(want.pack.delivered.tolist())):
        return False
    return same_fields(got._replace(pack=got.pack._replace(payload=None)),
                       want._replace(pack=want.pack._replace(payload=None)))


def same_fields(got, want) -> bool:
    """Every field of two values (tuples field by field) equal, bit for
    bit."""
    if got is None or want is None:
        return got is None and want is None
    if isinstance(got, tuple):
        return all(same_fields(g, w) for g, w in zip(got, want))
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(torch.equal(got, want)))


def deliver_bytes(a: dict, want) -> int:
    """The bytes one ``deliver`` call must move: every output written once
    (the live wire lines, notify in full, the spill streams, the successor
    ring and, ring-less, the spill mask) and each input read once where it
    is needed (the validity flags; row, target, member count and broker of
    a valid pair; the ring; the sID row of each live line)."""
    result, ring = a["result"], a["ring"]
    C = result.pair_valid.shape[0]
    P = result.pair_valid[0].numel()
    width = want.pack.payload.shape[2]
    S = a["group_sids"].shape[-1]
    W = 0 if ring is None else ring.window
    nvalid = int(result.pair_valid.sum())
    lines = int(want.pack.delivered.sum())
    out = (4 * lines * width + 4 * C * a["max_notify"]
           + C * a["spill_cap"] * (13 + 9) + 16 * C * W
           + (C * P if ring is None else 0))
    inp = (C * P + 8 * nvalid + (4 * nvalid if S else 0)
           + (4 * lines if a["target_brokers"] is not None else 0)
           + 20 * C * W + 4 * S * lines)
    return out + inp


def deliver_floor(a: dict, want):
    """The empty kernel on each of the four launches' grids."""
    from repro_torch.kernels.deliver import ops as dl_ops
    payload = want.pack.payload
    C = payload.shape[0]
    tiles = -(-a["result"].pair_valid[0].numel() // dl_ops.TILE)
    fan, line, threads, _, _ = dl_ops.grid(
        C, payload.shape[1], payload.shape[2], want.fan.notify.shape[1],
        dl_ops.vector_ok([payload], payload.shape[2]),
        dl_ops.sm_count(payload.device))
    tile_blocks = min(C * tiles, dl_ops.MAX_BLOCKS)
    calls = [floor_call(tile_blocks, threads),
             floor_call(C, dl_ops.SCAN_THREADS),
             floor_call(tile_blocks, threads),
             floor_call(fan + line, threads)]

    def launch():
        for c in calls:
            c()
    return launch


def deliver_full_call(dev) -> dict:
    """A ``deliver_all`` call at the param plan-group's shape with every
    wire line live (``torch_delivery_cases.PARAM_GROUP_FULL``): the walk
    writes the whole buffer."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_delivery_cases import PARAM_GROUP_FULL, case
    return case(np.random.default_rng(DELIVER_SEED), device=dev,
                **PARAM_GROUP_FULL)


def measure_deliver(a: dict) -> dict:
    """One ``deliver_all`` call: the kernel against the plain version
    (``same_delivery``: the delivered wire lines and every other field of
    ``FusedDelivery``, bit for bit), then timed as
    ``measure`` times an entry (``ms`` a CUDA graph of calls, the four
    launches alone; ``wrapper_ms`` and ``plain_ms`` by CUDA events;
    ``floor_ms`` the empty kernel on the four grids) beside ``bound_ms``,
    ``deliver_bytes`` over the memory rate."""
    from repro_torch.core import broker
    from repro_torch.kernels.deliver import ops as dl_ops
    before = dl_ops.LAUNCHES
    got = broker.deliver_all(**a)
    want = broker.deliver_plain(**a)
    sync(got.pack.payload.device)
    assert dl_ops.LAUNCHES == before + 1
    payload = want.pack.payload
    C, max_pairs, width = payload.shape
    k = dict(shape=f"C={C} max_pairs={max_pairs} width={width} "
                   f"P={a['result'].pair_valid[0].numel()}",
             equal=same_delivery(got, want),
             path="vector" if dl_ops.vector_ok([got.pack.payload], width)
             else "scalar",
             ring=a["ring"] is not None,
             identity=a["group_sids"].shape[-1] == 0,
             live_lines=int(want.pack.delivered.sum()),
             live_sids=int(want.fan.delivered.sum()),
             bound_bytes=deliver_bytes(a, want), bound_by="bytes")
    floor = deliver_floor(a, want)
    del got, want, payload
    torch.cuda.empty_cache()
    k["bound_ms"] = 1e3 * k["bound_bytes"] / HBM_BYTES_PER_S
    iters = int(min(20, max(3, 10 / k["bound_ms"])))
    k.update(ms=graph_ms(lambda: broker.deliver_all(**a), iters),
             wrapper_ms=cuda_ms(lambda: broker.deliver_all(**a), iters),
             plain_ms=cuda_ms(lambda: broker.deliver_plain(**a),
                              max(3, iters // 4)),
             floor_ms=graph_ms(floor, iters))
    torch.cuda.empty_cache()
    return k


def print_deliver(k: dict, where: str) -> None:
    print(f"[kernel] deliver {k['shape']} ({where}; {k['live_lines']} live "
          f"lines, {k['live_sids']} sIDs): {k['ms']:.4f} ms (graph of "
          f"wrapper calls), wrapper {k['wrapper_ms']:.4f} ms, plain "
          f"{k['plain_ms']:.4f} ms, floor {k['floor_ms']:.4f} ms (empty "
          f"kernel, the four grids), bound {k['bound_ms']:.4f} ms (bytes, "
          f"{k['bound_bytes']} B), {k['path']} path, "
          f"{'equal to' if k['equal'] else 'DIFFERENT from'} the plain "
          f"version bit for bit")


def measure(case: dict, shape: str) -> dict:
    """One kernel entry at one shape: held against its plain version
    (``max_abs_err``; within the case's (atol, rtol) ``tolerance``, exact
    unless given);
    ``ms`` from a CUDA graph of wrapper calls (only what the wrapper
    enqueues, so no host work sits between the launches), ``wrapper_ms``,
    ``plain_ms`` and, where one PyTorch call computes the same function,
    ``library_ms`` from calls between CUDA events; beside its bound; and
    where the case gives one, ``floor_ms``: the empty kernel on the same
    grid, from a CUDA graph like ``ms``."""
    got, want = case["wrapper"](), case["plain"]()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    atol, rtol = case.get("tolerance", (0.0, 0.0))
    excess = max(tol_excess(g, w, atol, rtol) for g, w in zip(got, want))
    del got, want
    k = with_bound(dict(shape=shape, max_abs_err=err, tolerance=atol,
                        tolerance_rel=rtol, within_tolerance=excess <= 0,
                        bound_bytes=case["bound_bytes"],
                        bound_ops=case["bound_ops"]),
                   case.get("ops_per_s", CUDA_CORE_OPS_PER_S))
    # about 10 ms of kernel at the bound per timing, 5 to 100 calls
    iters = int(min(100, max(5, 10 / k["bound_ms"])))
    k.update(ms=graph_ms(case["wrapper"], iters),
             wrapper_ms=cuda_ms(case["wrapper"], iters),
             plain_ms=cuda_ms(case["plain"], max(3, iters // 10)),
             library_ms=(cuda_ms(case["library"], iters)
                         if "library" in case else None),
             floor_ms=(graph_ms(case["floor"], iters)
                       if "floor" in case else None),
             **case.get("info", {}))
    torch.cuda.empty_cache()
    return k


def with_bound(k: dict, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> dict:
    """Add ``bound_ms`` (the larger of bytes over the memory rate and
    operations over ``ops_per_s``: the CUDA cores' float32 rate unless the
    work is bf16 products for the tensor cores) and ``bound_by``."""
    by_bytes = k["bound_bytes"] / HBM_BYTES_PER_S
    by_ops = k["bound_ops"] / ops_per_s
    k["bound_ms"] = 1e3 * max(by_bytes, by_ops)
    k["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    return k


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------


def check_conservation(rep) -> None:
    """Per stage: delivered + spilled + dropped == produced, where produced
    counts this tick's fresh pairs plus the retry-ring entries re-presented
    (none on the per-channel path)."""
    s = rep.overflow
    assert s.delivered_pairs + s.spilled_pairs + s.dropped_pairs \
        == rep.num_results + s.retried_pairs, (rep.channel, s)
    assert s.delivered_sids + s.spilled_sids + s.dropped_sids \
        == rep.num_notified + s.retried_sids, (rep.channel, s)
    assert sum(s.delivered_pairs_broker) == s.delivered_pairs, (rep.channel, s)


def spatial_hits_numpy(t: np.ndarray, u: np.ndarray, radius: float) -> int:
    """Hit count with the expansion form, elementwise in float32 (numpy
    rounds every operation on its own, like the kernel)."""
    t0, t1 = t[:, 0:1], t[:, 1:2]
    u0, u1 = u[None, :, 0], u[None, :, 1]
    dist2 = (t0 * t0 + t1 * t1 + (u0 * u0 + u1 * u1)) \
        - np.float32(2.0) * (t0 * u0 + t1 * u1)
    return int((dist2 < np.float32(radius) ** 2).sum())


def build_main_engine(dev, cfg: dict, rng, incremental: bool = True):
    """The main path's engine: three channels, the population-skewed
    subscriptions of the two param channels on 4 brokers, and the users.
    Returns (engine, specs, per-state subscription counts, users)."""
    from repro_torch.core.engine import BADEngine
    from repro_torch.data import synthetic as syn

    eng = BADEngine(dataset_capacity=cfg["dataset_capacity"],
                    index_capacity=cfg["index_capacity"],
                    max_window=cfg["max_window"],
                    max_candidates=cfg["max_candidates"],
                    brokers=tuple(f"Broker{i}" for i in range(4)),
                    max_deliver_pairs=cfg["max_deliver_pairs"],
                    max_notify=cfg["max_notify"], use_pallas=True,
                    incremental=incremental, device=dev)
    specs = channel_specs()
    for spec in specs:
        eng.create_channel(spec)
    sub_counts = {}
    for spec, n in ((specs[0], cfg["drug_subs"]),
                    (specs[1], cfg["threat_subs"])):
        params, brokers = syn.subscriptions_by_population(rng, n, 4)
        eng.subscribe_bulk(spec.name, params, brokers)
        sub_counts[spec.name] = np.bincount(params, minlength=50)
    users = rng.uniform(-100, 100, (cfg["users"], 2)).astype(np.float32)
    eng.set_user_locations(users, rng.integers(0, 4, cfg["users"]))
    return eng, specs, sub_counts, users


def check_numpy(rep, spec, f, loc, one, sub_counts, users, spatial: bool):
    """Notified count of a param channel against numpy; with ``spatial``,
    the spatial channel's hits against the numpy expansion form."""
    match = _host_match(f, one[spec.name])
    if spec.join == "param":
        want = int(sub_counts[spec.name][f[match, spec.param_field]].sum())
        assert rep.num_notified == want, (spec.name, rep.num_notified, want)
    elif spatial:
        want = spatial_hits_numpy(loc[match], users, spec.spatial_radius)
        assert rep.num_results == want, (rep.num_results, want)


# each kernel entry: its module, and the names of its launch count and of
# the largest shape it launched
ENTRIES = {
    "predicate_filter": ("predicate_filter", "LAUNCHES", "SHAPE"),
    "predicate_filter_rows": ("predicate_filter", "ROWS_LAUNCHES",
                              "ROWS_SHAPE"),
    "spatial_match": ("spatial_match", "LAUNCHES", "SHAPE"),
    "spatial_match_stacked": ("spatial_match", "STACKED_LAUNCHES",
                              "STACKED_SHAPE"),
    "join_compact": ("join_compact", "LAUNCHES", "SHAPE"),
    "flash_attention": ("flash_attention", "LAUNCHES", "SHAPE"),
    "flash_decode": ("flash_decode", "LAUNCHES", "SHAPE"),
    "deliver": ("deliver", "LAUNCHES", "SHAPE"),
}


# the launches of one path of an entry, counted beside the entry's total:
# (module, name of the count)
PATHS = {"join_compact_vector": ("join_compact", "VECTOR_LAUNCHES"),
         "deliver_vector": ("deliver", "VECTOR_LAUNCHES")}

# a fused tick of the main engine's two plan-groups delivers twice: the
# param group's 10,252-word lines on the 16-byte path, the spatial group's
# 13-word lines off it
FUSED_DELIVER = dict(deliver=2, deliver_vector=1)


def _ops(module: str):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{module}.ops")


def launch_counts() -> dict:
    counts = {k: getattr(_ops(m), n) for k, (m, n, _) in ENTRIES.items()}
    counts.update({k: getattr(_ops(m), n) for k, (m, n) in PATHS.items()})
    return counts


def launch_shapes() -> dict:
    return {k: getattr(_ops(m), sh) for k, (m, _, sh) in ENTRIES.items()}


def reset_launch_counts() -> None:
    """Every launch count (each path's too) to 0 and every largest shape to
    None."""
    for module, count, shape in ENTRIES.values():
        setattr(_ops(module), count, 0)
        setattr(_ops(module), shape, None)
    for module, count in PATHS.values():
        setattr(_ops(module), count, 0)


def since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def main_path(dev, cfg: dict) -> dict:
    """Phase 2: every channel through ``execute_channel`` each tick."""
    from repro_torch.core import records as R
    from repro_torch.core.plans import ExecutionFlags
    from repro_torch.core.predicates import compile_conditions
    from repro_torch.data import synthetic as syn

    rng = np.random.default_rng(SEED + 1)
    t_setup = time.perf_counter()
    eng, specs, sub_counts, users = build_main_engine(dev, cfg, rng)
    setup_s = time.perf_counter() - t_setup
    drugs, threat, crime = specs
    one = {s.name: compile_conditions([list(s.fixed_preds)]) for s in specs}
    flags = ExecutionFlags.fully_optimized()
    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tick_s, ingest_s, reports = [], [], 0
    exec_s = {s.name: [] for s in specs}
    totals = dict(results=0, notified=0, delivered_pairs=0, delivered_sids=0)
    for tick in range(cfg["ticks"]):
        f, loc = syn.tweet_arrays(rng, cfg["tick_rows"], t0=1 + tick * 100)
        f = syn.drug_tweak(f, rng, 0.05)
        # the tick: upload + ingest, then every channel with delivery
        ts = time.perf_counter()
        eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ingest_s.append(time.perf_counter() - ts)
        reps = []
        for spec in specs:
            te = time.perf_counter()
            reps.append(eng.execute_channel(spec.name, flags, deliver=True))
            exec_s[spec.name].append(time.perf_counter() - te)
        tick_s.append(time.perf_counter() - ts)
        # checks, outside the timed tick
        for spec, rep in zip(specs, reps):
            check_conservation(rep)
            reports += 1
            for k in ("results", "notified"):
                totals[k] += getattr(rep, f"num_{k}")
            totals["delivered_pairs"] += rep.overflow.delivered_pairs
            totals["delivered_sids"] += rep.overflow.delivered_sids
            check_numpy(rep, spec, f, loc, one, sub_counts, users,
                        tick in cfg["spatial_check_ticks"])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if dev.type == "cuda":
        want = dict.fromkeys(launches, 0)
        # a delivery a channel a tick, the param channels' on the 16-byte
        # path
        want.update(predicate_filter=cfg["ticks"], spatial_match=cfg["ticks"],
                    deliver=3 * cfg["ticks"], deliver_vector=2 * cfg["ticks"])
        assert launches == want, launches
    return dict(setup_s=setup_s, wall_s=wall, ticks=cfg["ticks"],
                tick_ms_mean=1e3 * float(np.mean(tick_s)),
                tick_ms_p50=1e3 * float(np.median(tick_s)),
                tick_ms_max=1e3 * float(np.max(tick_s)),
                ingest_ms_mean=1e3 * float(np.mean(ingest_s)),
                exec_ms_mean={k: 1e3 * float(np.mean(v))
                              for k, v in exec_s.items()},
                reports=reports, launches=launches, shapes=launch_shapes(),
                totals=totals, rows_ingested=eng.size_host,
                wrapped=eng.size_host > cfg["dataset_capacity"])


def fused_plans():
    """The fused main path's assignment: the two param channels on the
    compacted join with the join_compact kernel, TweetsAboutCrime3 on the
    padded kernels; two plan-groups per tick."""
    from repro_torch.core.plans import ChannelPlan
    drugs, threat, crime = channel_specs()
    compact = ChannelPlan("bad_index", True, True, "compact_pallas")
    return {drugs.name: compact, threat.name: compact,
            crime.name: ChannelPlan("bad_index", True, True, "pallas")}


def fused_path(dev, cfg: dict) -> dict:
    """Phase 3: ``execute_all(None, deliver=True)`` then ``drain_spilled``
    each tick, on the main path's engine and data."""
    from repro_torch.core import records as R
    from repro_torch.core.predicates import compile_conditions
    from repro_torch.data import synthetic as syn

    rng = np.random.default_rng(SEED + 1)
    t_setup = time.perf_counter()
    eng, specs, sub_counts, users = build_main_engine(dev, cfg, rng)
    for name, plan in fused_plans().items():
        eng.set_plan(name, plan)
    setup_s = time.perf_counter() - t_setup
    one = {s.name: compile_conditions([list(s.fixed_preds)]) for s in specs}
    groups = {}
    for name, plan in fused_plans().items():
        groups.setdefault(plan.backend, []).append(name)
    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tick_s, ingest_s, drain_s = [], [], []
    group_ms = {b: [] for b in groups}
    totals = dict(results=0, notified=0, delivered_pairs=0, delivered_sids=0,
                  retried_sids=0, redelivered_sids=0)
    first = None
    for tick in range(cfg["ticks"]):
        f, loc = syn.tweet_arrays(rng, cfg["tick_rows"], t0=1 + tick * 100)
        f = syn.drug_tweak(f, rng, 0.05)
        before = launch_counts()
        ts = time.perf_counter()
        eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ingest_s.append(time.perf_counter() - ts)
        reps = eng.execute_all(None, deliver=True)
        td = time.perf_counter()
        drained = eng.drain_spilled()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        drain_s.append(time.perf_counter() - td)
        tick_s.append(time.perf_counter() - ts)
        got = since(before)
        if dev.type == "cuda":
            want = dict.fromkeys(got, 0)
            want.update(predicate_filter=1, spatial_match_stacked=1,
                        join_compact=1, join_compact_vector=1,
                        **FUSED_DELIVER)
            assert got == want, (tick, got)
        for b, names in groups.items():
            group_ms[b].append(1e3 * sum(reps[n].wall_time_s for n in names))
        for spec in specs:
            rep = reps[spec.name]
            check_conservation(rep)
            totals["results"] += rep.num_results
            totals["notified"] += rep.num_notified
            totals["delivered_pairs"] += rep.overflow.delivered_pairs
            totals["delivered_sids"] += rep.overflow.delivered_sids
            totals["retried_sids"] += rep.overflow.retried_sids
            check_numpy(rep, spec, f, loc, one, sub_counts, users,
                        tick in cfg["spatial_check_ticks"])
        totals["redelivered_sids"] += sum(d.stats.delivered_sids
                                          for d in drained.values())
        if tick == 0:
            first = (f, loc, {n: (r.num_results, r.num_notified, r.scanned,
                                  r.broker_bytes.tolist(),
                                  r.overflow.delivered_pairs,
                                  r.overflow.delivered_sids,
                                  r.overflow.produced_pairs,
                                  r.overflow.produced_sids)
                              for n, r in reps.items()})
        del reps, drained
    wall = time.perf_counter() - t0
    launches, shapes = launch_counts(), launch_shapes()
    ring = (eng.ring_pending_pairs(), eng.ring_pending_sids())
    queue = (eng.spill.pending_pairs(), eng.spill.pending_sids())
    rows = eng.size_host
    del eng
    return dict(setup_s=setup_s, wall_s=wall, ticks=cfg["ticks"],
                tick_ms_mean=1e3 * float(np.mean(tick_s)),
                tick_ms_p50=1e3 * float(np.median(tick_s)),
                tick_ms_max=1e3 * float(np.max(tick_s)),
                ingest_ms_mean=1e3 * float(np.mean(ingest_s)),
                drain_ms_mean=1e3 * float(np.mean(drain_s)),
                exec_ms_mean={b: float(np.mean(v))
                              for b, v in group_ms.items()},
                groups=groups, launches=launches, shapes=shapes,
                totals=totals, ring_pending=ring, queue_pending=queue, first=first,
                rows_ingested=rows,
                wrapped=rows > cfg["dataset_capacity"])


def same_as_per_channel(dev, cfg: dict, first) -> int:
    """The fused reports of the first tick equal ``execute_channel`` on a
    second engine built by the same calls: counts, bytes, and the delivered
    and produced pairs and sIDs (the ring was empty on that tick)."""
    from repro_torch.core import records as R

    f, loc, fused = first
    rng = np.random.default_rng(SEED + 1)
    eng, specs, _, _ = build_main_engine(dev, cfg, rng)
    eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
    for name, plan in fused_plans().items():
        r = eng.execute_channel(name, plan.flags, deliver=True,
                                backend=plan.backend)
        got = (r.num_results, r.num_notified, r.scanned,
               r.broker_bytes.tolist(), r.overflow.delivered_pairs,
               r.overflow.delivered_sids, r.overflow.produced_pairs,
               r.overflow.produced_sids)
        assert got == fused[name], (name, got, fused[name])
    del eng
    return len(fused)


def _host_match(f: np.ndarray, conds) -> np.ndarray:
    """The channel's fixed conjunction on the host batch (numpy)."""
    ok = np.ones(f.shape[0], bool)
    for c in range(int(conds.npreds[0])):
        x = f[:, conds.field_idx[0, c]]
        v, op = conds.value[0, c], conds.op[0, c]
        ok &= [x == v, x != v, x < v, x <= v, x > v, x >= v][op]
    return ok


# ---------------------------------------------------------------------------
# phase 4: the compact join at a real grid
# ---------------------------------------------------------------------------


def compact_phase(dev, cfg: dict) -> dict:
    """Six TweetsAboutDrugs copies on a window scan, flat layout, skewed
    subscriptions and 2% match (the workload of
    ``benchmarks/compact_join.py``), on ``compact_pallas`` and on ``pallas``
    with the same data: per channel and tick, results, notified, scanned and
    broker bytes must agree. Each engine runs its ticks alone on the card."""
    from repro_torch.core import records as R
    from repro_torch.core.channel import tweets_about_drugs
    from repro_torch.core.engine import BADEngine
    from repro_torch.core.plans import ChannelPlan
    from repro_torch.data import synthetic as syn

    out = {}
    cuda = dev.type == "cuda"
    for backend in ("compact_pallas", "pallas"):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        rng = np.random.default_rng(SEED + 3)
        eng = BADEngine(dataset_capacity=cfg["dataset_capacity"],
                        index_capacity=cfg["index_capacity"],
                        max_window=cfg["tick_rows"],
                        max_candidates=cfg["max_candidates"],
                        brokers=tuple(f"B{i}" for i in range(4)),
                        use_pallas=True, device=dev)
        plan = ChannelPlan("window", False, True, backend)
        for i in range(cfg["channels"]):
            name = f"SparseDrugs{i}"
            eng.create_channel(dataclasses.replace(tweets_about_drugs(),
                                                   name=name))
            params, brokers = syn.subscriptions_by_population(
                rng, cfg["subs"], 4)
            eng.subscribe_bulk(name, params, brokers)
            eng.set_plan(name, plan)
        walls, counts = [], []
        reset_launch_counts()
        for tick in range(cfg["ticks"]):
            f, loc = syn.tweet_arrays(rng, cfg["tick_rows"],
                                      t0=1 + tick * 100)
            f = syn.drug_tweak(f, rng, cfg["match"])
            eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
            eng._sync()
            t0 = time.perf_counter()
            reps = eng.execute_all(None)
            eng._sync()
            walls.append(time.perf_counter() - t0)
            counts.append({n: (r.num_results, r.num_notified, r.scanned,
                               r.broker_bytes.tolist())
                           for n, r in reps.items()})
            del reps
        out[backend] = dict(walls_ms=[1e3 * w for w in walls],
                            counts=counts, launches=launch_counts(),
                            shapes=launch_shapes(),
                            peak_gib=torch.cuda.max_memory_allocated(dev)
                            / 2 ** 30 if cuda else 0.0)
        del eng
    assert out["compact_pallas"]["counts"] == out["pallas"]["counts"], \
        "compact_pallas and pallas disagree"
    if cuda:     # a tick: ingest, one window discovery, one join (quads)
        for backend in out:
            want = dict.fromkeys(launch_counts(), 0)
            want.update(predicate_filter=cfg["ticks"],
                        predicate_filter_rows=cfg["ticks"])
            if backend == "compact_pallas":
                want.update(join_compact=cfg["ticks"],
                            join_compact_vector=cfg["ticks"])
            assert out[backend]["launches"] == want, \
                (backend, out[backend]["launches"])
    results = sum(v[0] for c in out["pallas"]["counts"] for v in c.values())
    return dict(out, results=results)


# ---------------------------------------------------------------------------
# phase 5: every plan on every backend
# ---------------------------------------------------------------------------


PLANS_7 = [("full", False, False), ("window", False, False),
           ("trad_index", False, False), ("bad_index", False, False),
           ("bad_index", True, False), ("bad_index", True, True),
           ("window", True, True)]


def every_plan(dev, cfg: dict) -> dict:
    from repro_torch.core import records as R
    from repro_torch.core.engine import BADEngine
    from repro_torch.core.plans import BACKENDS, ExecutionFlags, \
        ExecutionRequest
    from repro_torch.data import synthetic as syn

    rng = np.random.default_rng(SEED + 2)
    eng = BADEngine(dataset_capacity=cfg["dataset_capacity"],
                    index_capacity=cfg["index_capacity"],
                    max_window=cfg["max_window"],
                    max_candidates=cfg["max_candidates"],
                    brokers=("Broker0", "Broker1"), use_pallas=True,
                    device=dev)
    drugs, _, crime = channel_specs()
    eng.create_channel(drugs)
    eng.create_channel(crime)
    params, brokers = syn.subscriptions_by_population(rng, cfg["drug_subs"], 2)
    eng.subscribe_bulk(drugs.name, params, brokers)
    # coordinates on a 0.5 grid: both distance forms are exact there, so the
    # oracle and the kernel backend must agree pair for pair
    grid = lambda a: (np.round(a * 2) / 2).astype(np.float32)  # noqa: E731
    eng.set_user_locations(grid(rng.uniform(-100, 100, (cfg["users"], 2))),
                           rng.integers(0, 2, cfg["users"]))
    for tick in range(cfg["ticks"]):
        f, loc = syn.tweet_arrays(rng, cfg["tick_rows"], t0=1 + tick * 100)
        f = syn.drug_tweak(f, rng, 0.05)
        eng.ingest(R.RecordBatch.from_numpy(f, grid(loc), device=dev))
    plans = [ExecutionFlags(*p) for p in PLANS_7]

    def summary(rep):
        res = rep.result
        return rep.num_notified, set(res.matched_rows[res.matched_valid]
                                     .tolist())

    t0 = time.perf_counter()
    runs = 0
    seen = {}
    for name in (drugs.name, crime.name):
        for backend in ("oracle", "pallas"):
            for flags in plans:
                got = summary(eng.execute_channel(name, flags, advance=False,
                                                  backend=backend))
                want = seen.setdefault(name, got)
                assert got == want, (name, backend, flags, got[0], want[0])
                runs += 1
    # the fused path: every plan on every backend, one call per run
    reset_launch_counts()
    want_launches = dict.fromkeys(launch_counts(), 0)
    for backend in BACKENDS:
        for flags in plans:
            reps = eng.execute(ExecutionRequest(flags=flags, backend=backend,
                                                advance=False))
            for name in (drugs.name, crime.name):
                got = summary(reps[name])
                assert got == seen[name], (name, backend, flags, got[0],
                                           seen[name][0])
            runs += 1
            if backend in ("pallas", "compact_pallas"):
                # two join groups (param, spatial), each discovering once
                key = {"full": "predicate_filter", "window":
                       "predicate_filter_rows", "trad_index":
                       "predicate_filter_rows"}.get(flags.scan_mode)
                if key:
                    want_launches[key] += 2
                if backend == "pallas":
                    want_launches["spatial_match_stacked"] += 1
                else:
                    want_launches["join_compact"] += 1
            del reps
    launches = launch_counts()
    if dev.type == "cuda":
        # which join_compact path a plan takes follows its bucket's maxT
        vector = launches.pop("join_compact_vector")
        want_launches.pop("join_compact_vector")
        assert launches == want_launches, (launches, want_launches)
        assert vector <= launches["join_compact"], vector
        launches["join_compact_vector"] = vector
    out = {n: dict(notified=v[0], matched_rows=len(v[1]))
           for n, v in seen.items()}
    return dict(runs=runs, wall_s=time.perf_counter() - t0, channels=out,
                fused_launches=launches)


# ---------------------------------------------------------------------------
# phase 6: serving the LM
# ---------------------------------------------------------------------------


def logit_errors(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(relative L2 error, max abs error) of one token's logits, in f32."""
    g, w = got.float(), want.float()
    return (float(torch.linalg.vector_norm(g - w)
                  / torch.linalg.vector_norm(w)),
            float((g - w).abs().max()))


def serve_phase(dev, cfg, shape: dict) -> dict:
    """``launch/serve.py::serve`` on seeded weights: a short warm-up call
    (lazy library initialisation), then the measured call with the launch
    counts set to 0 just before it and read just after; then cached decode
    against the teacher-forced forward for 3 tokens."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.models.model import ModelApi

    batch, prompt, gen = shape["batch"], shape["prompt_len"], shape["gen"]
    cuda = dev.type == "cuda"
    t = time.perf_counter()
    params = ModelApi(cfg).init(torch.Generator(dev).manual_seed(SEED))
    sync(dev)
    init_s = time.perf_counter() - t
    serve(cfg, batch, prompt, 3, device=dev, params=params)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    toks, t_pre, t_dec = serve(cfg, batch, prompt, gen, device=dev,
                               params=params)
    launches, shapes = launch_counts(), launch_shapes()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0.0
    layers = cfg.superlayer_repeat
    if cuda:
        want = dict.fromkeys(launches, 0)
        want.update(flash_attention=layers, flash_decode=layers * (gen - 1))
        assert launches == want, launches
    assert toks.shape == (batch, gen) and (toks >= 0).all() \
        and (toks < cfg.vocab_size).all()
    # cached decode == teacher-forced forward (the reference's
    # test_decode_matches_forward), at full width
    rng = np.random.default_rng(SEED + 5)
    seq = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, prompt + 3))
                       .astype(np.int32), device=dev)
    full, _ = lm.forward(params, cfg, tokens=seq)
    full = full[:, prompt - 1:, :cfg.vocab_size]
    lg, caches, pos = lm.prefill(params, cfg, tokens=seq[:, :prompt],
                                 max_len=prompt + 4)
    errs = [logit_errors(lg, full[:, 0])]
    for i in range(3):
        lg, caches = lm.decode_step(params, cfg, caches, pos + i,
                                    token=seq[:, prompt + i])
        errs.append(logit_errors(lg, full[:, i + 1]))
    del full, caches, params
    assert all(r <= DECODE_REL_L2 and m <= DECODE_MAX_ABS for r, m in errs), \
        errs
    return dict(init_s=init_s, prefill_ms=1e3 * t_pre,
                decode_ms_per_token=1e3 * t_dec / max(1, gen - 1),
                decode_tokens_per_s=batch * (gen - 1) / t_dec,
                tokens_per_s=batch * gen / (t_pre + t_dec), peak_gib=peak,
                launches=launches, shapes=shapes, decode_vs_forward=errs,
                sample=toks[0, :8].tolist(), **shape)


# ---------------------------------------------------------------------------
# phase 7: the enriched fused tick
# ---------------------------------------------------------------------------


class RecordingStage:
    """An enrichment stage that runs another and keeps, per ``score`` call,
    its scores and CUDA events around it (the engine calls it once per
    scored join group, param group first)."""

    def __init__(self, inner, dev):
        self.inner, self.dev, self.calls = inner, dev, []

    @property
    def budget(self):
        return self.inner.budget

    @property
    def identity(self) -> tuple:
        return self.inner.identity

    def score(self, payload_tokens, channel_ids, sids):
        ev = None
        if self.dev.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        scores = self.inner.score(payload_tokens, channel_ids, sids)
        if ev is not None:
            ev[1].record()
        self.calls.append((int(payload_tokens.shape[0]), scores, ev))
        return scores


def check_rank_rule(reps, names, scores: torch.Tensor, budget: int) -> int:
    """The rank contract on the host (numpy) for one scored join group:
    each channel keeps the pairs of its top slots by (score desc, slot
    asc), funded down to ``budget``, the first valid pairs of a partly
    funded slot, and reports the rest as ranked. The kept mask comes from
    ``enrich.rank_result`` replaying the recorded scores on the reports'
    full join results; it must equal a numpy implementation of the
    contract, every kept slot must score at least every fully dropped slot
    (ties to the lower slot), and its ranked count must equal the engine's.
    Returns the number of slots checked."""
    from repro_torch.core import enrich
    from repro_torch.core.plans import ChannelResult

    class Replay:
        identity = ("replay",)

        def __init__(self):
            self.budget = budget

        def score(self, payload_tokens, channel_ids, sids):
            return scores

    results = [reps[n].result for n in names]
    stacked = ChannelResult(*(torch.stack(f) for f in zip(*results)))
    dev = stacked.pair_valid.device

    class Fields:     # the replayed scores need no tokens
        fields = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        capacity = 1

    pruned, ranked, _ = enrich.rank_result(
        Replay(), Fields(), stacked, torch.arange(len(names), device=dev),
        torch.zeros((len(names), 0), dtype=torch.int32, device=dev))
    sc = scores.reshape(len(names), -1).cpu().numpy()
    keep_all = pruned.pair_valid.cpu().numpy()
    for i, name in enumerate(names):
        valid = stacked.pair_valid[i].cpu().numpy()
        s, keep = sc[i], keep_all[i]
        vc = valid.sum(1)
        live = np.flatnonzero(vc > 0)
        order = live[np.lexsort((live, -s[live]))]
        before = np.cumsum(vc[order]) - vc[order]
        slot_keep = np.zeros(len(vc), np.int64)
        slot_keep[order] = np.clip(budget - before, 0, vc[order])
        want = valid & (np.cumsum(valid, 1) - 1 < slot_keep[:, None])
        assert np.array_equal(keep, want), name
        kept = np.flatnonzero(keep.any(1))
        dropped = np.flatnonzero(valid.any(1) & ~keep.any(1))
        if len(kept) and len(dropped):
            low = s[kept].min()
            assert low >= s[dropped].max(), (name, low, s[dropped].max())
            tie = dropped[s[dropped] == low]
            if len(tie):
                assert kept[s[kept] == low].max() < tie.min(), name
        rk = int(valid.sum() - keep.sum())
        assert rk == int(ranked[i]) == reps[name].overflow.ranked_pairs, \
            (name, rk, int(ranked[i]), reps[name].overflow.ranked_pairs)
    return sc.size


def enriched_phase(dev, cfg: dict, lm_cfg, budget: int) -> dict:
    """Phase 3's engine and plans with ``LMScorer(lm_cfg, budget)``
    attached; ``execute_all(None, deliver=True)`` + ``drain_spilled()``
    each tick, the launch counts set to 0 just before the ticks."""
    from repro_torch.core import enrich
    from repro_torch.core import records as R
    from repro_torch.core.predicates import compile_conditions
    from repro_torch.data import synthetic as syn

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(SEED + 1)
    t_setup = time.perf_counter()
    eng, specs, sub_counts, users = build_main_engine(dev, cfg, rng)
    plans = fused_plans()
    for name, plan in plans.items():
        eng.set_plan(name, plan)
    stage = RecordingStage(enrich.LMScorer(cfg=lm_cfg, budget=budget,
                                           seed=SEED, device=dev), dev)
    eng.set_enrichment(stage)
    sync(dev)
    setup_s = time.perf_counter() - t_setup
    one = {s.name: compile_conditions([list(s.fixed_preds)]) for s in specs}
    groups = [[s.name for s in specs if s.join == "param"],
              [s.name for s in specs if s.join == "spatial"]]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    sync(dev)
    tick_ms, score_ms, slots, ranked, checked = [], [], [], [], 0
    for tick in range(cfg["ticks"]):
        f, loc = syn.tweet_arrays(rng, cfg["tick_rows"], t0=1 + tick * 100)
        f = syn.drug_tweak(f, rng, 0.05)
        before = launch_counts()
        stage.calls.clear()
        ts = time.perf_counter()
        eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
        reps = eng.execute_all(None, deliver=True)
        eng.drain_spilled()
        sync(dev)
        tick_ms.append(1e3 * (time.perf_counter() - ts))
        got = since(before)
        assert len(stage.calls) == len(groups), len(stage.calls)
        if cuda:
            want = dict.fromkeys(got, 0)
            want.update(predicate_filter=1, spatial_match_stacked=1,
                        join_compact=1, join_compact_vector=1,
                        flash_attention=lm_cfg.superlayer_repeat
                        * len(groups), **FUSED_DELIVER)
            assert got == want, (tick, got)
            score_ms.append([ev[0].elapsed_time(ev[1])
                             for _, _, ev in stage.calls])
        slots.append([n for n, _, _ in stage.calls])
        for spec in specs:
            rep = reps[spec.name]
            check_conservation(rep)
            o = rep.overflow
            assert o.ranked_pairs == max(0, rep.num_results - budget), \
                (spec.name, o.ranked_pairs, rep.num_results)
            assert o.ranked_pairs <= o.dropped_pairs
            assert o.ranked_sids <= o.dropped_sids
            check_numpy(rep, spec, f, loc, one, sub_counts, users,
                        tick in cfg["spatial_check_ticks"])
        ranked.append({n: reps[n].overflow.ranked_pairs for n in reps})
        if tick == cfg["rank_check_tick"]:
            for names, (_, scores, _) in zip(groups, stage.calls):
                checked += check_rank_rule(reps, names, scores, budget)
        del reps
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0.0
    launches, shapes = launch_counts(), launch_shapes()
    rows = eng.size_host
    del eng, stage
    return dict(setup_s=setup_s, ticks=cfg["ticks"], tick_ms=tick_ms,
                score_ms=score_ms, scored_slots=slots, ranked=ranked,
                groups=groups, rank_checked_slots=checked, peak_gib=peak,
                launches=launches, shapes=shapes, rows_ingested=rows,
                budget=budget)


# ---------------------------------------------------------------------------
# phase 8: churn
# ---------------------------------------------------------------------------

# the program's spans (core/trace.py) whose host time phase 8 reports: the
# stacked caches' patches and rebuilds, and the control-plane calls
CHURN_SPANS = ("patch", "rebuild", "subscribe_bulk", "remove_subscriptions",
               "subscribe_users", "unsubscribe_users")
# the run's counters two schedules of the same seed must agree on
CHURN_COUNTERS = ("adds", "removes", "user_adds", "user_removes", "results",
                  "delivered_pairs", "delivered_sids", "spilled", "dropped",
                  "live_subs")


def host_timers(eng, names) -> dict:
    """Wrap the engine's methods ``names`` (instance attributes, so the
    engine's own calls go through them) to add their host seconds to the
    returned dict."""
    spent = dict.fromkeys(names, 0.0)

    def wrap(name, fn):
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t
        return timed

    for name in names:
        setattr(eng, name, wrap(name, getattr(eng, name)))
    return spent


def churn_engine(dev, cfg: dict, incremental: bool = True):
    """The main path's engine with its plans (phase 3's), TweetsAboutCrime3
    converted to an explicit cohort of ``cfg["cohort"]`` users. Returns
    (engine, specs, users, live sIDs, workloads)."""
    from repro_torch.core.churn import ChurnWorkload

    rng = np.random.default_rng(SEED + 8)
    eng, specs, _, users = build_main_engine(dev, cfg, rng, incremental)
    for name, plan in fused_plans().items():
        eng.set_plan(name, plan)
    drugs, threat, crime = specs
    eng.subscribe_users(crime.name, rng.choice(cfg["users"], cfg["cohort"],
                                               replace=False))
    # the aggregator numbers a channel's subscriptions 0, 1, ...
    live = {drugs.name: np.arange(cfg["drug_subs"], dtype=np.int32),
            threat.name: np.arange(cfg["threat_subs"], dtype=np.int32)}
    for name, sids in live.items():
        assert eng.channels[name].aggregator.num_subscriptions == len(sids)
    wl = [ChurnWorkload(drugs.name, cfg["drug_churn"], cfg["drug_churn"],
                        num_brokers=4, user_channel=crime.name,
                        user_churn_per_tick=cfg["user_churn"]),
          ChurnWorkload(threat.name, cfg["threat_churn"],
                        cfg["threat_churn"], num_brokers=4)]
    return eng, specs, users, live, wl


def churn_run(dev, cfg: dict, eng, specs, users, live, wl, ticks: int,
              warmup: int, depth: int = 1, check_tick=None,
              use_planner: bool = False) -> dict:
    """``run_ticks`` on a phase-8 engine with the checks in its hooks:
    conservation of every report, each tick's kernel launches (on the card;
    1 predicate_filter, 1 spatial_match_stacked, 1 join_compact on its quad
    path), and at ``check_tick`` the cohort's spatial hits against numpy.
    Returns the report, per-tick walls, host seconds by span
    (``CHURN_SPANS``, from the program's tracer), the
    dispatch-to-materialize latencies and the launch counts."""
    from repro_torch.core import records as R
    from repro_torch.core import trace
    from repro_torch.core.churn import run_ticks
    from repro_torch.core.planner import RuntimePlanner
    from repro_torch.core.predicates import compile_conditions
    from repro_torch.data import synthetic as syn

    cuda = dev.type == "cuda"
    crime = specs[2]
    one = compile_conditions([list(crime.fixed_preds)])
    pends, latency = [], []
    dispatch = eng.dispatch

    def keep_pending(request):
        # each dispatch's latency, read once it synced; handles are not
        # kept past their sync
        for p in pends:
            if p.done:
                latency.append(p.latency_s)
        pends[:] = [p for p in pends if not p.done] + [dispatch(request)]
        return pends[-1]

    eng.dispatch = keep_pending
    batches = {}

    def make_batch(r, n, t0):
        # tweet_batch's draws, keeping the host arrays for the numpy check
        f, loc = syn.tweet_arrays(r, n, t0)
        batches[t0] = (f, loc)
        return R.RecordBatch.from_numpy(f, loc, device=dev)

    planner = RuntimePlanner(eng) if use_planner else None
    stamps, hits = [], []

    def on_tick(tick, reports):
        stamps.append(time.perf_counter())
        if planner is not None:
            planner.step(reports)
        for rep in reports.values():
            check_conservation(rep)
        if cuda and depth == 1 and not use_planner:
            got = since(before[0])
            want = dict.fromkeys(got, 0)
            want.update(predicate_filter=1, spatial_match_stacked=1,
                        join_compact=1, join_compact_vector=1,
                        **FUSED_DELIVER)
            assert got == want, (tick, got)
            before[0] = launch_counts()
        if tick == check_tick:
            f, loc = batches[max(batches)]
            cohort = eng.channels[crime.name].cohort.slot_uids()
            want = spatial_hits_numpy(loc[_host_match(f, one)],
                                      users[cohort[cohort >= 0]],
                                      crime.spatial_radius)
            got = reports[crime.name].num_results
            assert got == want, (tick, got, want)
            hits.append(got)
        batches.clear()

    reset_launch_counts()
    before = [launch_counts()]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    trace.collect()
    trace.enable()
    try:
        rep = run_ticks(eng, wl, ticks, np.random.default_rng(SEED + 9),
                        flags=None, deliver=True,
                        ingest_per_tick=cfg["tick_rows"],
                        make_batch=None if depth > 1 else make_batch,
                        warmup=warmup, live_sids=live,
                        churn_rounds=cfg["rounds"], use_channel_plans=True,
                        on_tick=on_tick, pipeline_depth=depth)
    finally:
        trace.disable()
    host = dict.fromkeys(CHURN_SPANS, 0.0)
    for r in trace.collect():
        if r.name in host:
            host[r.name] += 1e-9 * (r.end_ns - r.start_ns)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    latency += [p.latency_s for p in pends]
    eng.dispatch = dispatch
    walls = np.diff(stamps[warmup:]) if depth == 1 else np.zeros(0)
    return dict(report=rep, walls_ms=1e3 * walls, host_s=host,
                latency_ms=[1e3 * x for x in latency[warmup:]],
                launches=launches, hits=hits, peak_gib=peak,
                switches=[] if planner is None else [
                    (sw.tick, sw.channel, sw.old.to_dict(), sw.new.to_dict())
                    for sw in planner.switches])


def churn_phase(dev, cfg: dict) -> dict:
    """Phase 8: (a) the incremental engine, depth 1; (b) the same engine
    built again, depth 2 (``TickPipeline``); (c) a rebuild engine
    (``incremental=False``); (d) (a)'s engine with ``RuntimePlanner``
    hooked into ``run_ticks``."""
    cuda = dev.type == "cuda"
    w, t = cfg["warmup"], cfg["ticks"]
    out = {}
    t0 = time.perf_counter()
    a_parts = churn_engine(dev, cfg)
    out["setup_s"] = time.perf_counter() - t0
    a = churn_run(dev, cfg, *a_parts, ticks=w + t, warmup=w, check_tick=0)
    out["a"] = a
    m = a["report"].maintenance
    assert m.rebuilds == 0 and m.patches > 0, m
    assert a["hits"], a["hits"]
    if cuda:
        n = w + t
        assert a["launches"]["predicate_filter"] == n and \
            a["launches"]["spatial_match_stacked"] == n and \
            a["launches"]["join_compact"] == n == \
            a["launches"]["join_compact_vector"] and \
            a["launches"]["deliver"] == 2 * n == \
            2 * a["launches"]["deliver_vector"], a["launches"]
    eng_a = a_parts[0]

    b_parts = churn_engine(dev, cfg)
    b = churn_run(dev, cfg, *b_parts, ticks=w + t, warmup=w, depth=2)
    out["b"] = b
    ra, rb = a["report"], b["report"]
    assert [getattr(ra, k) for k in CHURN_COUNTERS] == \
        [getattr(rb, k) for k in CHURN_COUNTERS], (ra, rb)
    m = rb.maintenance
    assert m.rebuilds == 0 and m.patches > 0, m
    assert rb.pipeline_depth == 2, rb.pipeline_depth
    if cuda:
        n = w + t
        assert b["launches"]["predicate_filter"] == n and \
            b["launches"]["spatial_match_stacked"] == n and \
            b["launches"]["join_compact"] == n == \
            b["launches"]["join_compact_vector"] and \
            b["launches"]["deliver"] == 2 * n == \
            2 * b["launches"]["deliver_vector"], b["launches"]
    del b_parts
    if cuda:
        torch.cuda.empty_cache()

    c_parts = churn_engine(dev, cfg, incremental=False)
    c = churn_run(dev, cfg, *c_parts, ticks=w + cfg["rebuild_ticks"],
                  warmup=w)
    out["c"] = c
    assert c["report"].maintenance.patches == 0, c["report"].maintenance
    del c_parts
    if cuda:
        torch.cuda.empty_cache()

    d = churn_run(dev, cfg, *a_parts, ticks=cfg["planner_ticks"], warmup=0,
                  use_planner=True)
    out["d"] = d
    assert d["report"].queue_pending == 0, d["report"]
    out["ratio"] = ra.subs_per_s / max(c["report"].subs_per_s, 1e-9)
    del eng_a, a_parts
    return out


# ---------------------------------------------------------------------------
# phase 9: the sharded engine
# ---------------------------------------------------------------------------

# the kernel entries phase 9's engine launches, once a shard a tick
SHARDED_KERNELS = ("predicate_filter", "spatial_match_stacked",
                   "join_compact", "join_compact_vector")


def build_sharded_engine(dev, cfg: dict, rng, num_shards: int):
    """Phase 3's engine and plans as a ``ShardedBADEngine`` of ``num_shards``
    shards on ``dev`` with cross-shard routing on (which surfaces the
    delivery buffers): ``build_main_engine``'s draws (the subscriptions,
    then the users), the users set before the channels, so that
    TweetsAboutCrime3's cohort is every user, hash-split over the shards.
    Returns (engine, specs, per-state subscription counts, users)."""
    from repro_torch.core.sharded import ShardedBADEngine
    from repro_torch.data import synthetic as syn

    eng = ShardedBADEngine(
        num_shards=num_shards, route_cross_shard=True, device=dev,
        dataset_capacity=cfg["dataset_capacity"],
        index_capacity=cfg["index_capacity"], max_window=cfg["max_window"],
        max_candidates=cfg["max_candidates"],
        brokers=tuple(f"Broker{i}" for i in range(4)),
        max_deliver_pairs=cfg["max_deliver_pairs"],
        max_notify=cfg["max_notify"], use_pallas=True)
    specs = channel_specs()
    subs = [syn.subscriptions_by_population(rng, n, 4)
            for n in (cfg["drug_subs"], cfg["threat_subs"])]
    users = rng.uniform(-100, 100, (cfg["users"], 2)).astype(np.float32)
    eng.set_user_locations(users, rng.integers(0, 4, cfg["users"]))
    for spec in specs:
        eng.create_channel(spec)
    sub_counts = {}
    for spec, (params, brokers) in zip(specs, subs):
        eng.subscribe_bulk(spec.name, params, brokers)
        sub_counts[spec.name] = np.bincount(params, minlength=50)
    for name, plan in fused_plans().items():
        eng.set_plan(name, plan)
    return eng, specs, sub_counts, users


def check_routed(eng, rep, owner_of: np.ndarray,
                 counts: np.ndarray) -> None:
    """``routed`` holds exactly the delivered sIDs (``counts``: how often
    each was delivered) and each row only sIDs whose broker endpoint that
    row's shard owns (``owner_of``: each sID's broker's shard): row o's
    live prefix is as long as the deliveries its brokers own, holds only
    their sIDs, as often as they were delivered, and -1 follows it."""
    s = eng.num_shards
    routed = rep.routed
    assert routed.dtype == np.int32 and routed.shape == (
        s, s * eng.shards[0].max_notify), routed.shape
    per_owner = np.bincount(owner_of, weights=counts, minlength=s)
    got = np.zeros(counts.shape, np.int64)
    for o in range(s):
        n = int(per_owner[o])
        row = routed[o, :n]
        assert (routed[o, n:] == -1).all(), (rep.channel, o)
        assert (row >= 0).all() and (owner_of[row] == o).all(), \
            (rep.channel, o)
        got += np.bincount(row, minlength=counts.shape[0])
    assert np.array_equal(got, counts), rep.channel


def check_partitioned(eng, specs) -> None:
    """Every shard's live sIDs are the registry's, each on its hash shard,
    and the cohort of every user is split by ``shard_for_users``."""
    from repro_torch.distributed import partition
    s = eng.num_shards
    for spec in specs:
        if spec.join == "param":
            per = eng.shard_live_sids(spec.name)
            assert np.array_equal(np.sort(np.concatenate(per)),
                                  eng.live_sids(spec.name)), spec.name
            of = partition.shard_for_sids
        else:
            per = [e.channels[spec.name].cohort.slot_uids() for e in
                   eng.shards]
            per = [u[u >= 0] for u in per]
            assert np.array_equal(np.sort(np.concatenate(per)),
                                  np.arange(len(eng._user_brokers))), \
                spec.name
            of = partition.shard_for_users
        for i, ids in enumerate(per):
            assert (of(ids, s) == i).all(), (spec.name, i)


def drained_sids(drained: dict, with_pairs: bool) -> tuple:
    """The sIDs each channel's drain reports re-delivered (host arrays;
    keys ``chan`` or ``chan@s{i}[#r{k}]``) and, ``with_pairs``, the (row,
    sID) pairs of the re-packed lines (a full round is 16,384 lines of up
    to 10,240 sIDs: only the exact runs, which drain nothing, ask)."""
    from repro_torch.core.broker import payload_notifications
    sids, pairs = {}, {}
    for key, dr in drained.items():
        name = key.split("@")[0]
        st = dr.stats
        if dr.notify is not None and st.delivered_sids:
            sids.setdefault(name, []).append(
                dr.notify[:st.delivered_sids].cpu().numpy())
        if with_pairs and dr.payload is not None and st.delivered_pairs:
            # only the delivered lines cross to the host: the buffer is
            # max_deliver_pairs lines of the slot table's width (672 MB)
            lines = dr.payload[:st.delivered_pairs].cpu().numpy()
            pairs.setdefault(name, []).append(payload_notifications(
                lines, st.delivered_pairs, 8))
    return sids, pairs


def pair_keys(pairs: list) -> np.ndarray:
    """(row, sID) pairs as sorted int64 keys, for multiset comparison."""
    if not pairs:
        return np.zeros(0, np.int64)
    p = np.concatenate(pairs).astype(np.int64)
    return np.sort((p[:, 0] << 32) | p[:, 1])


def owners(eng, specs) -> dict:
    """Per channel, each registered sID's (or user's) hash shard and its
    broker's shard, as lookup tables for the per-tick checks."""
    from repro_torch.distributed import partition
    s = eng.num_shards
    out = {}
    for spec in specs:
        if spec.join == "spatial":
            brokers = eng._user_brokers
            home = partition.shard_for_users(np.arange(len(brokers)), s)
        else:
            reg = eng._reg[spec.name]
            brokers = reg.brokers[:reg.next_sid]
            home = partition.shard_for_sids(np.arange(reg.next_sid), s)
        out[spec.name] = (home, partition.broker_owner(brokers, s))
    return out


HOST_PARTS = ("dispatch", "_materialize_group")


def sharded_run(dev, cfg: dict, num_shards: int, tick_rows: int,
                ticks: int, reshard_after=None, exact: bool = False) -> dict:
    """Phase 3's workload at ``tick_rows`` tweets a tick through a sharded
    engine: ``warmup`` + ``ticks`` ticks of ingest, ``execute_all(None,
    deliver=True)`` and ``drain_spilled()``; with ``reshard_after``,
    ``reshard(2)`` after that timed tick. Each tick: per-shard
    conservation, each shard's delivered sIDs on their hash shard, the
    routing invariant, S launches of each kernel (on the card), and the
    tick's time by part (ingest; the shards' ``dispatch`` and
    ``_materialize_group`` host time; the shuffle; the drain). ``exact``
    records every tick's delivered sID and (row, sID) multisets per channel
    and asserts that nothing overflows; otherwise the param channels'
    delivered sIDs, drains included, must never outnumber what the ticks
    produced (per sID, cumulatively: numpy counts the matching tweets a
    state) and TweetsAboutCrime3, whose sIDs never overflow, keeps its
    per-tick sID multiset."""
    from repro_torch.core import records as R
    from repro_torch.core.broker import payload_notifications
    from repro_torch.core.predicates import compile_conditions
    from repro_torch.data import synthetic as syn

    cuda = dev.type == "cuda"
    warmup = cfg["warmup"]
    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    eng, specs, sub_counts, users = build_sharded_engine(dev, cfg, rng,
                                                         num_shards)
    setup_s = time.perf_counter() - t0
    one = {s.name: compile_conditions([list(s.fixed_preds)]) for s in specs}
    route_s = []
    route = eng._route

    def timed_route(merged):
        t = time.perf_counter()
        route(merged)
        route_s.append(time.perf_counter() - t)

    eng._route = timed_route
    spent = [host_timers(e, HOST_PARTS) for e in eng.shards]
    table = owners(eng, specs)
    params = {s.name: eng._reg[s.name].params[:eng._reg[s.name].next_sid]
              for s in specs if s.join == "param"}
    produced = {n: np.zeros(p.shape, np.int64) for n, p in params.items()}
    got_cum = {n: np.zeros(p.shape, np.int64) for n, p in params.items()}
    walls, parts, shards_at, content, notified, delivered = ([] for _ in
                                                            range(6))
    totals = dict(delivered_sids=0, redelivered_sids=0, spilled_sids=0,
                  dropped_sids=0, spilled_pairs=0, dropped_pairs=0)
    reshard_s = ring_at_reshard = reshard_launches = None
    reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t_run = time.perf_counter()
    for tick in range(warmup + ticks):
        f, loc = syn.tweet_arrays(rng, tick_rows, t0=1 + tick * 100)
        f = syn.drug_tweak(f, rng, 0.05)
        before, n_route = launch_counts(), len(route_s)
        host0 = {k: sum(d[k] for d in spent) for k in HOST_PARTS}
        ts = time.perf_counter()
        eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
        sync(dev)
        ti = time.perf_counter()
        reps = eng.execute_all(None, deliver=True)
        te = time.perf_counter()
        drained = eng.drain_spilled()
        sync(dev)
        walls.append(time.perf_counter() - ts)
        host = {k: 1e3 * (sum(d[k] for d in spent) - host0[k])
                for k in HOST_PARTS}
        parts.append(dict(ingest=1e3 * (ti - ts), **host,
                          route=1e3 * sum(route_s[n_route:]),
                          execute_all=1e3 * (te - ti),
                          drain=1e3 * (walls[-1] - (te - ts))))
        s = eng.num_shards
        shards_at.append(s)
        got = since(before)
        if cuda:
            want = dict.fromkeys(got, 0)
            want.update(dict.fromkeys(SHARDED_KERNELS, s))
            want.update({k: s * n for k, n in FUSED_DELIVER.items()})
            assert got == want, (tick, s, got)
        re_sids, re_pairs = drained_sids(drained, exact)
        tick_content, tick_notified = {}, {}
        delivered.append(0)
        for spec in specs:
            rep = reps[spec.name]
            home, owner_of = table[spec.name]
            n_ids = home.shape[0]
            counts = np.zeros(n_ids, np.int64)
            pairs = list(re_pairs.get(spec.name, []))
            for i, r in enumerate(rep.per_shard):
                check_conservation(r)
                o = r.overflow
                d = np.asarray(r.notify)[:o.delivered_sids]
                assert (home[d] == i).all(), (tick, spec.name, i)
                counts += np.bincount(d, minlength=n_ids)
                for k in totals:
                    if k != "redelivered_sids":
                        totals[k] += getattr(o, k)
                if exact:
                    assert o.overflow == 0, (tick, spec.name, i, o)
                    pairs.append(payload_notifications(
                        r.payload, o.delivered_pairs, 8))
                elif spec.join == "spatial":
                    assert o.overflow_sids == 0, (tick, spec.name, i, o)
            check_routed(eng, rep, owner_of, counts)
            for x in re_sids.get(spec.name, []):
                counts += np.bincount(x, minlength=n_ids)
            tick_notified[spec.name] = rep.num_notified
            n_delivered = int(counts.sum())
            delivered[-1] += n_delivered
            totals["redelivered_sids"] += n_delivered - sum(
                r.overflow.delivered_sids for r in rep.per_shard)
            if exact or spec.join == "spatial":
                tick_content[spec.name] = (
                    counts, pair_keys(pairs) if exact else None,
                    rep.num_results if spec.join == "spatial" else None)
            else:
                m = np.bincount(f[_host_match(f, one[spec.name]),
                                  spec.param_field], minlength=50)
                produced[spec.name] += m[params[spec.name]]
                got_cum[spec.name] += counts
                assert (got_cum[spec.name] <= produced[spec.name]).all(), \
                    (tick, spec.name)
            if tick == 0:
                check_numpy(rep, spec, f, loc, one, sub_counts, users, True)
        content.append(tick_content)
        notified.append(tick_notified)
        if exact:
            assert eng.ring_pending_pairs() + eng.ring_pending_sids() == 0
        del reps, drained
        if reshard_after is not None and tick == warmup + reshard_after - 1:
            old = list(eng.shards)
            ring_at_reshard = (eng.ring_pending_pairs(),
                               eng.ring_pending_sids(),
                               eng.spill.pending_pairs(),
                               eng.spill.pending_sids())
            before = launch_counts()
            sync(dev)
            t = time.perf_counter()
            dr = eng.reshard(2)
            sync(dev)
            reshard_s = time.perf_counter() - t
            reshard_launches = since(before)
            assert all(x.stats.dropped_pairs == x.stats.dropped_sids == 0
                       for x in dr.values()), "reshard dropped entries"
            assert sum(e.ring_flush_drops for e in old) == 0
            del old
            re_sids, re_pairs = drained_sids(dr, exact)
            if exact:
                assert not re_sids and not re_pairs, "nothing to drain"
            for name, arrs in re_sids.items():
                # only the param channels' sIDs overflow
                assert name in got_cum, name
                n = sum(len(x) for x in arrs)
                totals["redelivered_sids"] += n
                delivered[-1] += n
                for x in arrs:
                    got_cum[name] += np.bincount(
                        x, minlength=params[name].shape[0])
                assert (got_cum[name] <= produced[name]).all(), name
            check_partitioned(eng, specs)
            spent = [host_timers(e, HOST_PARTS) for e in eng.shards]
            table = owners(eng, specs)
    run_s = time.perf_counter() - t_run
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    eng._route = route
    del eng
    stop = warmup + (reshard_after or ticks)
    timed = np.asarray(walls[warmup:stop])
    part_ms = {k: float(np.mean([p[k] for p in parts[warmup:stop]]))
               for k in parts[0]}
    return dict(
        num_shards=num_shards, setup_s=setup_s, walls_ms=1e3 * timed,
        tick_ms_mean=1e3 * float(timed.mean()),
        tick_ms_p50=1e3 * float(np.median(timed)),
        tick_ms_max=1e3 * float(timed.max()),
        ticks_per_s=float(1 / timed.mean()),
        notifications_per_s=float(sum(delivered[warmup:stop]) / timed.sum()),
        delivered_per_tick=float(np.mean(delivered[warmup:stop])),
        part_ms=part_ms, after_ms=[1e3 * w for w in walls[stop:]],
        warmup_ms=[1e3 * w for w in walls[:warmup]], run_s=run_s,
        check_s=run_s - sum(walls) - (reshard_s or 0.0),
        route_ms_mean=part_ms["route"], shards_at=shards_at,
        content=content, notified=notified, totals=totals,
        launches=launches, peak_gib=peak, reshard_s=reshard_s,
        ring_at_reshard=ring_at_reshard, reshard_launches=reshard_launches)


def same_content(a: dict, b: dict, ticks: int, what: str) -> int:
    """Per tick and channel, equal delivered sID multisets (counts per sID)
    and pair multisets where both recorded them, equal produced sID counts
    and equal spatial results; returns the number of (tick, channel)
    comparisons."""
    n = 0
    for t in range(ticks):
        assert a["notified"][t] == b["notified"][t], (what, t)
        assert a["content"][t].keys() == b["content"][t].keys(), (what, t)
        for name, (sids, pairs, results) in a["content"][t].items():
            sids_b, pairs_b, results_b = b["content"][t][name]
            assert np.array_equal(sids, sids_b), (what, t, name)
            assert results == results_b, (what, t, name)
            if pairs is not None:
                assert np.array_equal(pairs, pairs_b), (what, t, name)
            n += 1
    return n


def sp_decode_phase(dev, rng) -> dict:
    """``sp_decode_attention`` at the serve phase's last decode step (B 8,
    H 12, KH 2, a 544-key cache, D 128, bf16) over 4 sequence slices of
    136 keys on ``dev``, rows whose live keys end in every slice, at a
    slice boundary and in the first slice only (slices 2-4 empty): held
    against one ``flash_decode`` call and the plain version within
    ``FLASH_TOL``; 4 partial launches a call; both timed."""
    from repro_torch.distributed.collectives import sp_decode_attention
    from repro_torch.distributed.partition import Rules
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref

    b, h, kh, s_len, d = SP_DECODE

    def normal(*sh):
        return torch.tensor(rng.normal(size=sh).astype(np.float32),
                            device=dev).to(torch.bfloat16)

    q, k, v = normal(b, h, d), normal(b, kh, s_len, d), normal(b, kh, s_len, d)
    kv_len = torch.tensor(SP_KV_LEN, dtype=torch.int32, device=dev)
    rules = Rules([dev] * 4)
    reset_launch_counts()
    before = launch_counts()
    got = sp_decode_attention(rules, q, k, v, kv_len)
    sync(dev)
    launches = since(before)["flash_decode"]
    one = fd_ops.decode_attention(q, k, v, kv_len)
    plain = fd_ref.decode_attention(q, k, v, kv_len)
    errs = {}
    for name, want in (("flash_decode", one), ("plain", plain)):
        g, w = got.float(), want.float()
        assert tol_excess(g, w, *FLASH_TOL[torch.bfloat16]) <= 0, name
        errs[name] = max_abs_err(g, w)
    out = dict(launches=launches, errors=errs, shape=(b, h, kh, s_len, d),
               kv_len=SP_KV_LEN)
    if dev.type == "cuda":
        assert launches == 4, launches
        out.update(
            sp_ms=cuda_ms(lambda: sp_decode_attention(rules, q, k, v,
                                                      kv_len), 50),
            sp_graph_ms=graph_ms(lambda: sp_decode_attention(
                rules, q, k, v, kv_len), 20),
            one_ms=cuda_ms(lambda: fd_ops.decode_attention(q, k, v, kv_len),
                           50),
            one_graph_ms=graph_ms(lambda: fd_ops.decode_attention(
                q, k, v, kv_len), 20))
    return out


def sharded_phase(dev, cfg: dict) -> dict:
    """Phase 9: (a) phase 3's workload through one shard and through 4
    shards with routing, 2 + 10 ticks each, the 4-shard engine resharded to
    2 after its 5th timed tick, rings populated (b); (a2) the same engines
    at ``exact_rows`` tweets a tick, where no buffer overflows, so that
    every tick's delivered content must be equal, with a ``reshard(2)``
    after timed tick ``exact_reshard``; (c) the sequence-parallel
    decode."""
    out = {}
    full = {s: sharded_run(dev, cfg, s, cfg["tick_rows"], cfg["ticks"],
                           reshard_after=cfg["reshard_after"] if s > 1
                           else None)
            for s in (1, 4)}
    n = cfg["warmup"] + cfg["ticks"]
    out["full_compared"] = same_content(full[1], full[4], n, "full rate")
    assert full[4]["ring_at_reshard"][0] + full[4]["ring_at_reshard"][1] > 0, \
        full[4]["ring_at_reshard"]
    exact = {s: sharded_run(dev, cfg, s, cfg["exact_rows"],
                            cfg["exact_ticks"],
                            reshard_after=cfg["exact_reshard"] if s > 1
                            else None, exact=True)
             for s in (1, 4)}
    out["exact_compared"] = same_content(
        exact[1], exact[4], cfg["warmup"] + cfg["exact_ticks"], "exact")
    for run in (*full.values(), *exact.values()):
        run.pop("content")
    out.update(full=full, exact=exact,
               sp=sp_decode_phase(dev, np.random.default_rng(SEED + 10)))
    return out


def print_sharded(sh: dict, card: str) -> None:
    """Phase 9's ``[sharded]`` lines, each with the card's line."""
    for key, what in (("full", f"{SHARDED['tick_rows']} tweets a tick"),
                      ("exact", f"{SHARDED['exact_rows']} tweets a tick, "
                                "no buffer overflows")):
        tag = "a" if key == "full" else "a2"
        for s, r in sh[key].items():
            shards = f"{s} shard{'s' if s > 1 else ''}"
            print(f"[sharded] ({tag}) {shards}, {what}, on {card}: setup "
                  f"{r['setup_s']:.1f} s; {len(r['walls_ms'])} timed ticks "
                  f"at {shards}: mean {r['tick_ms_mean']:.2f} ms, p50 "
                  f"{r['tick_ms_p50']:.2f}, max {r['tick_ms_max']:.2f} ms; "
                  f"{r['ticks_per_s']:.3f} ticks/s, "
                  f"{r['notifications_per_s']:.0f} notifications/s "
                  f"({r['delivered_per_tick']:.0f} delivered sIDs a tick, "
                  f"drains included); shuffle (_route) "
                  f"{r['route_ms_mean']:.2f} ms a tick; max_memory_allocated "
                  f"{r['peak_gib']:.2f} GiB")
            print(f"[sharded] ({tag}) {shards}: host ms a timed tick by part "
                  f"{json.dumps({k: round(v, 2) for k, v in r['part_ms'].items()})}"
                  f" (dispatch and _materialize_group summed over the shards,"
                  f" inside execute_all, as is the shuffle); tick ms "
                  f"{json.dumps([round(w, 2) for w in r['walls_ms']])}; after "
                  f"the reshard {json.dumps([round(w, 2) for w in r['after_ms']])}"
                  f"; warm-up ticks "
                  f"{json.dumps([round(w, 2) for w in r['warmup_ms']])}; the "
                  f"run {r['run_s']:.1f} s, {r['check_s']:.1f} s of it the "
                  f"checks; totals {json.dumps(r['totals'])}; launches "
                  f"{json.dumps(r['launches'])}")
    r4 = sh["full"][4]
    print(f"[sharded] (a) 4 shards (2 after the reshard) against 1, tick by "
          f"tick: the produced sIDs of every channel, TweetsAboutCrime3's "
          f"delivered sID multiset and results equal ({sh['full_compared']} "
          f"tick-channel pairs); the param channels' delivered sIDs never "
          f"above their produced count (cumulative, per sID); per-shard "
          f"conservation, each shard's sIDs on their hash shard, routed == "
          f"delivered with each row on its broker's shard, S launches a tick "
          f"of each kernel")
    ring = r4["ring_at_reshard"]
    print(f"[sharded] (b) reshard(2) after the 4-shard engine's timed tick "
          f"{SHARDED['reshard_after']} on {card}: {r4['reshard_s']:.3f} s "
          f"with {ring[0]} pairs and {ring[1]} sIDs in the rings and "
          f"{ring[2]} / {ring[3]} queued; nothing dropped; registry == "
          f"shards' live sIDs on their hash shards; launches in the reshard "
          f"{json.dumps(r4['reshard_launches'])}; in the exact run after "
          f"timed tick {SHARDED['exact_reshard']}: "
          f"{sh['exact'][4]['reshard_s']:.3f} s")
    print(f"[sharded] (a2) 4 shards (2 after the reshard) against 1, tick by "
          f"tick: delivered sID and (row, sID) multisets and produced sIDs "
          f"equal for {sh['exact_compared']} tick-channel pairs")
    sp = sh["sp"]
    print(f"[sharded] (c) sp_decode_attention over 4 slices on {card}: "
          f"B, H, KH, S, D {sp['shape']}, kv_len {sp['kv_len']}; "
          f"{sp['launches']} flash_decode partial launches a call; max abs "
          f"err {json.dumps(sp['errors'])} (tolerance "
          f"{FLASH_TOL[torch.bfloat16]}); {sp['sp_ms']:.4f} ms a call (CUDA "
          f"events; graph {sp['sp_graph_ms']:.4f} ms) against one "
          f"flash_decode call {sp['one_ms']:.4f} ms (graph "
          f"{sp['one_graph_ms']:.4f} ms)")


# ---------------------------------------------------------------------------
# phase 10: the MoE, SSM, hybrid, VLM and encoder-decoder families
# ---------------------------------------------------------------------------


def cut_depth(cfg, depth):
    """``cfg`` with ``depth`` superlayers (all of them when None)."""
    if depth is None or depth >= cfg.superlayer_repeat:
        return cfg
    return dataclasses.replace(cfg, superlayer_repeat=depth,
                               n_layers=depth * len(cfg.block_pattern))


def attention_calls(cfg) -> tuple:
    """(flash_attention launches of one prefill, flash_decode launches of
    one decode step): a decoder's attention blocks; an enc-dec's encoder
    layers plus its decoder's self and cross attention."""
    if cfg.is_encdec:
        return cfg.n_enc_layers + 2 * cfg.superlayer_repeat, \
            2 * cfg.superlayer_repeat
    n = cfg.superlayer_repeat * sum(kind in ("dense", "moe", "shared_attn")
                                    for kind in cfg.block_pattern)
    return n, n


class plain_attention:
    """For a comparison only: ``flash_attention`` and ``flash_decode``'s
    wrappers bound to their plain versions while the block is open (the
    models look the wrappers up at each call), restored after. With
    ``float32``, the attention's plain version runs on float32 copies of
    q, k and v and rounds its output once: the same function with other
    rounding, which measures how far the model carries a rounding step of
    the attention."""

    def __init__(self, float32: bool = False):
        self.float32 = float32

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.flash_decode import ops as fd_ops
        from repro_torch.kernels.flash_decode import ref as fd_ref
        self.saved = [(fa_ops, "flash_attention", fa_ops.flash_attention),
                      (fd_ops, "decode_attention", fd_ops.decode_attention)]
        up = (lambda t: t.float()) if self.float32 else (lambda t: t)
        fa_ops.flash_attention = (
            lambda q, k, v, causal=True, scale=None, **_: fa_ref
            .flash_attention(up(q), up(k), up(v), causal=causal,
                             scale=scale).to(q.dtype))
        fd_ops.decode_attention = fd_ref.decode_attention
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def family_steps(api, params, batch: dict, max_len: int, toks) -> list:
    """Logits of a prefill and of one decode step a column of ``toks``."""
    lg, caches, pos = api.prefill(params, batch, max_len=max_len)
    out = [lg]
    for i in range(toks.shape[1]):
        lg, caches = api.decode(params, caches, pos + i, {"token": toks[:, i]})
        out.append(lg)
    return out


def teacher_forced(api, params, batch: dict, toks) -> torch.Tensor:
    """The forward's logits over the prompt and ``toks`` at the positions
    that a prefill and ``toks.shape[1]`` decode steps score."""
    from repro_torch.models import encdec, lm
    cfg, n = api.cfg, toks.shape[1]
    if cfg.is_encdec:
        tgt = torch.cat([batch["tokens"], toks.to(torch.int32)], 1)
        full = encdec.forward(params, cfg, batch["embeds"], tgt)
    elif "embeds" in batch:
        seq = torch.cat([batch["embeds"].to(cfg.compute_dtype),
                         params["embed"][toks].to(cfg.compute_dtype)], 1)
        full, _ = lm.forward(params, cfg, embeds=seq)
    else:
        seq = torch.cat([batch["tokens"], toks.to(torch.int32)], 1)
        full, _ = lm.forward(params, cfg, tokens=seq)
    return full[:, -(n + 1):, :cfg.vocab_size]


def family_phase(dev, arch: str, shape: dict) -> dict:
    """One family at its published width through ``launch/serve.serve``
    (a short warm-up call, then the measured call with the launch counts
    set to 0 just before it and read just after); then, on seeded inputs,
    a prefill and 3 decode steps with the kernels against the same steps
    with the plain attention versions bound in (``plain_attention``).

    Limits: phase 6's (relative L2 ``DECODE_REL_L2``, max abs
    ``DECODE_MAX_ABS`` a row), or twice the model's rounding floor where
    that is larger: the largest distance between the plain run and the
    same run with the attention in float32 rounded once (two plain
    versions of one function). With random weights, zamba2's 63 residual
    blocks carry one bf16 rounding step of the attention to about 10% of
    the logits (measured on the CPU too), so the floor, not the kernel,
    sets its limit. The MoE families need ``MOE_ROWS_WITHIN`` of the rows
    within phase 6's limits: a row whose expert choice flips differs at
    O(1). For the families without experts, the cached decode against the
    teacher-forced forward at phase 6's limits, both in float32 compute
    (the same weights; the kernels' float32 paths), where rounding does
    not hide a wrong cache position, state or angle (an MoE layer's
    capacity depends on the tokens in the call, so a decode step does not
    route as the forward does)."""
    from repro_torch import configs, tree
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models.model import ModelApi

    full = configs.get_config(arch)
    cfg = cut_depth(full, shape["depth"])
    batch, prompt, gen = shape["batch"], shape["prompt_len"], shape["gen"]
    cuda = dev.type == "cuda"
    api = ModelApi(cfg)
    t = time.perf_counter()
    params = api.init(torch.Generator(dev).manual_seed(SEED))
    sync(dev)
    init_s = time.perf_counter() - t
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree.leaves(params))
    serve(cfg, batch, min(prompt, 64), 2, device=dev, params=params)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    toks, t_pre, t_dec = serve(cfg, batch, prompt, gen, device=dev,
                               params=params)
    launches, shapes = launch_counts(), launch_shapes()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0.0
    per_prefill, per_step = attention_calls(cfg)
    if cuda:
        want = dict.fromkeys(launches, 0)
        want.update(flash_attention=per_prefill,
                    flash_decode=per_step * (gen - 1))
        assert launches == want, (arch, launches, want)
    assert toks.shape == (batch, gen) and (toks >= 0).all() \
        and (toks < cfg.vocab_size).all()
    # kernels against the plain attention versions, step by step
    inputs, _ = serve_inputs(cfg, batch, prompt, gen, dev)
    rng = np.random.default_rng(SEED + 20)
    nxt = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, 3)),
                       device=dev)
    max_len = (4 if cfg.is_encdec else prompt) + 4
    kern = family_steps(api, params, inputs, max_len, nxt)
    with plain_attention():
        plain = family_steps(api, params, inputs, max_len, nxt)
    with plain_attention(float32=True):
        floor_run = family_steps(api, params, inputs, max_len, nxt)

    def row_errors(a, b):
        return [logit_errors(x[i], y[i]) for x, y in zip(a, b)
                for i in range(batch)]

    rows, floor = row_errors(kern, plain), row_errors(floor_run, plain)
    del plain, floor_run
    assert all(torch.isfinite(k.float()).all() for k in kern), arch
    moe = bool(cfg.n_experts)
    limit = (DECODE_REL_L2, DECODE_MAX_ABS)
    if not moe:
        limit = (max(limit[0], 2 * max(r for r, _ in floor)),
                 max(limit[1], 2 * max(m for _, m in floor)))
    within = sum(r <= limit[0] and m <= limit[1] for r, m in rows)
    need = int(np.ceil(MOE_ROWS_WITHIN * len(rows))) if moe else len(rows)
    assert within >= need, (arch, within, len(rows), limit, rows, floor)
    errs = None
    if not moe:
        api32 = ModelApi(dataclasses.replace(cfg,
                                             compute_dtype=torch.float32))
        steps = family_steps(api32, params, inputs, max_len, nxt)
        forced = teacher_forced(api32, params, inputs, nxt)
        errs = [logit_errors(k, forced[:, i]) for i, k in enumerate(steps)]
        del forced, steps
        assert all(r <= DECODE_REL_L2 and m <= DECODE_MAX_ABS
                   for r, m in errs), (arch, errs)
    del kern, params
    if cuda:
        torch.cuda.empty_cache()
    return dict(arch=arch, layers=cfg.superlayer_repeat,
                attention_blocks=per_prefill,
                published_layers=full.superlayer_repeat,
                d_model=cfg.d_model, init_s=init_s,
                weights_gib=weight_bytes / 2 ** 30, prefill_ms=1e3 * t_pre,
                decode_ms_per_token=1e3 * t_dec / max(1, gen - 1),
                peak_gib=peak, launches=launches, shapes=shapes,
                vs_plain_worst=[max(r for r, _ in rows),
                                max(m for _, m in rows)],
                rounding_floor=[max(r for r, _ in floor),
                                max(m for _, m in floor)],
                vs_plain_limit=list(limit),
                vs_plain_within=[within, len(rows)], vs_forward=errs,
                sample=toks[0, :8].tolist(), **shape)


def print_family(f: dict, card: str) -> None:
    cut = ("" if f["layers"] == f["published_layers"] else
           f" (depth cut from {f['published_layers']})")
    inputs = (f"{f['prompt_len']} frames, 4 decoder tokens" if
              f["arch"].startswith("seamless") else
              f"{f['prompt_len']} seeded embeddings" if
              f["arch"].startswith("pixtral") else
              f"prompt {f['prompt_len']} tokens")
    print(f"[families] {f['arch']} on {card}: {f['layers']} superlayers"
          f"{cut}, d_model {f['d_model']}, {f['weights_gib']:.2f} GiB of "
          f"weights drawn in {f['init_s']:.1f} s; batch {f['batch']}, "
          f"{inputs}, {f['gen']} tokens: prefill {f['prefill_ms']:.2f} ms, "
          f"decode {f['decode_ms_per_token']:.3f} ms/token; "
          f"max_memory_allocated {f['peak_gib']:.2f} GiB")
    attn = ("no attention block: 0 launches of either attention kernel, as "
            "expected" if f["attention_blocks"] == 0 else
            f"largest shapes {json.dumps({k: f['shapes'][k] for k in ('flash_attention', 'flash_decode')})}")
    forward = ("not compared: MoE capacity depends on the tokens in a call"
               if f["vs_forward"] is None else
               f"(float32 compute) {json.dumps(f['vs_forward'])}")
    print(f"[families] {f['arch']}: launches {json.dumps(f['launches'])}; "
          f"{attn}; kernels vs plain attention, prefill + 3 steps, "
          f"{f['vs_plain_within'][0]} of {f['vs_plain_within'][1]} rows "
          f"within {json.dumps(f['vs_plain_limit'])} (relative L2, max "
          f"abs), worst {json.dumps(f['vs_plain_worst'])}, rounding floor "
          f"{json.dumps(f['rounding_floor'])}; cached decode vs "
          f"teacher-forced forward {forward}; sample {f['sample']}")


# phase 10's timing cases, kept under their entry's first row by these keys
FAMILY_CASES = ("zamba2_prefill", "seamless_encoder", "seamless_cross",
                "zamba2_decode", "seamless_cross_decode")


def family_timing_cases(fam: dict) -> list:
    """Timed rows at phase 10's new shapes, in ``FAMILY_CASES``' order:
    ``flash_attention`` at zamba2's prefill (D = 80, causal), seamless's
    encoder (non-causal) and cross-attention (4 decoder positions over the
    encoder's frames); ``flash_decode`` at zamba2's last decode step (D =
    80) and seamless's cross step (every frame live)."""
    from repro_torch import configs
    shapes = dict(FAMILIES)
    z, zs = configs.get_config("zamba2-2.7b"), shapes["zamba2-2.7b"]
    e, es = (configs.get_config("seamless-m4t-medium"),
             shapes["seamless-m4t-medium"])
    zh = (zs["batch"], z.n_heads, z.n_kv_heads)
    eh = (es["batch"], e.n_heads, e.n_kv_heads)
    zd, ed, frames = z.resolved_head_dim, e.resolved_head_dim, es["prompt_len"]
    fmt = "B={} H={} KH={} S={} D={}"
    zf, ef = fam["zamba2-2.7b"], fam["seamless-m4t-medium"]
    return [
        ("flash_attention", zf, "phase 10, zamba2-2.7b prefill (D = 80)",
         fmt, case_flash_attention, zh + (zs["prompt_len"], zd)),
        ("flash_attention", ef, "phase 10, seamless-m4t-medium encoder",
         fmt, functools.partial(case_flash_attention, causal=False),
         eh + (frames, ed)),
        ("flash_attention", ef, "phase 10, seamless-m4t-medium "
         "cross-attention", fmt + f" Sk={frames}",
         functools.partial(case_flash_attention, causal=False, sk=frames),
         eh + (4, ed)),
        ("flash_decode", zf, "phase 10, zamba2-2.7b decode (D = 80)", fmt,
         case_flash_decode, zh + (zs["prompt_len"] + zs["gen"], zd)),
        ("flash_decode", ef, "phase 10, seamless-m4t-medium cross decode",
         fmt, functools.partial(case_flash_decode, live=frames),
         eh + (frames, ed)),
    ]


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------


class _GradProbe:
    """The optimizer as the train step sees it, which notes, on the first
    update it passes on, the names of the parameter leaves whose gradient
    is zero everywhere."""

    def __init__(self, optimizer, record):
        self.optimizer, self.record = optimizer, record

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, state, params):
        if self.record.zero_grads is None:
            from repro_torch import tree
            nonzero = torch.stack([g.ne(0).any() for g in
                                   tree.leaves(grads)]).tolist()
            self.record.zero_grads = [
                ".".join(map(str, path)) for (path, _), nz in
                zip(tree.leaves_with_path(grads), nonzero) if not nz]
        return self.optimizer.update(grads, state, params)


class recording_train:
    """While open, ``launch/train.train`` builds its train step through
    ``build`` and its batches through ``batches``: each loop iteration's
    seconds from the batch's build to the step's end (host clock, the
    device synchronised at both ends; the batch's build and copy to the
    device alone in ``batch_s``), loss, grad_norm and kernel launches are
    kept in ``steps``, and the first step's leaves without a gradient in
    ``zero_grads``. A step called without a batch from ``batches`` is timed
    alone."""

    def __init__(self, dev):
        from repro_torch.launch import steps
        from repro_torch.launch import train as train_mod
        self.dev, self.saved = dev, steps.build_train_step
        self.saved_batches = train_mod.make_batch_fn
        self.steps, self.zero_grads, self.batch_t = [], None, None

    def __enter__(self):
        from repro_torch.launch import train as train_mod
        train_mod.build_train_step = self.build
        train_mod.make_batch_fn = self.batches
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train as train_mod
        train_mod.build_train_step = self.saved
        train_mod.make_batch_fn = self.saved_batches

    def batches(self, cfg, batch, seq):
        fn = self.saved_batches(cfg, batch, seq)

        def timed(step):
            sync(self.dev)
            self.batch_t = time.perf_counter()
            return fn(step)
        return timed

    def build(self, api, optimizer=None, accum=None):
        from repro_torch.launch.steps import default_optimizer
        step = self.saved(api, _GradProbe(
            optimizer or default_optimizer(api.cfg), self), accum)

        def timed(params, opt_state, batch):
            sync(self.dev)
            before, t = launch_counts(), time.perf_counter()
            start = t if self.batch_t is None else self.batch_t
            self.batch_t = None
            params, opt_state, metrics = step(params, opt_state, batch)
            sync(self.dev)
            self.steps.append(dict(s=time.perf_counter() - start,
                                   batch_s=t - start,
                                   loss=float(metrics["loss"]),
                                   grad_norm=float(metrics["grad_norm"]),
                                   launches=since(before)))
            return params, opt_state, metrics
        return timed


def train_launches(cfg, accum: int) -> dict:
    """Launches of one train step: ``flash_attention`` twice an attention
    call and microbatch under ``remat`` (the forward, then its recompute in
    the backward; the backward itself is the plain version's), once
    without; nothing else."""
    want = dict.fromkeys(launch_counts(), 0)
    want["flash_attention"] = (accum * attention_calls(cfg)[0]
                               * (2 if cfg.remat else 1))
    return want


def tmp_dirs(root: str) -> list:
    return [d for d in os.listdir(root) if d.endswith(".tmp")]


def train_phase(dev, cfg, shape: dict) -> dict:
    """(a) ``launch/train.train`` at ``cfg``'s width and depth on seeded
    weights (its own ``torch.Generator``): ``shape["steps"]`` steps of
    ``TokenStream`` batches, a checkpoint every ``ckpt_every``; then, in a
    fresh directory, a run that a ``FailureInjector`` stops at step
    ``fail_at`` and a second ``train()`` that resumes from the last
    checkpoint and runs to the end. Checks: finite losses that fall (the
    mean of the last 3 below the first 3's), every parameter leaf with a
    nonzero gradient on step 1, each step's launches exact, the resumed
    losses equal to the uninterrupted run's bit for bit, no
    ``.tmp`` directory left. The checkpoints go to a directory under the
    checkout's ``build/`` and are removed after."""
    import shutil
    from repro_torch.launch.train import train
    from repro_torch.models.model import ModelApi
    from repro_torch.runtime.failure import FailureInjector

    batch, seq, steps = shape["batch"], shape["seq"], shape["steps"]
    every, fail_at = shape["ckpt_every"], shape["fail_at"]
    accum = min(cfg.grad_accum, batch)
    cuda = dev.type == "cuda"
    root = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    run_a, run_b = os.path.join(root, "a"), os.path.join(root, "b")
    kw = dict(steps=steps, batch=batch, seq=seq, ckpt_every=every,
              log_every=every, device=dev)
    try:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t = time.perf_counter()
        with recording_train(dev) as rec:
            params, opt, losses = train(cfg, ckpt_dir=run_a, **kw)
        wall_a = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0.0
        launches, shapes = launch_counts(), launch_shapes()
        from repro_torch import tree
        n_leaves = len(tree.leaves(params))
        del params, opt
        ckpts_a = sorted(os.listdir(run_a))
        assert not tmp_dirs(run_a), os.listdir(run_a)
        shutil.rmtree(run_a)
        t = time.perf_counter()
        with recording_train(dev) as rec_b:
            try:
                train(cfg, ckpt_dir=run_b,
                      injector=FailureInjector(fail_at=(fail_at,)), **kw)
            except RuntimeError as e:
                failure = str(e)
            else:
                raise AssertionError("the injected failure did not stop the "
                                     "run")
            after_failure = sorted(os.listdir(run_b))
            _, _, resumed = train(cfg, ckpt_dir=run_b, **kw)
        wall_b = time.perf_counter() - t
        assert not tmp_dirs(run_b), os.listdir(run_b)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert rec.zero_grads == [], ("leaves without a gradient on step 1 "
                                  "(wq, wk, wv need one through the kernel)",
                                  rec.zero_grads)
    if cuda:
        want = train_launches(cfg, accum)
        for s in rec.steps + rec_b.steps:
            assert s["launches"] == want, (s["launches"], want)
    last = (fail_at // every) * every
    assert after_failure[-1] == f"step_{last:08d}" and not any(
        d.endswith(".tmp") for d in after_failure), after_failure
    assert len(resumed) == steps - last and len(rec_b.steps) == \
        fail_at + steps - last, (resumed, len(rec_b.steps))
    # every leaf is restored bit for bit, so the resumed steps repeat the
    # uninterrupted ones exactly
    assert resumed == losses[last:], (resumed, losses[last:])
    tokens = batch * seq
    timed = [s["s"] for s in rec.steps[1:]]
    step_s = float(np.mean(timed))
    batch_s = float(np.mean([s["batch_s"] for s in rec.steps[1:]]))
    n_params = ModelApi(cfg).active_param_count()
    return dict(arch=cfg.name, layers=cfg.superlayer_repeat,
                d_model=cfg.d_model, params=n_params, accum=accum,
                losses=losses, resumed=resumed,
                grad_norms=[s["grad_norm"] for s in rec.steps],
                step_ms=[1e3 * s["s"] for s in rec.steps],
                step_ms_mean=1e3 * step_s, batch_ms_mean=1e3 * batch_s,
                tokens_per_s=tokens / step_s,
                mfu=6 * n_params * tokens / step_s / BF16_TENSOR_OPS_PER_S,
                hfu=8 * n_params * tokens / step_s / BF16_TENSOR_OPS_PER_S,
                peak_gib=peak, wall_a_s=wall_a, wall_b_s=wall_b,
                launches=launches, shapes=shapes,
                launches_per_step=rec.steps[0]["launches"],
                steps_run=len(rec.steps) + len(rec_b.steps),
                checkpoints=ckpts_a, after_failure=after_failure,
                failure=failure, leaves=n_leaves, **shape)


def train_grad_phase(dev, cfg, shape: dict) -> dict:
    """(b) The loss and every leaf's gradient of one microbatch (seeded
    weights, ``TokenStream`` step 0) with the kernel under autograd
    against the same with the plain attention bound in
    (``plain_attention``). Limit a leaf: relative L2 ``DECODE_REL_L2``, or
    twice the model's rounding floor where that is larger (the distance
    between the plain run and the plain attention in float32 rounded once,
    measured leaf by leaf); the loss the same way."""
    from repro_torch import tree
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.model import ModelApi
    api = ModelApi(cfg)
    params = api.init(torch.Generator(dev).manual_seed(SEED))
    host = make_batch_fn(cfg, shape["micro"], shape["seq"])(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    before = launch_counts()
    loss_k, g_k = value_and_grad(api, params, batch)
    launched = since(before)
    with plain_attention():
        loss_p, g_p = value_and_grad(api, params, batch)
    with plain_attention(float32=True):
        loss_f, g_f = value_and_grad(api, params, batch)
    names = [".".join(map(str, p)) for p, _ in tree.leaves_with_path(params)]
    rows = []
    for name, k, p, f in zip(names, g_k, g_p, g_f):
        err, floor = logit_errors(k, p)[0], logit_errors(f, p)[0]
        rows.append((name, err, floor, max(DECODE_REL_L2, 2 * floor)))
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    loss_floor = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    del g_k, g_p, g_f, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        want = dict.fromkeys(launched, 0)
        want["flash_attention"] = attention_calls(cfg)[0] * (
            2 if cfg.remat else 1)
        assert launched == want, (launched, want)
    bad = [r for r in rows if not r[1] <= r[3]]
    assert not bad, bad
    assert loss_err <= max(DECODE_REL_L2, 2 * loss_floor), (loss_err,
                                                            loss_floor)
    assert all(r[1] > 0 or r[2] == 0 for r in rows if "attn" in r[0]), rows
    worst = max(rows, key=lambda r: r[1])
    return dict(layers=cfg.superlayer_repeat, leaves=len(rows),
                loss=float(loss_k), loss_plain=float(loss_p),
                loss_err=loss_err, loss_floor=loss_floor,
                worst=list(worst), worst_floor=max(r[2] for r in rows),
                attn={r[0]: [r[1], r[2]] for r in rows
                      if r[0].endswith(("wq", "wk", "wv")) and ".0." in r[0]},
                launches=launched, **shape)


def train_step_phase(dev, arch: str, shape: dict) -> dict:
    """(c) Two train steps of another family at its published width (depth
    cut by ``shape["depth"]``): its config's optimizer and accumulation,
    ``make_batch_fn``'s batches; the first step is cold (allocator growth,
    library handles), the second is the one timed (the step alone: the
    batches are built and copied beforehand). Checks: finite losses;
    after step 1 exactly the leaves with no gradient keep their values
    (pixtral's token table, which the ``embed`` frontend never reads, is
    the only one allowed none); the launches of each step exact."""
    from repro_torch import configs, tree
    from repro_torch.launch.steps import default_optimizer
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.model import ModelApi
    full = configs.get_config(arch)
    cfg = cut_depth(full, shape["depth"])
    cuda = dev.type == "cuda"
    api = ModelApi(cfg)
    params = api.init(torch.Generator(dev).manual_seed(SEED))
    opt = default_optimizer(cfg)
    state = opt.init(params)
    accum = min(cfg.grad_accum, shape["batch"])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                make_batch_fn(cfg, shape["batch"], shape["seq"])(i).items()}
               for i in range(2)]
    before = [p.clone() for p in tree.leaves(params)]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    rec = recording_train(dev)
    step_fn = rec.build(api, opt, accum)
    params, state, _ = step_fn(params, state, batches[0])
    names = [".".join(map(str, p)) for p, _ in tree.leaves_with_path(params)]
    still = [n for n, a, b in zip(names, before, tree.leaves(params))
             if torch.equal(a, b)]
    del before
    params, state, _ = step_fn(params, state, batches[1])
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else 0.0
    del params, state, batches
    if cuda:
        torch.cuda.empty_cache()
        for s in rec.steps:
            assert s["launches"] == train_launches(cfg, accum), s["launches"]
    step = rec.steps[1]
    assert all(np.isfinite(s["loss"]) for s in rec.steps), rec.steps
    assert still == rec.zero_grads, (still, rec.zero_grads)
    allowed = ["embed"] if cfg.frontend == "embed" and not cfg.is_encdec \
        else []
    assert rec.zero_grads == allowed, rec.zero_grads
    return dict(arch=arch, layers=cfg.superlayer_repeat,
                published_layers=full.superlayer_repeat,
                enc_layers=cfg.n_enc_layers, optimizer=type(opt).__name__,
                accum=accum, params=api.param_count(),
                losses=[s["loss"] for s in rec.steps],
                grad_norm=rec.steps[0]["grad_norm"],
                cold_ms=1e3 * rec.steps[0]["s"], step_ms=1e3 * step["s"],
                unmoved=still, leaves=len(names), peak_gib=peak,
                launches=step["launches"], **shape)


def training_phase(dev) -> dict:
    """Phase 11: (a), (b) and (c), printed; returns (a)'s result for the
    kernel line."""
    from repro_torch import configs
    card = card_line()
    t0 = time.perf_counter()
    cfg = configs.get_config(TRAIN_ARCH)
    tr = train_phase(dev, cfg, TRAIN)
    print(f"[train] {tr['arch']} on {card}: {tr['layers']} layers, d_model "
          f"{tr['d_model']}, {tr['params']:,} parameters, "
          f"{str(cfg.param_dtype).split('.')[-1]}, {cfg.optimizer}, remat "
          f"{cfg.remat}; batch {tr['batch']} x seq {tr['seq']}, accum "
          f"{tr['accum']}: {tr['steps']} steps, step ms (the batch's "
          f"build and copy included) "
          f"{json.dumps([round(x, 1) for x in tr['step_ms']])}; mean of "
          f"steps 2-{tr['steps']} {tr['step_ms_mean']:.1f} ms (the batch "
          f"{tr['batch_ms_mean']:.1f} ms of it), "
          f"{tr['tokens_per_s']:.0f} tokens/s, MFU (6 N D) "
          f"{100 * tr['mfu']:.1f}%, with the remat recompute (8 N D) "
          f"{100 * tr['hfu']:.1f}% of 989 TFLOP/s; max_memory_allocated "
          f"{tr['peak_gib']:.2f} GiB")
    print(f"[train] loss {tr['losses'][0]:.4f} -> {tr['losses'][-1]:.4f} "
          f"({json.dumps([round(x, 4) for x in tr['losses']])}); grad_norm "
          f"{json.dumps([round(x, 4) for x in tr['grad_norms']])}; every "
          f"parameter leaf with a nonzero gradient on step 1 (wq, wk, wv "
          f"included); launches a step {json.dumps(tr['launches_per_step'])}"
          f"; largest shapes {json.dumps(tr['shapes']['flash_attention'])}")
    print(f"[train] checkpoints every {tr['ckpt_every']}: {tr['checkpoints']}"
          f" in {tr['wall_a_s']:.1f} s; restart: '{tr['failure']}', left "
          f"{tr['after_failure']}, resumed losses "
          f"{json.dumps([round(x, 4) for x in tr['resumed']])}, "
          f"bit-equal to the uninterrupted run's; {tr['steps_run']} steps "
          f"in all, the "
          f"restart in {tr['wall_b_s']:.1f} s; no .tmp left")
    cut = cut_depth(cfg, TRAIN_GRAD["depth"])
    gp = train_grad_phase(dev, cut, TRAIN_GRAD)
    print(f"[train] gradient through the kernel, {cfg.name} cut to "
          f"{gp['layers']} layers, one microbatch ({gp['micro']} x "
          f"{gp['seq']}): loss {gp['loss']:.6f} against {gp['loss_plain']:.6f}"
          f" with the plain attention (relative {gp['loss_err']:.3g}, floor "
          f"{gp['loss_floor']:.3g}); all {gp['leaves']} leaves within "
          f"max({DECODE_REL_L2}, 2 x floor) relative L2, worst "
          f"{json.dumps(gp['worst'])} (name, error, floor, limit); layer 0 "
          f"wq, wk, wv (error, floor) {json.dumps(gp['attn'])}; launches "
          f"{json.dumps(gp['launches'])}")
    others = {}
    for arch, shape in TRAIN_OTHERS:
        o = train_step_phase(dev, arch, shape)
        others[arch] = o
        cut = ("" if o["layers"] == o["published_layers"] else
               f" (depth cut from {o['published_layers']})")
        print(f"[train] {arch} on {card}: {o['layers']} layers{cut}, "
              f"{o['params']:,} parameters, {o['optimizer']}, batch "
              f"{o['batch']}, seq {o['seq']}, accum {o['accum']}: step 2 "
              f"{o['step_ms']:.1f} ms (step 1, cold, {o['cold_ms']:.1f} ms), "
              f"losses {json.dumps([round(x, 4) for x in o['losses']])}, "
              f"step 1 grad_norm {o['grad_norm']:.4f}; "
              f"{o['leaves'] - len(o['unmoved'])} of "
              f"{o['leaves']} leaves moved by step 1 (unmoved, without a "
              f"gradient: "
              f"{o['unmoved']}); launches {json.dumps(o['launches'])}; "
              f"max_memory_allocated {o['peak_gib']:.2f} GiB")
    print(f"[train] phase 11 in {time.perf_counter() - t0:.1f} s")
    return dict(tr, grad=gp, others=others)


# ---------------------------------------------------------------------------
# phase 12: the mesh, the partition specs, the pipeline and the compression
# ---------------------------------------------------------------------------


def spec_bytes_phase() -> list:
    """(a) Per-device bytes under the sanitized spec trees over both
    production meshes (``meta`` devices, host arithmetic): each arch id's
    parameters, its default optimizer's state and, for each shape it
    supports, its serving caches."""
    from repro_torch import configs, tree
    from repro_torch.distributed import param_specs as psp
    from repro_torch.distributed.partition import device_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import default_optimizer
    from repro_torch.models.model import SHAPES, ModelApi

    meshes = [make_production_mesh(multi_pod=m) for m in (False, True)]
    rows = []
    for arch in configs.ARCH_IDS:
        api = ModelApi(configs.get_config(arch))
        params, specs = api.abstract_params(), api.param_pspecs()
        opt = default_optimizer(api.cfg)
        trees = {"params": (params, specs),
                 "state": (opt.init(params), opt.state_pspecs(specs))}
        trees.update({name: (api.layer_cache_shapes(name),
                             api.cache_pspecs(name))
                      for name in SHAPES if api.supports(name)})
        for mesh in meshes:
            got = {k: device_bytes(tree.leaves(x), tree.leaves(sp), mesh)
                   for k, (x, sp) in trees.items()}
            rows.append(dict(
                arch=arch, mesh="x".join(map(str, mesh.shape.values())),
                params=got.pop("params"), state=got.pop("state"),
                caches=got))
    return rows


def restore_phase(dev, cfg, grid) -> dict:
    """(b) ``cfg``'s parameters (from the seed) and AdamW state (its
    moments filled from the seed, m normal and v its square, so that no
    leaf is zeros) saved, then restored with ``param_pspecs`` /
    ``state_pspecs`` shardings over a ``grid`` ("data", "model") mesh whose
    positions are all ``dev``: every gathered leaf bit-equal to the saved
    one, every 2-d leaf in as many distinct blocks as the grid has
    positions. Under the checkout's ``build/``, removed after."""
    import shutil
    from repro_torch import tree
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.distributed.partition import NamedSharding, sanitize_spec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import ModelApi
    from repro_torch.optim import make_optimizer

    api = ModelApi(cfg)
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    params = api.init(gen)
    opt = make_optimizer("adamw")
    state = opt.init(params)
    for m, v in zip(tree.leaves(state.m), tree.leaves(state.v)):
        m.normal_(generator=gen).mul_(1e-3)
        torch.mul(m, m, out=v)
    state.count.fill_(7)
    saved = {"params": params, "opt": state}
    root = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    mesh = make_mesh(grid, ("data", "model"), dev)
    specs = {"params": api.param_pspecs(),
             "opt": opt.state_pspecs(api.param_pspecs())}
    shardings = tree.tree_map(
        lambda spec, x: NamedSharding(mesh, sanitize_spec(spec, x.shape,
                                                          mesh)),
        specs, saved)
    try:
        mgr = CheckpointManager(root, async_save=False)
        sync(dev)
        t = time.perf_counter()
        mgr.save(1, saved)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        got = mgr.restore(1, saved, shardings=shardings)
        sync(dev)
        restore_s = time.perf_counter() - t
        on_disk = sum(os.path.getsize(os.path.join(root, "step_00000001", f))
                      for f in os.listdir(os.path.join(root,
                                                       "step_00000001")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    blocks = largest = cut = 0
    for st, want in zip(tree.leaves(got), tree.leaves(saved)):
        distinct = {b.data_ptr(): b for b in st.blocks.values()}
        assert all(b.device == dev for b in distinct.values())
        blocks += len(distinct)
        largest = max(largest, *(b.numel() * b.element_size()
                                 for b in distinct.values()))
        if want.dim() == 2:
            assert len(distinct) == mesh.size, (st.sharding.spec, want.shape)
            cut += 1
        g = st.gather()
        bits = torch.int16 if g.dtype == torch.bfloat16 else g.dtype
        assert g.dtype == want.dtype and torch.equal(g.view(bits),
                                                     want.view(bits))
    n = len(tree.leaves(saved))
    del got, saved, params, state
    return dict(grid=list(grid), leaves=n, cut=cut, blocks=blocks,
                largest_block=largest, bytes=on_disk, save_s=save_s,
                restore_s=restore_s)


def pipeline_phase(dev, cfg, shape: dict) -> dict:
    """(c) ``cfg``'s superlayers (from the seed) stacked into S stages of
    depth / S each, for each S in ``shape["stages"]``, all on ``dev``;
    ``stage_fn`` applies a stage's superlayers with ``superlayer_train``
    under ``torch.no_grad()``; ``shape["micro"]`` microbatches of
    (batch, seq, d_model) hidden states from the seed, in the compute
    dtype. Each run's output bit-equal to the 28 superlayers applied to
    each microbatch in turn (the same kernels on the same shapes in the
    same order); the launch counts set to 0 just before each S's first
    pipelined run and read just after, with the largest shape each kernel
    was launched at (``launches`` and ``shapes`` of the first S, for the
    timed row). Each forward is timed ``REPEATS`` times."""
    from repro_torch import tree
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipeline_forward)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import blocks
    from repro_torch.models.layers import rope_frequencies
    from repro_torch.models.model import ModelApi

    depth, m = cfg.superlayer_repeat, shape["micro"]
    gen = torch.Generator(dev).manual_seed(SEED + 13)
    layers = ModelApi(cfg).init(gen)["layers"]
    xs = torch.randn((m, shape["batch"], shape["seq"], cfg.d_model),
                     generator=gen, device=dev).to(cfg.compute_dtype)
    cos, sin = rope_frequencies(cfg.resolved_head_dim, shape["seq"],
                                cfg.rope_theta, dev)

    def apply(layer_list, x):
        for p in layer_list:
            x, _ = blocks.superlayer_train(p, None, x, cfg, cos, sin)
        return x

    def stage_fn(stage_params, x):
        k = tree.leaves(stage_params)[0].shape[0]
        return apply([tree.tree_map(lambda a, j=j: a[j], stage_params)
                      for j in range(k)], x)

    with torch.no_grad():
        apply(layers[:1], xs[0])                        # warm-up
        seq_ms = []
        for _ in range(REPEATS):
            sync(dev)
            t = time.perf_counter()
            want = torch.stack([apply(layers, xs[i]) for i in range(m)])
            sync(dev)
            seq_ms.append(1e3 * (time.perf_counter() - t))
        runs = {}
        for s in shape["stages"]:
            stacked = tree.tree_map(
                lambda *ls, s=s: torch.stack(ls).unflatten(0, (s, depth // s)),
                *layers)
            run = pipeline_forward(make_mesh((s,), ("pod",), dev), "pod",
                                   stage_fn, m)
            ms = []
            for rep in range(REPEATS):
                sync(dev)
                if rep == 0:
                    reset_launch_counts()
                t = time.perf_counter()
                out = run(stacked, xs)
                sync(dev)
                ms.append(1e3 * (time.perf_counter() - t))
                if rep == 0:
                    launches, shapes = launch_counts(), launch_shapes()
            del stacked
            bits = torch.int16 if out.dtype == torch.bfloat16 else out.dtype
            equal = torch.equal(out.view(bits), want.view(bits))
            err = max_abs_err(out, want)
            assert equal, (s, err)
            assert torch.isfinite(out.float()).all()
            if dev.type == "cuda":
                assert launches["flash_attention"] == depth * m, launches
                assert sum(launches.values()) == depth * m, launches
            runs[s] = dict(ms=ms, launches=launches["flash_attention"],
                           shape=shapes["flash_attention"],
                           bubble=bubble_fraction(s, m), equal=equal)
    # every stage count launches the kernel at one shape: the timed row's
    first = runs[shape["stages"][0]]
    assert all(r["shape"] == first["shape"] for r in runs.values()), runs
    return dict(seq_ms=seq_ms, runs=runs, depth=depth,
                launches={"flash_attention": first["launches"]},
                shapes={"flash_attention": first["shape"]}, **shape)


def compression_phase(dev, cfg, pods) -> dict:
    """(d) A float32 tree shaped like ``cfg``'s parameters, N(0, 1e-3)
    from the seed, through ``compressed_psum_tree`` with zero residuals
    over a ("pod",) axis of n positions, all on ``dev``, for each n in
    ``pods``, ``REPEATS`` times each (the first also pays the caching
    allocator's growth). The embedding leaf and layer 0's leaves against
    the port's CPU result (the CPU at n positions for layer 0, at 1 for
    the embedding: for n a power of two the mean's arithmetic is exact, so
    every n gives the same bits): 0 elements off, output and residual.
    Every leaf: the error-feedback identity, new residual == target -
    dequantize(q, scale) up to the product's and the FMA's roundings
    (float64, |r + out - x| <= 2^-24 (|r| + |out|)), and each residual
    within half a quantization step (max|x| / 127 / 2, up to the rounding
    of the float32 quotient x / scale)."""
    from repro_torch import tree
    from repro_torch.distributed.compression import (compressed_psum_tree,
                                                     init_residuals)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import ModelApi

    cpu = torch.device("cpu")
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    shapes = ModelApi(cfg).abstract_params()
    grads = tree.tree_map(
        lambda p: torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3),
        shapes)
    residuals = init_residuals(grads)
    flat = tree.leaves(grads)
    numel = sum(x.numel() for x in flat)
    checked = {"embed": grads["embed"]}
    checked.update({f"layers.0.{'.'.join(map(str, p))}": x for p, x in
                    tree.leaves_with_path(grads["layers"][0])})
    host = {k: x.to(cpu) for k, x in checked.items()}
    embed_cpu = compressed_psum_tree(
        {"embed": host["embed"]},
        {"embed": torch.zeros_like(host["embed"])},
        make_mesh((1,), ("pod",), cpu), "pod")
    runs = {}
    for n in pods:
        mesh = make_mesh((n,), ("pod",), dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for rep in range(REPEATS):
            if rep:
                del out, new_r
            sync(dev)
            t = time.perf_counter()
            out, new_r = compressed_psum_tree(grads, residuals, mesh, "pod")
            sync(dev)
            ms.append(1e3 * (time.perf_counter() - t))
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else 0.0)
        layer0 = {k: v for k, v in host.items() if k != "embed"}
        cpu_out, cpu_r = compressed_psum_tree(
            layer0, {k: torch.zeros_like(v) for k, v in layer0.items()},
            make_mesh((n,), ("pod",), cpu), "pod")
        cpu_out["embed"], cpu_r["embed"] = (embed_cpu[0]["embed"],
                                            embed_cpu[1]["embed"])
        got_out = {"embed": out["embed"]}
        got_r = {"embed": new_r["embed"]}
        for p, x in tree.leaves_with_path(out["layers"][0]):
            got_out[f"layers.0.{'.'.join(map(str, p))}"] = x
        for p, x in tree.leaves_with_path(new_r["layers"][0]):
            got_r[f"layers.0.{'.'.join(map(str, p))}"] = x
        off = sum(int((got_out[k].cpu().view(torch.int32)
                       != cpu_out[k].view(torch.int32)).sum())
                  + int((got_r[k].cpu().view(torch.int32)
                         != cpu_r[k].view(torch.int32)).sum())
                  for k in checked)
        assert off == 0, (n, off)
        worst = 0.0
        for x, o, r in zip(flat, tree.leaves(out), tree.leaves(new_r)):
            x64, o64, r64 = x.double(), o.double(), r.double()
            excess = ((r64 + o64 - x64).abs()
                      - 2.0 ** -24 * (r64.abs() + o64.abs())).max()
            worst = max(worst, float(excess))
            # half a step, and the float32 quotient's rounding (<= 127.5
            # in magnitude: half an ulp of 2^-17 relative) at the boundary
            half = float(x.abs().max()) / 127 / 2
            assert float(r.abs().max()) <= half * (1 + 2 ** -14), n
        assert worst <= 0.0, (n, worst)
        del out, new_r
        runs[n] = dict(ms=ms, peak_gib=peak, off=off,
                       int8_bytes=n * numel + 4 * n * len(flat),
                       f32_bytes=4 * n * numel)
    return dict(numel=numel, bytes=4 * numel, leaves=len(flat),
                checked=len(checked), runs=runs)


SELECTIVITY = [("about_country", "==", 0), ("retweet_count", ">", 10000),
               ("hate_speech_rate", ">", 5), ("threatening_rate", ">", 5),
               ("weapon_mentioned", "==", 1)]


def selectivity_phase(dev, rows: int) -> dict:
    """(e) ``selectivity`` of each of the reference substrate test's five
    conditions over ``rows`` seeded tweets on ``dev`` equals the CPU's."""
    from repro_torch.core import predicates as P
    from repro_torch.core import records as R
    from repro_torch.data.synthetic import tweet_arrays

    fields, _ = tweet_arrays(np.random.default_rng(SEED + 15), rows, 0)
    on_dev = torch.from_numpy(fields).to(dev)
    out = {}
    for name, op, value in SELECTIVITY:
        preds = [P.Predicate.parse(
            R.ENRICHED_TWEET_SCHEMA.index(name), op, value)]
        got = P.selectivity(on_dev, preds)
        want = P.selectivity(fields, preds, device="cpu")
        assert got == want, (name, got, want)
        out[f"{name} {op} {value}"] = got
    return out


def mesh_phase(dev, cfg, shape: dict) -> dict:
    """Phase 12: (a)-(e), printed; returns (c)'s result for the kernel
    line."""
    card = card_line()
    t0 = time.perf_counter()
    t = time.perf_counter()
    rows = spec_bytes_phase()
    for r in rows:
        print(f"[mesh] (a) {r['arch']} over {r['mesh']} (meta): bytes per "
              f"device: parameters {r['params']:,}, optimizer state "
              f"{r['state']:,}, caches {json.dumps(r['caches'])}")
    print(f"[mesh] (a) {len(rows)} spec trees in "
          f"{time.perf_counter() - t:.1f} s (host arithmetic)")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rs = restore_phase(dev, cfg, shape["grid"])
    print(f"[mesh] (b) {cfg.name} parameters and AdamW state on {card}: "
          f"{rs['leaves']} leaves, {rs['bytes'] / 1e9:.2f} GB saved in "
          f"{rs['save_s']:.1f} s, restored onto a {rs['grid']} "
          f"('data', 'model') mesh of {dev} x {math.prod(rs['grid'])} in "
          f"{rs['restore_s']:.1f} s: {rs['blocks']} blocks, {rs['cut']} "
          f"2-d leaves each in {math.prod(rs['grid'])}, largest block "
          f"{rs['largest_block']:,} B; every gathered leaf bit-equal")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pp = pipeline_phase(dev, cfg, shape["pipeline"])
    for s, r in pp["runs"].items():
        print(f"[pipeline] {cfg.name} on {card}: {pp['depth']} layers in "
              f"{s} stages on {dev}, {pp['micro']} microbatches of "
              f"({pp['batch']}, {pp['seq']}, {cfg.d_model}): "
              f"{json.dumps([round(x, 2) for x in r['ms']])} ms "
              f"(sequential {json.dumps([round(x, 2) for x in pp['seq_ms']])}"
              f" ms); "
              f"bubble_fraction {r['bubble']:.4f}; flash_attention launches "
              f"{r['launches']}; output bit-equal to the sequential "
              f"application: {r['equal']}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cp = compression_phase(dev, cfg, shape["pods"])
    for n, r in cp["runs"].items():
        print(f"[compress] {cfg.name}-shaped float32 tree on {card}: "
              f"{cp['numel']:,} entries ({cp['bytes'] / 1e9:.2f} GB, "
              f"{cp['leaves']} leaves), ('pod',) axis of {n} on {dev}: "
              f"{json.dumps([round(x, 2) for x in r['ms']])} ms, "
              f"max_memory_allocated "
              f"{r['peak_gib']:.2f} GiB; bytes moved int8 "
              f"{r['int8_bytes']:,} against float32 {r['f32_bytes']:,}; "
              f"{cp['checked']} leaves against the CPU, {r['off']} "
              f"elements off; every leaf's error-feedback identity held")
    sel = selectivity_phase(dev, shape["selectivity_rows"])
    print(f"[mesh] (e) selectivity over {shape['selectivity_rows']:,} "
          f"tweets on {dev}, equal to the CPU's: {json.dumps(sel)}")
    print(f"[mesh] phase 12 in {time.perf_counter() - t0:.1f} s")
    return pp


# ---------------------------------------------------------------------------
# phase 13: the dry run
# ---------------------------------------------------------------------------


def dryrun_cells(arch: str, shape: str, out_dir: str) -> list:
    """Both meshes' cells of (arch, shape) through ``run_cell`` in this
    process on ``meta`` (the second mesh reuses the first's counts where
    its microbatch is the same), each record written under ``out_dir``; a
    cell is skipped exactly where ``ModelApi.supports`` is false. Returns a
    row a cell."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.model import ModelApi

    supported = ModelApi(configs.get_config(arch)).supports(shape)
    rows = []
    for multi_pod in (False, True):
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod)
        wall = time.perf_counter() - t
        with open(os.path.join(out_dir, f"{arch}__{shape}__{rec['mesh']}"
                               f".json"), "w") as f:
            json.dump(rec, f, indent=2)
        assert (rec["status"] == "skipped") == (not supported), \
            (arch, shape, rec["status"])
        row = dict(arch=arch, shape=shape, mesh=rec["mesh"],
                   status=rec["status"], wall_s=wall, pid=os.getpid())
        if rec["status"] == "ok":
            assert rec["totals"]["flops_global"] > 0, rec
            row.update(flops_global=rec["totals"]["flops_global"],
                       flops=rec["totals"]["flops"],
                       argument_bytes=rec["full"]["memory"]["argument_bytes"],
                       grad_accum=rec["grad_accum"])
        rows.append(row)
    return rows


def start_dryrun_workers(out_dir: str):
    """Phase 13 (a)'s slowest cells (``DRYRUN_EARLY``), each in a worker
    process started now at the lowest CPU priority: (pool, {cell:
    result})."""
    import multiprocessing
    os.makedirs(out_dir, exist_ok=True)
    pool = multiprocessing.get_context("spawn").Pool(len(DRYRUN_EARLY),
                                                     initializer=os.nice,
                                                     initargs=(19,))
    return pool, {cell: pool.apply_async(dryrun_cells, (*cell, out_dir))
                  for cell in DRYRUN_EARLY}


def dryrun_matrix(out_dir: str, early: dict) -> dict:
    """(a) Every (arch x shape x mesh) cell: the cells of ``early`` from
    their workers, every other one in this process."""
    from repro_torch.launch import dryrun_all

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    rows = []
    for arch in dryrun_all.ARCHS:
        for shape in dryrun_all.SHAPES:
            if (arch, shape) in early:
                rows += early[(arch, shape)].get()
            else:
                rows += dryrun_cells(arch, shape, out_dir)
    return dict(rows=rows, wall_s=time.perf_counter() - t0)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w))


def probe_inputs(dev, cfg, kind: str, shape: dict, rng) -> tuple:
    """The probe's layer (seeded, on ``dev``; shapes only on ``meta``) and
    its other arguments, seeded from ``rng``."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import rope_frequencies

    meta = dev.type == "meta"
    layer = blocks.superlayer_init(
        cfg, None if meta else torch.Generator(dev).manual_seed(SEED), dev)

    def normal(*sh):
        if meta:
            return torch.empty(sh, dtype=cfg.compute_dtype, device=dev)
        return torch.tensor(rng.normal(size=sh).astype(np.float32),
                            device=dev).to(cfg.compute_dtype)

    hd, b = cfg.resolved_head_dim, shape["batch"]
    if kind == "train":
        cos, sin = rope_frequencies(hd, shape["seq"], cfg.rope_theta, dev)
        return layer, (normal(b, shape["seq"], cfg.d_model), cos, sin)
    cache = {"b0": {"k": normal(b, cfg.n_kv_heads, shape["cache"], hd),
                    "v": normal(b, cfg.n_kv_heads, shape["cache"], hd)}}
    pos = shape["live"] - 1
    cos, sin = rope_frequencies(hd, shape["cache"], cfg.rope_theta, dev)
    kv_len = torch.full((b,), shape["live"], dtype=torch.int32, device=dev)
    return layer, (normal(b, cfg.d_model), cache, cos, sin, pos, kv_len)


def run_probe(api, kind: str, layer, args):
    """The train probe's gradients or the decode probe's (output, states);
    the decode probe writes its cache in place."""
    from repro_torch.launch import probes
    if kind == "train":
        return probes.train_body_fn(api)(layer, None, *args)
    return probes.decode_body_fn(api)(layer, None, *args)


def clone_args(kind: str, args):
    """A decode probe's arguments with its cache copied (the probe writes
    it); the train probe reads its arguments only."""
    if kind == "train":
        return args
    x, cache, *rest = args
    return (x, {b: {k: v.clone() for k, v in c.items()}
                for b, c in cache.items()}, *rest)


def probe_phase(dev, cfg, shapes: dict) -> dict:
    """(b) The train and decode probes of ``cfg``'s layer on the card:
    time, count on ``meta``, peak memory, launches, and the kernels against
    the plain attention bound in (``plain_attention``)."""
    from repro_torch import tree
    from repro_torch.models.model import ModelApi
    from torch.utils.flop_counter import FlopCounterMode

    api = ModelApi(cfg)
    rng = np.random.default_rng(SEED + 13)
    out = {}
    for kind in ("train", "decode"):
        shape = shapes[kind]
        with FlopCounterMode(display=False) as counter:
            run_probe(api, kind, *probe_inputs(torch.device("meta"), cfg,
                                               kind, shape, rng))
        flops = int(counter.get_total_flops())
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        layer, args = probe_inputs(dev, cfg, kind, shape, rng)
        arg_bytes = sum(t.numel() * t.element_size()
                        for t in tree.leaves((layer, args))
                        if isinstance(t, torch.Tensor))
        sync(dev)
        reset_launch_counts()
        got = run_probe(api, kind, layer, clone_args(kind, args))
        sync(dev)
        launches = launch_counts()
        peak = (torch.cuda.max_memory_allocated(dev) - base
                if dev.type == "cuda" else 0)
        if dev.type == "cuda":
            want = dict.fromkeys(launches, 0)
            want["flash_attention" if kind == "train" else
                 "flash_decode"] = 2 if kind == "train" else 1
            assert launches == want, (kind, launches, want)
            ms = [cuda_ms(lambda: run_probe(api, kind, layer, args), 1,
                          warmup=1 if i == 0 else 0)
                  for i in range(shape["repeats"])]
        else:
            ms = [float("nan")]
        with plain_attention():
            plain = run_probe(api, kind, layer, clone_args(kind, args))
        if kind == "train":
            with plain_attention(float32=True):
                floor_run = run_probe(api, kind, layer, clone_args(kind,
                                                                   args))
            rows = [(rel_l2(g, p), rel_l2(f, p)) for g, p, f in zip(
                tree.leaves(got), tree.leaves(plain), tree.leaves(floor_run))]
            bad = [r for r in rows if not r[0] <= max(DECODE_REL_L2,
                                                      2 * r[1])]
            assert not bad, bad
            worst = max(r[0] for r in rows)
            check = dict(leaves=len(rows), worst_rel_l2=worst,
                         worst_floor=max(r[1] for r in rows))
            del floor_run
        else:
            err, abs_err = logit_errors(got[0], plain[0])
            assert err <= DECODE_REL_L2 and abs_err <= DECODE_MAX_ABS, \
                (err, abs_err)
            cache_err = max(rel_l2(g, p) for g, p in zip(
                tree.leaves(got[1]), tree.leaves(plain[1])))
            assert cache_err == 0.0, cache_err
            check = dict(rel_l2=err, max_abs=abs_err, cache_rel_l2=cache_err)
        del got, plain
        best = min(ms)
        out[kind] = dict(shape=shape, ms=ms, flops=flops,
                         share=flops / (best / 1e3) / BF16_TENSOR_OPS_PER_S,
                         peak_bytes=peak, arg_bytes=arg_bytes,
                         launches={k: v for k, v in launches.items() if v},
                         check=check, attn_shape=launch_shapes())
        del layer, args
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def dryrun_phase(dev, cfg, shapes: dict, out_dir: str,
                 early: dict) -> dict:
    """Phase 13: (a) and (b), printed; returns (b) for the kernel lines."""
    card = card_line()
    t0 = time.perf_counter()
    mat = dryrun_matrix(out_dir, early)
    for r in mat["rows"]:
        where = ("a worker process started with phase 11"
                 if r["pid"] != os.getpid() else "this process")
        head = (f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: "
                if r["status"] == "ok" else
                f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: skipped "
                f"(ModelApi.supports is false); ")
        body = ("" if r["status"] != "ok" else
                f"ok, flops_global {r['flops_global']:.4e}, flops/dev "
                f"{r['flops']:.4e} (even split), argument_bytes/dev "
                f"{r['argument_bytes'] / 2**30:.4f} GiB, grad_accum "
                f"{r['grad_accum']}; ")
        print(f"{head}{body}{r['wall_s']:.2f} s on the host (meta, {where})")
    slow = max(mat["rows"], key=lambda r: r["wall_s"])
    print(f"[dryrun] (a) {len(mat['rows'])} cells, "
          f"{sum(r['status'] == 'ok' for r in mat['rows'])} ok, in "
          f"{mat['wall_s']:.1f} s of this phase, "
          f"{sum(r['wall_s'] for r in mat['rows']):.1f} s of cells in all "
          f"(slowest {slow['arch']} x {slow['shape']} x {slow['mesh']}, "
          f"{slow['wall_s']:.1f} s); records under {out_dir}")
    pr = probe_phase(dev, cfg, shapes)
    for kind, r in pr.items():
        what = ("train probe (grad through one superlayer, remat)"
                if kind == "train" else "decode probe")
        print(f"[dryrun] (b) {cfg.name} {what} on {card}, "
              f"{json.dumps(r['shape'])}: "
              f"{json.dumps([round(x, 3) for x in r['ms']])} ms (CUDA "
              f"events); FlopCounterMode on meta {r['flops']:.4e} FLOPs (the "
              f"reference's count, masked causal work included), "
              f"{100 * r['share']:.2f}% of 989 TFLOP/s at the best time; "
              f"peak memory {r['peak_bytes'] / 2**30:.3f} GiB, its "
              f"arguments {r['arg_bytes'] / 2**30:.3f} GiB of it; launches "
              f"{json.dumps(r['launches'])}; against the plain attention "
              f"{json.dumps(r['check'])}")
    print(f"[dryrun] phase 13 in {time.perf_counter() - t0:.1f} s")
    return pr


MAIN = dict(dataset_capacity=1 << 21, index_capacity=1 << 20,
            max_window=1 << 16, max_candidates=1 << 14,
            max_deliver_pairs=1 << 14, max_notify=1 << 22,
            drug_subs=1_000_000, threat_subs=200_000, users=10_000,
            ticks=40, tick_rows=65536, spatial_check_ticks=(0, 39))
# join_compact's four (S, maxT) output grids: S = 8,192 (about 4,800 live
# candidates over six channels), maxT = 16,384 (the top state holds about
# 11,900 of 100,000 flat subscriptions): 13 B x 134M entries = 1.74 GB
COMPACT = dict(channels=6, subs=100_000, tick_rows=28672, ticks=3,
               match=0.02, dataset_capacity=1 << 18, index_capacity=1 << 15,
               max_candidates=1 << 12)
PLANS = dict(dataset_capacity=1 << 18, index_capacity=1 << 16,
             max_window=1 << 14, max_candidates=1 << 14,
             drug_subs=50_000, users=10_000, ticks=2, tick_rows=8192)
# the serve phase's shape, and the enriched tick: the main engine for four
# ticks (the first one warms the libraries up), the rank rule checked on the
# second
SERVE = dict(batch=8, prompt_len=512, gen=32)
LONG_CACHE = 32768      # keys of flash_decode's long-cache timing case
ENRICH = dict(MAIN, ticks=4, spatial_check_ticks=(0,), rank_check_tick=1)
ENRICH_BUDGET = 4096
# phase 8: the main engine under the reference's churn suite at 1M live
# subscriptions (benchmarks/churn.py: n_live // 400 = 2,500 adds and
# removes a batch, cohort churn max(64, 2,500 // 8) = 312 users a batch,
# ROUNDS = 4 batches a tick); MostThreateningTweets at its 200,000 the same
# way (500)
CHURN = dict(MAIN, cohort=5000, drug_churn=2500, threat_churn=500,
             user_churn=312, rounds=4, warmup=2, ticks=20, rebuild_ticks=4,
             planner_ticks=6)
# phase 9: phase 3's workload on the sharded engine, 2 + 10 ticks at 1 and
# 4 shards (the 4-shard engine reshards to 2 after its 5th timed tick); the
# exact runs at 512 tweets a tick, where no delivery buffer overflows (the
# drug channel produces about 1.3M sIDs a tick against max_notify's 4.2M),
# 2 + 4 ticks, a reshard(2) after the 2nd; the sequence-parallel decode at
# the serve phase's last step over 4 slices of 136 keys, kv_len rows ending
# in every slice, at slice boundaries, and in the first slice only
SHARDED = dict(MAIN, warmup=2, ticks=10, reshard_after=5, exact_rows=512,
               exact_ticks=4, exact_reshard=2)
SP_DECODE = (SERVE["batch"], 12, 2, SERVE["prompt_len"] + SERVE["gen"], 128)
SP_KV_LEN = [543, 136, 100, 1, 544, 137, 408, 272]
# phase 10: each family at its published width, 16 greedy tokens; depth cut
# to fit the card's 80 GB in bf16 (phi3.5-moe 8 of 32 layers, about 21 GB
# of weights; dbrx 2 of 40, about 15 GB), the others whole
FAMILIES = [
    ("phi3.5-moe-42b-a6.6b", dict(depth=8, batch=8, prompt_len=512, gen=16)),
    ("dbrx-132b", dict(depth=2, batch=8, prompt_len=512, gen=16)),
    ("pixtral-12b", dict(depth=None, batch=4, prompt_len=512, gen=16)),
    ("zamba2-2.7b", dict(depth=None, batch=8, prompt_len=512, gen=16)),
    ("xlstm-125m", dict(depth=None, batch=8, prompt_len=512, gen=16)),
    ("seamless-m4t-medium", dict(depth=None, batch=8, prompt_len=1024,
                                 gen=16)),
]
# kernels against the plain attention versions in an MoE family: the share
# of (row, step) logits that must fall within (DECODE_REL_L2,
# DECODE_MAX_ABS). The bf16 attention outputs of the two versions differ by
# a rounding step; where that moves a token's float32 router logits across
# a tie between its k-th and (k+1)-th expert, the token takes another
# expert and its row differs at O(1)
MOE_ROWS_WITHIN = 0.75
# phase 11: tinyllama-1.1b at its published width and depth (the reference
# train CLI's default arch): batch 16 x 2,048 tokens, accum min(8, 16) = 8
# (microbatch 2), 8 steps, a checkpoint every 4; the restart fails at step 6
# and resumes from step 4. (b) the same model cut to 2 layers, one
# microbatch; (c) pixtral-12b cut to 4 of 40 layers (Adafactor, b1 0.9, the
# embed frontend) and seamless-m4t-medium whole (AdamW, the enc-dec loss,
# 1,024 frames and 256 decoder tokens), one step each
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN = dict(batch=16, seq=2048, steps=8, ckpt_every=4, fail_at=6)
TRAIN_GRAD = dict(depth=2, micro=2, seq=2048)
TRAIN_OTHERS = [("pixtral-12b", dict(depth=4, batch=4, seq=1024)),
                ("seamless-m4t-medium", dict(depth=None, batch=8, seq=1024))]
# phase 12, on qwen2-1.5b at its published width and depth: (b) a (2, 2)
# mesh of the one card; (c) the 28 layers in 2 and in 4 stages, 8
# microbatches of 2 x 2,048 positions; (d) the reduction over 1, 2 and 4
# positions; (e) a 1,048,576-tweet batch
REPEATS = 3         # phase 12's timed runs of each forward
MESH = dict(grid=(2, 2), pods=(1, 2, 4), selectivity_rows=1 << 20,
            pipeline=dict(stages=(2, 4), micro=8, batch=2, seq=2048))
# phase 13 (b): what one data shard of the (16, 16) mesh holds with the
# model axis whole: train_4k's microbatch (256 rows / 16 microbatches) over
# 16 data positions, and decode_32k's 128 rows over 16, the cache full but
# for the token written
PROBES = dict(train=dict(batch=1, seq=4096, repeats=3),
              decode=dict(batch=8, cache=32768, live=32767, repeats=5))
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")
# phase 13 (a)'s cells whose count takes the host longest (minutes each:
# xlstm's sLSTM loop runs every token's step on meta), each counted in a
# worker process started with phase 11
DRYRUN_EARLY = [("xlstm-125m", "train_4k"), ("xlstm-125m", "prefill_32k")]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    path = _build.build()
    print(f"[build] {path.name} in {time.perf_counter() - t:.1f} s")
    for line in _build.build_log.splitlines():
        if "ptxas" in line:
            print(f"[build] {line.strip()}")
    regs = ptxas_summary(_build.build_log)
    print(f"[build] registers and spill bytes by kernel (ptxas -v): "
          f"{json.dumps(regs)}")
    assert any("flash_decode" in name for name in regs) and \
        any("predicate_filter" in name for name in regs), regs
    _build.library()
    hgmma = tensor_core_counts(path)
    print(f"[build] HGMMA instructions in the bf16 flash_attention kernels "
          f"(cuobjdump -sass): {json.dumps(hgmma)}")
    # both products of every bf16 instantiation on the tensor cores
    assert len(hgmma) == 8 and min(hgmma.values()) >= 2, hgmma

    t = time.perf_counter()
    paths = edge_parity(dev)
    print(f"[parity] exact on the edge cases in "
          f"{time.perf_counter() - t:.1f} s; join_compact launches by path "
          f"{json.dumps(paths)}, every output between intact sentinels")
    assert min(paths.values()) > 0, paths
    t = time.perf_counter()
    worst = flash_edge_parity(dev)
    print(f"[parity] attention kernels within tolerance on the edge cases in "
          f"{time.perf_counter() - t:.1f} s: largest errors "
          f"{json.dumps(worst)}")

    torch.cuda.reset_peak_memory_stats(dev)
    mp = main_path(dev, MAIN)
    print(f"[main] setup {mp['setup_s']:.1f} s; {mp['ticks']} ticks in "
          f"{mp['wall_s']:.2f} s: per tick mean {mp['tick_ms_mean']:.2f} ms,"
          f" p50 {mp['tick_ms_p50']:.2f} ms, max {mp['tick_ms_max']:.2f} ms;"
          f" {mp['reports']} channel executions, rows ingested "
          f"{mp['rows_ingested']} (ring wrapped: {mp['wrapped']})")
    print(f"[main] per tick: ingest {mp['ingest_ms_mean']:.2f} ms, "
          f"execute+deliver (ms) {json.dumps(mp['exec_ms_mean'])}")
    print(f"[main] totals {json.dumps(mp['totals'])}; launches "
          f"{json.dumps(mp['launches'])}")
    print(f"[main] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fp = fused_path(dev, MAIN)
    fp["same"] = same_as_per_channel(dev, MAIN, fp.pop("first"))
    print(f"[fused] setup {fp['setup_s']:.1f} s; {fp['ticks']} ticks in "
          f"{fp['wall_s']:.2f} s: per tick mean {fp['tick_ms_mean']:.2f} ms,"
          f" p50 {fp['tick_ms_p50']:.2f} ms, max {fp['tick_ms_max']:.2f} ms;"
          f" rows ingested {fp['rows_ingested']} (ring wrapped: "
          f"{fp['wrapped']})")
    print(f"[fused] per tick: ingest {fp['ingest_ms_mean']:.2f} ms, "
          f"execute_all+deliver per plan-group (ms) "
          f"{json.dumps(fp['exec_ms_mean'])} for {json.dumps(fp['groups'])},"
          f" drain_spilled {fp['drain_ms_mean']:.2f} ms")
    print(f"[fused] totals {json.dumps(fp['totals'])}; ring pending "
          f"{fp['ring_pending']}, queue pending {fp['queue_pending']}")
    print(f"[fused] launches {json.dumps(fp['launches'])} (1 predicate_filter"
          f", 1 spatial_match_stacked, 1 join_compact on its vector path, 2 "
          f"deliver, 1 of them on its vector path, per tick); largest "
          f"shapes {json.dumps(fp['shapes'])}; tick 0 equal to "
          f"execute_channel for {fp['same']} channels")
    print(f"[fused] max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    cp = compact_phase(dev, COMPACT)
    cjp = cp["compact_pallas"]
    s_len, max_t = cjp["shapes"]["join_compact"]
    print(f"[compact] six channels, window scan, flat layout: S={s_len} "
          f"maxT={max_t}, join_compact outputs {13 * s_len * max_t / 1e9:.3f}"
          f" GB; {cp['results']} results, equal on both backends")
    for b in ("compact_pallas", "pallas"):
        print(f"[compact] {b}: execute_all per tick (ms) "
              f"{json.dumps([round(w, 3) for w in cp[b]['walls_ms']])}, "
              f"launches {json.dumps(cp[b]['launches'])}, "
              f"max_memory_allocated {cp[b]['peak_gib']:.2f} GiB")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ep = every_plan(dev, PLANS)
    print(f"[plans] {ep['runs']} runs in {ep['wall_s']:.2f} s, all plans "
          f"equal: {json.dumps(ep['channels'])}; fused launches "
          f"{json.dumps(ep['fused_launches'])}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    from repro_torch import configs
    qwen = configs.get_config("qwen2-1.5b")
    torch.cuda.empty_cache()
    sp = serve_phase(dev, qwen, SERVE)
    print(f"[serve] {qwen.name}: {qwen.superlayer_repeat} layers, d_model "
          f"{qwen.d_model}, vocab {qwen.vocab_size}, {qwen.param_dtype}; "
          f"weights drawn in {sp['init_s']:.1f} s; batch {sp['batch']}, "
          f"prompt {sp['prompt_len']}, {sp['gen']} tokens: prefill "
          f"{sp['prefill_ms']:.2f} ms, decode {sp['decode_ms_per_token']:.3f} "
          f"ms/token ({sp['decode_tokens_per_s']:.1f} tokens/s decoding, "
          f"{sp['tokens_per_s']:.1f} tokens/s with the prefill); "
          f"max_memory_allocated {sp['peak_gib']:.2f} GiB")
    print(f"[serve] launches {json.dumps(sp['launches'])}; largest shapes "
          f"{json.dumps(sp['shapes'])}; sample {sp['sample']}; cached decode "
          f"vs teacher-forced forward (relative L2, max abs) per token "
          f"{json.dumps(sp['decode_vs_forward'])} (limits {DECODE_REL_L2}, "
          f"{DECODE_MAX_ABS})")

    torch.cuda.empty_cache()
    en = enriched_phase(dev, ENRICH, qwen, ENRICH_BUDGET)
    print(f"[enriched] LMScorer({qwen.name}, budget={en['budget']}) on the "
          f"fused path; setup {en['setup_s']:.1f} s; {en['ticks']} ticks (ms) "
          f"{json.dumps([round(t, 2) for t in en['tick_ms']])}")
    print(f"[enriched] scored slots per group {json.dumps(en['groups'])} per "
          f"tick {json.dumps(en['scored_slots'])}; score ms (CUDA events) "
          f"{json.dumps([[round(x, 2) for x in t] for t in en['score_ms']])}")
    print(f"[enriched] ranked pairs per tick {json.dumps(en['ranked'])}; rank "
          f"rule held on {en['rank_checked_slots']} slots; launches "
          f"{json.dumps(en['launches'])}; max_memory_allocated "
          f"{en['peak_gib']:.2f} GiB")

    torch.cuda.empty_cache()
    card = card_line()
    t = time.perf_counter()
    ch = churn_phase(dev, CHURN)
    churn_s = time.perf_counter() - t
    for key, what in (("a", "incremental, depth 1"),
                      ("b", "incremental, depth 2 (TickPipeline)"),
                      ("c", "rebuild (incremental=False)"),
                      ("d", "incremental + RuntimePlanner")):
        r = ch[key]
        rep = r["report"]
        n = max(rep.ticks, 1)
        walls = r["walls_ms"]
        wall_txt = (f"per tick mean {1e3 * rep.wall_s / n:.2f} ms" +
                    (f", p50 {np.median(walls):.2f}, max {np.max(walls):.2f}"
                     f" ms (between ticks)" if len(walls) else ""))
        lat = r["latency_ms"]
        print(f"[churn] ({key}) {what} on {card}: {rep.ticks} timed ticks "
              f"in {rep.wall_s:.3f} s, {wall_txt}; {rep.ticks_per_s:.3f} "
              f"ticks/s, {rep.subs_per_s:.0f} subs/s; maintenance "
              f"{json.dumps(dataclasses.asdict(rep.maintenance))}; "
              f"pipeline_depth {rep.pipeline_depth}; "
              f"PendingExecution.latency_s mean "
              f"{np.mean(lat) if lat else 0:.2f} ms, max "
              f"{np.max(lat) if lat else 0:.2f} ms; max_memory_allocated "
              f"{r['peak_gib']:.2f} GiB")
        ticks_all = {"a": CHURN["warmup"] + CHURN["ticks"],
                     "b": CHURN["warmup"] + CHURN["ticks"],
                     "c": CHURN["warmup"] + CHURN["rebuild_ticks"],
                     "d": CHURN["planner_ticks"]}[key]
        host = {k: round(1e3 * v / ticks_all, 3)
                for k, v in r["host_s"].items()}
        print(f"[churn] ({key}) host ms per tick (all {ticks_all} ticks) by "
              f"span on {card}: {json.dumps(host)}; counters "
              f"{json.dumps({k: getattr(rep, k) for k in CHURN_COUNTERS})}"
              f", drain_calls {rep.drain_calls}; launches "
              f"{json.dumps(r['launches'])}")
    print(f"[churn] (a) cohort spatial hits equal to numpy: {ch['a']['hits']}"
          f"; (b) counters equal to (a)'s; (d) switches "
          f"{json.dumps(ch['d']['switches'])}; setup {ch['setup_s']:.1f} s")
    print(f"[churn] subs/s incremental over rebuild {ch['ratio']:.2f}x on "
          f"{card}; phase 8 in {churn_s:.1f} s")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    sh = sharded_phase(dev, SHARDED)
    sharded_s = time.perf_counter() - t
    print_sharded(sh, card_line())
    print(f"[sharded] phase 9 in {sharded_s:.1f} s")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    card = card_line()
    fam = {}
    for arch, shape in FAMILIES:
        fam[arch] = family_phase(dev, arch, shape)
        print_family(fam[arch], card)
    print(f"[families] phase 10 in {time.perf_counter() - t:.1f} s")

    # phase 13 (a)'s slowest cells start here, beside phases 11 and 12,
    # whose time is the card's: started with phase 1, beside them phase 6's
    # host-bound serve decode read 32 ms a token, against 20-26 ms without
    # them (an H100 machine)
    workers, early = start_dryrun_workers(DRYRUN_OUT)
    torch.cuda.empty_cache()
    tr = training_phase(dev)

    torch.cuda.empty_cache()
    pipe = mesh_phase(dev, qwen, MESH)

    torch.cuda.empty_cache()
    dry = dryrun_phase(dev, qwen, PROBES, DRYRUN_OUT, early)
    workers.close()
    workers.join()

    # each entry is timed at the largest shape a path gave it and reports
    # that path's launches: (entry, path, where, shape format, case)
    timed = [
        ("predicate_filter", fp, "fused main path", "N={} F={} C={}",
         case_predicate_filter),
        ("predicate_filter_rows", cjp, "compact phase (compact_pallas)",
         "C={} N={} F={}", case_predicate_filter_rows),
        ("spatial_match", mp, "per-channel main path", "R={} U={}",
         case_spatial_match),
        ("spatial_match_stacked", fp, "fused main path", "C={} R={} U={}",
         case_spatial_match_stacked),
        ("join_compact", fp, "fused main path", "S={} maxT={}",
         functools.partial(case_join_compact, aggregated=True)),
        ("flash_attention", sp, "serve phase (prefill)",
         "B={} H={} KH={} S={} D={}", case_flash_attention),
        ("flash_decode", sp, "serve phase (decode)",
         "B={} H={} KH={} S={} D={}", case_flash_decode),
        # the second rows of a kernel (kept under their first row below)
        ("join_compact", cjp, "compact phase (compact_pallas)",
         "S={} maxT={}", functools.partial(case_join_compact,
                                           aggregated=False)),
        ("flash_attention", en, "enriched tick (LMScorer prefill)",
         "B={} H={} KH={} S={} D={}", case_flash_attention),
        # timing cases of the kernel alone, where the bytes and not the
        # launch set the time: decode over a 32,768-key cache, and a full
        # scan of the main path's ring (plans.candidates_full_scan_all)
        ("flash_decode", sp, "serve phase (decode); timed at a 32,768-key "
         "cache", "B={} H={} KH={} S={} D={}", case_flash_decode,
         (SERVE["batch"], qwen.n_heads, qwen.n_kv_heads, LONG_CACHE,
          qwen.resolved_head_dim)),
        ("predicate_filter", fp, "fused main path; timed at a full scan of "
         "its ring", "N={} F={} C={}", case_predicate_filter,
         (MAIN["dataset_capacity"], fp["shapes"]["predicate_filter"][1],
          fp["shapes"]["predicate_filter"][2])),
        # the partial entry at one slice of phase 9's sequence-parallel
        # decode (4 launches a sp_decode_attention call)
        ("flash_decode", {"launches": {"flash_decode": sh["sp"]["launches"]}},
         "phase 9 (sp_decode_attention, one slice's partial)",
         "B={} H={} KH={} S={} D={}", case_flash_decode_partial,
         SP_DECODE[:3] + (SP_DECODE[3] // 4, SP_DECODE[4])),
        # phase 10's new shapes: head dim 80 (zamba2) and key lengths of
        # their own (seamless's encoder, cross-attention and cross decode)
        *family_timing_cases(fam),
        # phase 11: the training microbatch's shape (every launch of the
        # train run, forward and remat recompute)
        ("flash_attention", tr, f"phase 11, {TRAIN_ARCH} training "
         f"microbatch", "B={} H={} KH={} S={} D={}", case_flash_attention),
        # phase 12: a pipeline stage's launch (qwen2-1.5b, the microbatch
        # of 2 x 2,048 positions); launches of the first stage count's run
        ("flash_attention", pipe, "phase 12, qwen2-1.5b pipeline stage",
         "B={} H={} KH={} S={} D={}", case_flash_attention),
        # phase 13: the train probe's attention (qwen2-1.5b, one data
        # shard's microbatch of 1 x 4,096); the launches of one probe call
        ("flash_attention", {"launches": dry["train"]["launches"]},
         "phase 13, qwen2-1.5b train probe", "B={} H={} KH={} S={} D={}",
         case_flash_attention, dry["train"]["attn_shape"]["flash_attention"]),
    ]
    replaces = {
        "predicate_filter": "src/repro/kernels/predicate_filter/kernel.py:45",
        "spatial_match": "src/repro/kernels/spatial_match/kernel.py:33",
        "join_compact": "src/repro/kernels/join_compact/kernel.py:47",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:70",
        "flash_decode": "src/repro/kernels/flash_decode/kernel.py:70"}
    rng = np.random.default_rng(SEED + 7)
    measured = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    from repro_torch.kernels.flash_decode import ops as fd_ops
    most = fd_ops.plan(_build.library(), dev, 1, 1, 1, 1024, 128,
                       torch.bfloat16)
    for name, path, where, fmt, case, *given in timed:
        shape = given[0] if given else path["shapes"][name]
        k = measure(case(dev, rng, shape), fmt.format(*shape))
        if name == "flash_decode":
            b, h, kh, s_len, d = shape
            want = fd_ops.cluster_size(b, kh, s_len, sms, most)
            n = fd_ops.plan(_build.library(), dev, b, h, kh, s_len, d,
                            torch.bfloat16)
            print(f"[kernel] flash_decode {k['shape']}: clusters of {n} "
                  f"blocks (n_split {n}), {b * kh} clusters, {b * kh * n} "
                  f"blocks on {sms} SMs")
            assert n == want, (n, want)
            k["n_split"] = n
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        if k["floor_ms"] is not None:
            lib += f", floor {k['floor_ms']:.4f} ms (empty kernel, same grid)"
        if name == "join_compact":
            # the path the timed launch takes, and the path's main-path
            # launches: the vector path at both shapes
            k["vector_launches"] = path["launches"]["join_compact_vector"]
            assert k["path"] == "vector" and k["vector_launches"] == \
                path["launches"][name] > 0, (where, k, path["launches"])
            lib += (f", {k['path']} path ({k['vector_launches']} of "
                    f"{path['launches'][name]} launches on the vector path)")
        print(f"[kernel] {name} {k['shape']} ({where}): {k['ms']:.4f} ms "
              f"(graph of wrapper calls), wrapper {k['wrapper_ms']:.4f} ms, "
              f"plain {k['plain_ms']:.4f} ms{lib}, bound {k['bound_ms']:.4f} "
              f"ms ({k['bound_by']}, {k['bound_bytes']} B, {k['bound_ops']} "
              f"ops), max_abs_err {k['max_abs_err']} (tolerance "
              f"{k['tolerance']} + {k['tolerance_rel']} x |plain|: "
              f"{'within' if k['within_tolerance'] else 'OUTSIDE'})")
        module = ENTRIES[name][0]
        measured.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{module}.cu",
            "replaces": replaces[module], "launches": path["launches"][name],
            "launches_on": where, **{key: k[key] for key in (
                "max_abs_err", "tolerance", "tolerance_rel",
                "within_tolerance", "ms", "wrapper_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "floor_ms", "shape")},
            **{key: k[key] for key in ("n_split", "path", "vector_launches")
               if key in k}})
    assert all(e["within_tolerance"] and e["launches"] > 0
               for e in measured), measured
    # the second rows: join_compact at the compact phase's real grid,
    # flash_attention at the enriched tick's scorer batch, the training
    # microbatch and a pipeline stage, flash_decode at a long cache,
    # predicate_filter at a full scan of the ring
    *measured, train_row, pipe_row, probe_row = measured
    n_family = len(FAMILY_CASES)
    *entries, real_grid, scorer, long_cache, full_scan, sp_slice = \
        measured[:-n_family]
    seconds = [(real_grid, "join_compact", "real_grid"),
               (scorer, "flash_attention", "enriched_tick"),
               (long_cache, "flash_decode", "long_cache"),
               (full_scan, "predicate_filter", "full_scan"),
               (sp_slice, "flash_decode", "sp_decode_slice")]
    seconds += [(e, e["name"], key) for e, key in
                zip(measured[-n_family:], FAMILY_CASES)]
    seconds.append((train_row, "flash_attention", "train"))
    seconds.append((pipe_row, "flash_attention", "pipeline"))
    seconds.append((probe_row, "flash_attention", "dryrun_probe"))
    for entry, second, key in seconds:
        first = next(e for e in entries if e["name"] == second)
        first[key] = {k: v for k, v in entry.items()
                      if k not in ("name", "route", "source", "replaces")}
    # phase 9's launches: the 4-shard engine's run (10 + 2 warm-up ticks at
    # 4 shards, then 3 at 2) and one sp_decode_attention call's partials
    sharded = {name: sh["full"][4]["launches"][name]
               for name in SHARDED_KERNELS[:3]}
    sharded["flash_decode"] = sh["sp"]["launches"]
    for e in entries:
        if e["name"] in sharded:
            e["sharded_launches"] = sharded[e["name"]]
        if e["name"] in ("flash_attention", "flash_decode"):
            e["family_launches"] = {a: f["launches"][e["name"]]
                                    for a, f in fam.items()}
        if e["name"] == "flash_attention":
            e["train_launches_per_step"] = \
                tr["launches_per_step"]["flash_attention"]
            # phase 12's pipelined forwards, by stage count
            e["pipeline_launches"] = {str(s): r["launches"]
                                      for s, r in pipe["runs"].items()}
        if e["name"] in ("flash_attention", "flash_decode"):
            # phase 13's probe calls: one train probe, one decode probe
            e["dryrun_probe_launches"] = {
                kind: r["launches"].get(e["name"], 0)
                for kind, r in dry.items()}
    assert min(sharded.values()) > 0, sharded
    # deliver at the benchmark cells' own calls: paper-1m's param and
    # spatial plan-groups, and trending's; its launches are the fused main
    # path's, each on the path its width takes
    torch.cuda.empty_cache()
    rows = []
    for workload, groups in DELIVER_CELLS:
        calls = deliver_calls(dev, workload)
        assert len(calls) == len(groups), (workload, len(calls))
        for group, a in zip(groups, calls):
            rows.append(measure_deliver(a))
            print_deliver(rows[-1], f"{workload}, {group} plan-group")
        del calls
        torch.cuda.empty_cache()
    rows.append(measure_deliver(deliver_full_call(dev)))
    print_deliver(rows[-1], "the param plan-group's shape, every line live")
    torch.cuda.empty_cache()
    assert all(k["equal"] for k in rows), rows
    assert [k["path"] for k in rows] == ["vector", "scalar", "vector",
                                         "vector"], rows
    assert fp["launches"]["deliver"] == 2 * fp["ticks"] == \
        2 * fp["launches"]["deliver_vector"], fp["launches"]
    param, spatial, trending, full = ({key: k[key] for key in (
        "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "floor_ms",
        "shape", "path", "live_lines", "live_sids")} for k in rows)
    assert full["live_lines"] == 2 * 131072, full
    entries.append({
        "name": "deliver", "route": "cuda",
        "source": "src/repro_torch/csrc/deliver.cu",
        "replaces": "src/repro/core/broker.py:538",
        "launches": fp["launches"]["deliver"],
        "launches_on": "fused main path",
        "vector_launches": fp["launches"]["deliver_vector"],
        "sharded_launches": sh["full"][4]["launches"]["deliver"],
        "max_abs_err": 0.0, "tolerance": 0.0, "tolerance_rel": 0.0,
        "within_tolerance": True, "library_ms": None,
        "cell": "paper-1m.fused, param plan-group", **param,
        "paper1m_spatial": dict(spatial, cell="paper-1m.fused, spatial "
                                "plan-group"),
        "trending": dict(trending, cell="trending-2lang.fused, param "
                         "plan-group"),
        "every_line_live": dict(full, cell="the param plan-group's shape, "
                                "every line live")})
    # last, so that the profiler's tracing touches no timed phase
    kernels = one_kernel_per_decode_call(dev)
    print(f"[parity] one kernel a flash_decode call (torch.profiler): "
          f"{json.dumps(kernels)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
