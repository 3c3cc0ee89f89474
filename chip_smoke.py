#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository's ``src/`` beside this file; it
exits non-zero, printing no result, without them. Phases:

1. Build the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc's
   ``-Xptxas -v`` lines are printed) and hold each kernel against its plain
   PyTorch version on the card, exactly, at the main path's shapes and on
   edge cases; time each kernel's raw launches from one CUDA graph (and
   its wrapper and plain version) with CUDA events beside its bound.
2. The main path at a size users would call real: one engine, three
   channels (TweetsAboutDrugs with 1,000,000 subscriptions,
   MostThreateningTweets with 200,000, TweetsAboutCrime3 over 10,000 users),
   40 ticks of 65,536 tweets (the 2M-row ring buffer wraps once), each tick
   executing every channel under the fully optimized plan with broker
   delivery. Checks per-stage delivery conservation, notified counts against
   a numpy count, spatial hits against a numpy evaluation, and that both
   kernels' launch counters advanced.
3. Every plan: the seven plans of the paper's plan-equivalence test on both
   backends over a second engine; all notify the same subscribers and match
   the same rows.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def graph_ms(launch, iters: int = 100, replays: int = 5) -> float:
    """Device milliseconds per kernel launch: ``launch(stream)`` enqueues
    one raw launch (inputs and output already allocated); ``iters`` of them
    are captured in one CUDA graph and replayed between CUDA events, so no
    host work (wrapper checks, allocation, the ctypes call) sits between
    the launches."""
    launch(torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(iters):
            launch(stream)
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
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def channel_specs():
    from repro_torch.core import channel as ch
    return [ch.tweets_about_drugs(), ch.most_threatening_tweets(),
            ch.tweets_about_crime(3)]


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_parity(dev) -> dict:
    from repro_torch.core.predicates import (Predicate, compile_conditions,
                                             evaluate_conditions)
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.kernels.predicate_filter import ops as pf_ops
    from repro_torch.kernels.predicate_filter import ref as pf_ref
    from repro_torch.kernels.spatial_match import ops as sm_ops

    lib = _build.library()
    rng = np.random.default_rng(SEED)
    out = {}

    # predicate_filter at the ingest shape: N = 65,536, F = 10, the main
    # path's three channels
    conds = compile_conditions([list(s.fixed_preds) for s in channel_specs()])
    f, _ = syn.tweet_arrays(rng, 65536, t0=1)
    f = syn.drug_tweak(f, rng, 0.05)
    fields = torch.tensor(f, device=dev)
    lo, hi, neq = (torch.tensor(a, device=dev)
                   for a in pf_ops.canonical_arrays(conds, fields.shape[1]))
    got = pf_ops.predicate_filter(fields, conds)
    want = pf_ref.predicate_filter(fields, lo, hi, neq)
    err = max_abs_err(got, want)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(got, evaluate_conditions(fields, conds)), \
        "predicate_filter differs from its plain version"
    # the int32-extreme rows and ragged lengths
    edge = torch.tensor([[-2**31, 2**31 - 1, 0, 5, 0, 0, 0, 0, 0, 0]],
                        dtype=torch.int32, device=dev)
    econds = compile_conditions([[Predicate.parse(0, "<=", -2**31 + 1)],
                                 [Predicate.parse(1, ">=", 2**31 - 1)],
                                 [Predicate.parse(3, "==", 5),
                                  Predicate.parse(3, "!=", 4)]])
    assert torch.equal(pf_ops.predicate_filter(edge, econds),
                       evaluate_conditions(edge, econds)), "int32 extremes"
    for n in (1, 7, 255, 257, 1000):
        x = fields[:n].contiguous()
        assert torch.equal(pf_ops.predicate_filter(x, conds),
                           evaluate_conditions(x, conds)), f"ragged N={n}"
    n, nf, c = fields.shape[0], fields.shape[1], lo.shape[0]
    pf_out = torch.empty((n, c), dtype=torch.bool, device=dev)

    def pf_raw(stream):
        _build.check(lib.predicate_filter_launch(
            fields.data_ptr(), lo.data_ptr(), hi.data_ptr(), neq.data_ptr(),
            pf_out.data_ptr(), n, nf, c, stream), "predicate_filter")

    out["predicate_filter"] = dict(
        shape=f"N={n} F={nf} C={c}", max_abs_err=err, ms=graph_ms(pf_raw),
        wrapper_ms=cuda_ms(lambda: pf_ops.predicate_filter(fields, conds),
                           200),
        plain_ms=cuda_ms(lambda: pf_ref.predicate_filter(fields, lo, hi, neq),
                         50),
        bound_bytes=n * nf * 4 + 3 * c * nf * 4 + n * c,
        bound_ops=4 * n * c * nf)

    # spatial_match at the spatial join's largest shape: R = 16,384
    # candidate tweets x U = 10,000 users, r = 10
    radius = 10.0
    t = torch.tensor(rng.uniform(-100, 100, (16384, 2)).astype(np.float32),
                     device=dev)
    u = torch.tensor(rng.uniform(-100, 100, (10000, 2)).astype(np.float32),
                     device=dev)
    got = sm_ops.spatial_match(t, u, radius)
    want = sm_ops.spatial_match_plain(t, u, radius)
    err = max_abs_err(got, want)
    torch.cuda.synchronize()
    assert err == 0, "spatial_match differs from its plain version"
    for r_, u_ in ((1, 1), (1, 10000), (300, 700), (16383, 257)):
        a, b = t[:r_].contiguous(), u[:u_].contiguous()
        assert torch.equal(sm_ops.spatial_match(a, b, radius),
                           sm_ops.spatial_match_plain(a, b, radius)), \
            f"ragged {r_}x{u_}"
    far = torch.tensor([[sm_ops.FAR, sm_ops.FAR], [0.0, 0.0]], device=dev)
    ufar = torch.tensor([[-sm_ops.FAR, -sm_ops.FAR], [0.5, 0.5]], device=dev)
    hit = sm_ops.spatial_match(far, ufar, radius)
    assert hit.tolist() == [[False, False], [False, True]], hit.tolist()
    r, uu = t.shape[0], u.shape[0]
    sm_out = torch.empty((r, uu), dtype=torch.bool, device=dev)

    def sm_raw(stream):
        _build.check(lib.spatial_match_launch(
            t.data_ptr(), u.data_ptr(), sm_out.data_ptr(), r, uu,
            sm_ops.radius2(radius), stream), "spatial_match")

    out["spatial_match"] = dict(
        shape=f"R={r} U={uu}", max_abs_err=err, ms=graph_ms(sm_raw, 20),
        wrapper_ms=cuda_ms(lambda: sm_ops.spatial_match(t, u, radius), 50),
        plain_ms=cuda_ms(lambda: sm_ops.spatial_match_plain(t, u, radius), 10),
        bound_bytes=r * 8 + uu * 8 + r * uu,
        bound_ops=7 * r * uu + 3 * (r + uu))
    for k in out.values():
        k["bound_ms"] = 1e3 * max(k["bound_bytes"] / HBM_BYTES_PER_S,
                                  k["bound_ops"] / CUDA_CORE_OPS_PER_S)
        k["bound_by"] = ("bytes" if k["bound_bytes"] / HBM_BYTES_PER_S
                         >= k["bound_ops"] / CUDA_CORE_OPS_PER_S
                         else "operations")
    return out


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------


def check_conservation(rep) -> None:
    s = rep.overflow
    assert s.delivered_pairs + s.spilled_pairs + s.dropped_pairs \
        == rep.num_results, (rep.channel, s)
    assert s.delivered_sids + s.spilled_sids + s.dropped_sids \
        == rep.num_notified, (rep.channel, s)
    assert sum(s.delivered_pairs_broker) == s.delivered_pairs, (rep.channel, s)


def spatial_hits_numpy(t: np.ndarray, u: np.ndarray, radius: float) -> int:
    """Hit count with the expansion form, elementwise in float32 (numpy
    rounds every operation on its own, like the kernel)."""
    t0, t1 = t[:, 0:1], t[:, 1:2]
    u0, u1 = u[None, :, 0], u[None, :, 1]
    dist2 = (t0 * t0 + t1 * t1 + (u0 * u0 + u1 * u1)) \
        - np.float32(2.0) * (t0 * u0 + t1 * u1)
    return int((dist2 < np.float32(radius) ** 2).sum())


def main_path(dev, cfg: dict) -> dict:
    from repro_torch.core import records as R
    from repro_torch.core.engine import BADEngine
    from repro_torch.core.plans import ExecutionFlags
    from repro_torch.core.predicates import compile_conditions
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels.predicate_filter import ops as pf_ops
    from repro_torch.kernels.spatial_match import ops as sm_ops

    rng = np.random.default_rng(SEED + 1)
    t_setup = time.perf_counter()
    eng = BADEngine(dataset_capacity=cfg["dataset_capacity"],
                    index_capacity=cfg["index_capacity"],
                    max_window=cfg["max_window"],
                    max_candidates=cfg["max_candidates"],
                    brokers=tuple(f"Broker{i}" for i in range(4)),
                    max_deliver_pairs=cfg["max_deliver_pairs"],
                    max_notify=cfg["max_notify"], use_pallas=True, device=dev)
    drugs, threat, crime = channel_specs()
    for spec in (drugs, threat, crime):
        eng.create_channel(spec)
    sub_counts = {}
    for spec, n in ((drugs, cfg["drug_subs"]), (threat, cfg["threat_subs"])):
        params, brokers = syn.subscriptions_by_population(rng, n, 4)
        eng.subscribe_bulk(spec.name, params, brokers)
        sub_counts[spec.name] = np.bincount(params, minlength=50)
    users = rng.uniform(-100, 100, (cfg["users"], 2)).astype(np.float32)
    eng.set_user_locations(users, rng.integers(0, 4, cfg["users"]))
    setup_s = time.perf_counter() - t_setup

    one = {s.name: compile_conditions([list(s.fixed_preds)])
           for s in (drugs, threat, crime)}
    flags = ExecutionFlags.fully_optimized()
    pf_ops.LAUNCHES = 0
    sm_ops.LAUNCHES = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tick_s, ingest_s, reports = [], [], 0
    exec_s = {s.name: [] for s in (drugs, threat, crime)}
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
        for spec in (drugs, threat, crime):
            te = time.perf_counter()
            reps.append(eng.execute_channel(spec.name, flags, deliver=True))
            exec_s[spec.name].append(time.perf_counter() - te)
        tick_s.append(time.perf_counter() - ts)
        # checks, outside the timed tick
        for spec, rep in zip((drugs, threat, crime), reps):
            check_conservation(rep)
            reports += 1
            for k in ("results", "notified"):
                totals[k] += getattr(rep, f"num_{k}")
            totals["delivered_pairs"] += rep.overflow.delivered_pairs
            totals["delivered_sids"] += rep.overflow.delivered_sids
            match = _host_match(f, one[spec.name])
            if spec.join == "param":
                want = int(sub_counts[spec.name][f[match, spec.param_field]]
                           .sum())
                assert rep.num_notified == want, (tick, spec.name,
                                                  rep.num_notified, want)
            elif tick in cfg["spatial_check_ticks"]:
                want = spatial_hits_numpy(loc[match], users,
                                          spec.spatial_radius)
                assert rep.num_results == want, (tick, rep.num_results, want)
    wall = time.perf_counter() - t0
    launches = {"predicate_filter": pf_ops.LAUNCHES,
                "spatial_match": sm_ops.LAUNCHES}
    if dev.type == "cuda":
        assert launches["predicate_filter"] == cfg["ticks"], launches
        assert launches["spatial_match"] == cfg["ticks"], launches
    return dict(setup_s=setup_s, wall_s=wall, ticks=cfg["ticks"],
                tick_ms_mean=1e3 * float(np.mean(tick_s)),
                tick_ms_p50=1e3 * float(np.median(tick_s)),
                tick_ms_max=1e3 * float(np.max(tick_s)),
                ingest_ms_mean=1e3 * float(np.mean(ingest_s)),
                exec_ms_mean={k: 1e3 * float(np.mean(v))
                              for k, v in exec_s.items()},
                reports=reports, launches=launches, totals=totals,
                rows_ingested=eng.size_host,
                wrapped=eng.size_host > cfg["dataset_capacity"])


def _host_match(f: np.ndarray, conds) -> np.ndarray:
    """The channel's fixed conjunction on the host batch (numpy)."""
    ok = np.ones(f.shape[0], bool)
    for c in range(int(conds.npreds[0])):
        x = f[:, conds.field_idx[0, c]]
        v, op = conds.value[0, c], conds.op[0, c]
        ok &= [x == v, x != v, x < v, x <= v, x > v, x >= v][op]
    return ok


# ---------------------------------------------------------------------------
# phase 3: every plan on both backends
# ---------------------------------------------------------------------------


def every_plan(dev, cfg: dict) -> dict:
    from repro_torch.core import records as R
    from repro_torch.core.engine import BADEngine
    from repro_torch.core.plans import ExecutionFlags
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
    plans = [ExecutionFlags.original(),
             ExecutionFlags(scan_mode="window"),
             ExecutionFlags(scan_mode="trad_index"),
             ExecutionFlags(scan_mode="bad_index"),
             ExecutionFlags(scan_mode="bad_index", aggregation=True),
             ExecutionFlags(scan_mode="bad_index", aggregation=True,
                            param_pushdown=True),
             ExecutionFlags(scan_mode="window", aggregation=True,
                            param_pushdown=True)]
    t0 = time.perf_counter()
    runs = 0
    out = {}
    for name in (drugs.name, crime.name):
        seen = None
        for backend in ("oracle", "pallas"):
            for flags in plans:
                rep = eng.execute_channel(name, flags, advance=False,
                                          backend=backend)
                res = rep.result
                rows = set(res.matched_rows[res.matched_valid].tolist())
                got = (rep.num_notified, rows)
                if seen is None:
                    seen = got
                assert got[0] == seen[0], (name, backend, flags, got[0],
                                           seen[0])
                assert got[1] == seen[1], (name, backend, flags)
                runs += 1
                del rep, res
        out[name] = dict(notified=seen[0], matched_rows=len(seen[1]))
    return dict(runs=runs, wall_s=time.perf_counter() - t0, channels=out)


MAIN = dict(dataset_capacity=1 << 21, index_capacity=1 << 20,
            max_window=1 << 16, max_candidates=1 << 14,
            max_deliver_pairs=1 << 14, max_notify=1 << 22,
            drug_subs=1_000_000, threat_subs=200_000, users=10_000,
            ticks=40, tick_rows=65536, spatial_check_ticks=(0, 39))
PLANS = dict(dataset_capacity=1 << 18, index_capacity=1 << 16,
             max_window=1 << 14, max_candidates=1 << 14,
             drug_subs=50_000, users=10_000, ticks=2, tick_rows=8192)


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
    _build.library()

    t = time.perf_counter()
    kernels = kernel_parity(dev)
    print(f"[parity] exact at the main path's shapes and edges in "
          f"{time.perf_counter() - t:.1f} s")
    for name, k in kernels.items():
        print(f"[kernel] {name} {k['shape']}: {k['ms']:.4f} ms (graph of "
              f"raw launches), wrapper {k['wrapper_ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")

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

    torch.cuda.reset_peak_memory_stats(dev)
    ep = every_plan(dev, PLANS)
    print(f"[plans] {ep['runs']} runs in {ep['wall_s']:.2f} s, all plans "
          f"equal: {json.dumps(ep['channels'])}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    replaces = {"predicate_filter":
                "src/repro/kernels/predicate_filter/kernel.py:45",
                "spatial_match": "src/repro/kernels/spatial_match/kernel.py:33"}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": mp["launches"][name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "wrapper_ms": k["wrapper_ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None, "shape": k["shape"]}
        for name, k in kernels.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
