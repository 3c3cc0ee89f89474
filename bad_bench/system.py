"""The system under test: ``repro_torch``'s ``BADEngine`` built from a
configuration, driven tick by tick, and what it produced, recorded.

One tick is the cell's control-plane batches (churn cells), then
``ingest`` of the period's ``RecordBatch``, ``execute_all(None,
deliver=True)`` over the configuration's plan assignment and
``drain_spilled()``, closed by one device synchronisation. Ticks run back
to back (a closed loop): the next period's batch is handed over when the
last tick has ended.

Everything the reference needs to judge a run is recorded here from the
program's outputs: every tick's per-channel counts and delivery stats,
the control plane's return values, on the sampled ticks the delivered
wire lines and sID buffers (device copies of their delivered prefixes),
and at the end the ring's rows.

A configuration with an ``enrichment`` block is a scored deployment
(``bad_bench/enrichment.py``): ``build`` first draws the scorer's weights
from the seed on the device, as part of ``setup_s`` (``weights`` in the
set-up's parts: 8.2-10.0 s for qwen2-1.5b's 1.54B on an H100, where a
second draw in the same process takes 0.13-0.20 s: the first one pays for
something the process does once, not yet found), and attaches the
program's ``LMScorer`` before the pre-load's catch-up; the catch-up does
not deliver, so it does not rank, and the warm-up ticks are the first
scored ticks. On the sampled ticks the stage's scores are recorded too.
Without the block nothing of this runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bad_bench import traffic as T

def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Spans:
    """Host spans of the benchmark's own calls into each layer, summed over
    the window. With ``exact`` each span ends in a device synchronisation,
    so the device's work is billed to the layer that enqueued it (the
    traced run only); ``annotate`` also marks each span in the profiler's
    timeline."""

    def __init__(self, dev, exact: bool):
        self.dev, self.exact, self.on, self.annotate = dev, exact, False, False
        self.total: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        mark = (torch.profiler.record_function(f"span:{name}")
                if self.annotate else contextlib.nullcontext())
        t = time.perf_counter()
        with mark:
            yield
            if self.exact:
                sync(self.dev)
        self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t


@dataclasses.dataclass
class Tick:
    """One tick as the program reported it."""

    wall_s: float
    tweets: int
    # channel -> (num_results, num_notified, broker_bytes (B,),
    #             DeliveryStats fields)
    reports: Dict[str, tuple]
    drained: Dict[str, tuple]           # channel -> DeliveryStats fields
    control: List[tuple]                # (op, channel, returned)
    error: Optional[str] = None
    # from handing over the period's batch, once the tick's control-plane
    # calls have returned, to the closing sync: how late the period's
    # notifications reach the brokers
    notify_s: float = 0.0
    start_s: float = 0.0                # host clock at the handover


STAT_FIELDS = ("delivered_pairs", "spilled_pairs", "dropped_pairs",
               "delivered_sids", "spilled_sids", "dropped_sids",
               "retried_pairs", "retried_sids", "ranked_pairs", "ranked_sids")


def stat_tuple(s) -> tuple:
    return tuple(int(getattr(s, k)) for k in STAT_FIELDS)


def make_spec(ch: Dict):
    """The program's ``ChannelSpec`` of a configuration's channel entry."""
    from repro_torch.core.channel import ChannelSpec
    from repro_torch.core.predicates import Predicate
    preds = tuple(Predicate.parse(T.FIELDS[f], op, v)
                  for f, op, v in ch["predicates"])
    if ch["join"] == "spatial":
        return ChannelSpec(ch["name"], preds, join="spatial",
                           spatial_radius=float(ch["radius"]),
                           payload_bytes=ch["payload_bytes"])
    return ChannelSpec(ch["name"], preds, join="param",
                       param_field=T.FIELDS[ch["param_field"]],
                       param_domain=ch["param_domain"],
                       payload_bytes=ch["payload_bytes"])


class Capture:
    """On the sampled ticks, device copies of each channel's delivered wire
    lines (header and sID words, the payload words left out) and delivered
    sIDs: what ``execute_all`` hands the brokers. ``_materialize_group`` is
    wrapped on the engine instance; the copies are the delivered prefixes
    only. With an enrichment stage attached its ``score`` is wrapped on the
    instance too: on the sampled ticks each call's channel rows, record
    rows and scores are cloned, and while ``shapes`` is a list (the
    profiled ticks) each call's (N, S) prompt shape is appended to it."""

    def __init__(self, eng):
        self.eng = eng
        self.on = False
        self.ticks: Dict[int, Dict[str, tuple]] = {}
        self.scores: Dict[int, List[tuple]] = {}
        self.shapes: Optional[List[tuple]] = None
        self.tick = -1
        orig = eng._materialize_group

        def wrapped(g, reports):
            orig(g, reports)
            if self.on:
                self._take(g, reports)

        eng._materialize_group = wrapped
        if eng.enrichment is not None:
            self._wrap_score(eng.enrichment)

    def _wrap_score(self, stage) -> None:
        orig = stage.score

        def score(payload_tokens, channel_ids, sids):
            out = orig(payload_tokens, channel_ids, sids)
            if self.on:
                self.scores.setdefault(self.tick, []).append(
                    (channel_ids.clone(), sids.clone(),
                     torch.as_tensor(out).float().clone()))
            if self.shapes is not None:
                self.shapes.append(tuple(payload_tokens.shape))
            return out

        stage.score = score

    def _take(self, g, reports) -> None:
        pw = self.eng.deliver_payload_words
        got = self.ticks.setdefault(self.tick, {})
        for chs, dlv in ((g.param_chs, g.res[2]), (g.spatial_chs, g.res[3])):
            if not chs or dlv is None:
                continue
            width = dlv.pack.payload.shape[-1] - pw
            for i, st in enumerate(chs):
                s = reports[st.spec.name].overflow
                lines = dlv.pack.payload[i, :s.delivered_pairs, :width].clone()
                sids = dlv.fan.notify[i, :s.delivered_sids].clone()
                got[st.spec.name] = (lines, sids)

    def host(self) -> Dict[int, Dict[str, tuple]]:
        return {k: {n: (a.cpu().numpy(), b.cpu().numpy())
                    for n, (a, b) in v.items()}
                for k, v in self.ticks.items()}

    def host_scores(self) -> Dict[int, List[tuple]]:
        """Sampled tick -> [(channel rows, record rows, scores)], numpy."""
        return {k: [tuple(t.cpu().numpy() for t in call) for call in calls]
                for k, calls in self.scores.items()}


@dataclasses.dataclass
class Run:
    """Everything a run recorded."""

    setup_s: float
    window: List[Tick]
    window_s: float
    ticks: List[Tick]                   # every tick, warm-up included
    sampled: Dict[int, Dict[str, tuple]]
    final_drains: List[Dict[str, tuple]]
    pending_after: int
    ring_fields: np.ndarray
    ring_location: np.ndarray
    size_rows: int
    memory_peak_bytes: int
    spans: Dict[str, float]
    profile: Optional[dict]
    flush_drops: int
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    window_t0: float = 0.0              # host clock at the window's start
    # scored deployments: the configuration's enrichment block; sampled
    # tick -> the stage's calls [(channel rows, record rows, scores)]; the
    # (N, S) prompt shape of each call of the profiled ticks; engine
    # channel row -> channel name
    enrichment: Optional[Dict] = None
    scores: Dict[int, list] = dataclasses.field(default_factory=dict)
    score_shapes: List[tuple] = dataclasses.field(default_factory=list)
    channel_rows: Dict[int, str] = dataclasses.field(default_factory=dict)


def build(cfg: Dict, cell: Dict, seed: int, dev, parts: Dict = None):
    """The engine of a configuration, with its subscriptions, users,
    cohort and plans, its ring pre-loaded and, where the configuration
    has an ``enrichment`` block, its scorer attached."""
    from repro_torch.core import records as R
    from repro_torch.core.engine import BADEngine
    from repro_torch.core.plans import ChannelPlan, ExecutionFlags

    parts = {} if parts is None else parts
    stage = None
    if cfg.get("enrichment"):
        from bad_bench import enrichment
        t = time.perf_counter()
        # before the engine's buffers, so the float32 draw sets no peak
        stage = enrichment.stage(cfg["enrichment"], seed, dev)
        sync(dev)
        parts["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    e = cfg["engine"]
    eng = BADEngine(dataset_capacity=e["dataset_capacity"],
                    index_capacity=e["index_capacity"],
                    max_window=e["max_window"],
                    max_candidates=e["max_candidates"],
                    frame_bytes=e["frame_bytes"],
                    brokers=tuple(f"Broker{i}" for i in range(cfg["brokers"])),
                    use_pallas=True,
                    max_deliver_pairs=e["max_deliver_pairs"],
                    max_notify=e["max_notify"],
                    deliver_payload_words=e["deliver_payload_words"],
                    max_spill=e["max_spill"],
                    spill_capacity=e["spill_capacity"],
                    ring_capacity=e["ring_capacity"], device=dev)
    for ch in cfg["channels"]:
        eng.create_channel(make_spec(ch))
    for name, (params, brokers) in T.initial_subscriptions(cfg, seed).items():
        eng.subscribe_bulk(name, params, brokers,
                           np.arange(len(params), dtype=np.int32))
    locs, ubrokers = T.users(cfg, seed)
    eng.set_user_locations(locs, ubrokers)
    cohort = T.initial_cohort(cfg, cell, seed)
    if cohort is not None:
        eng.subscribe_users(cell["cohort"]["channel"], cohort)
    for ch in cfg["channels"]:
        eng.set_plan(ch["name"], ChannelPlan(**ch["plan"]))
    sync(dev)
    parts["subscriptions"] = time.perf_counter() - t
    t = time.perf_counter()
    for i, chunk in T.preload_chunks(cfg):
        f, loc = T.preload_batch(cfg, cell, seed, i, chunk)
        eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
    # the pre-load is history: one execution under the engine's padded
    # plan moves every channel's watermark past it, and leaves the
    # assigned plans' stream buckets and rings untouched
    sync(dev)
    parts["preload"] = time.perf_counter() - t
    if stage is not None:
        eng.set_enrichment(stage)
    t = time.perf_counter()
    eng.execute_all(ExecutionFlags.fully_optimized(), deliver=False,
                    timed=False)
    sync(dev)
    parts["catch_up"] = time.perf_counter() - t
    return eng


def run(cfg: Dict, cell: Dict, seed: int, seconds: float, trace: bool, dev,
        t_start: float, profile_fn=None, program_spans: bool = False) -> Run:
    """Build, warm up, measure ``seconds`` of ticks, profile a few more
    when tracing (with the program's own spans on where
    ``program_spans``), drain to empty, and read back what the checks
    need."""
    from repro_torch.core import records as R

    parts = {"start": time.perf_counter() - t_start}
    eng = build(cfg, cell, seed, dev, parts)
    t = time.perf_counter()
    pool = T.Pool(cfg, cell, seed)
    parts["pool"] = time.perf_counter() - t
    churn = None
    if cell.get("churn"):
        initial = {n: len(p) for n, (p, _) in
                   T.initial_subscriptions(cfg, seed).items()}
        domains = {ch["name"]: ch.get("param_domain", 0)
                   for ch in cfg["channels"]}
        churn = T.Churn(seed, cell["churn"], initial, domains,
                        cfg["brokers"], cfg["users"])
    spans = Spans(dev, exact=trace)
    capture = Capture(eng)
    ticks: List[Tick] = []

    def one_tick(k: int) -> Tick:
        f, loc = pool.get(k)
        muts = churn.tick() if churn is not None else []
        control, reps, drained, err = [], {}, {}, None
        t0 = time.perf_counter()
        t1 = t0
        try:
            if muts:
                with spans("control"):
                    for m in muts:
                        control.append((m.op, m.channel,
                                        apply_mutation(eng, m)))
            t1 = time.perf_counter()
            with spans("ingest"):
                eng.ingest(R.RecordBatch.from_numpy(f, loc, device=dev))
            with spans("execute"):
                out = eng.execute_all(None, deliver=True, timed=False)
            with spans("drain"):
                dr = eng.drain_spilled()
            sync(dev)
        except Exception as exc:      # a failed tick is counted, not hidden
            err = f"{type(exc).__name__}: {exc}"
            out, dr = {}, {}
        t2 = time.perf_counter()
        for name, r in out.items():
            reps[name] = (r.num_results, r.num_notified,
                          np.asarray(r.broker_bytes, np.int64).tolist(),
                          stat_tuple(r.overflow))
        for name, d in dr.items():
            drained[name] = stat_tuple(d.stats)
        return Tick(t2 - t0, f.shape[0], reps, drained, control, err,
                    notify_s=t2 - t1, start_s=t0)

    warm = cell["warmup_ticks"]
    t = time.perf_counter()
    for k in range(warm):
        ticks.append(one_tick(k))
    sync(dev)
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    warm_s = np.mean([w.wall_s for w in ticks[1:]] or [1.0])
    sampled = T.sample_ticks(seed, warm, seconds, warm_s, cell["samples"])
    spans.on = True
    window: List[Tick] = []
    t_window = time.perf_counter()
    k = warm
    while True:
        capture.on, capture.tick = k in sampled, k
        tick = one_tick(k)
        capture.on = False
        window.append(tick)
        ticks.append(tick)
        k += 1
        if tick.error is not None \
                or time.perf_counter() - t_window >= seconds:
            break
    window_s = time.perf_counter() - t_window
    spans.on = False
    profile = None
    if trace and window[-1].error is None:
        mean = window_s / len(window)
        profiled = int(min(max(3, math.ceil(1.0 / max(mean, 1e-6))), 24))
        kept = dict(spans.total)      # the window's spans stay the window's
        spans.on = spans.annotate = True
        capture.shapes = []
        more = {"program_spans": True} if program_spans else {}
        profile = profile_fn(lambda: [ticks.append(one_tick(k + i))
                                      for i in range(profiled)],
                             dev, profiled, **more)
        spans.on = spans.annotate = False
        spans.total = kept
    # after the window: re-deliver whatever waits in the rings and the
    # spill queue, so every produced notification can be accounted
    final = []
    for _ in range(64):
        if eng.ring_pending_pairs() + eng.ring_pending_sids():
            eng.flush_rings()
        if eng.spill.pending_pairs() + eng.spill.pending_sids() == 0:
            break
        final.append({n: stat_tuple(d.stats)
                      for n, d in eng.drain_spilled().items()})
    pending = (eng.ring_pending_pairs() + eng.ring_pending_sids()
               + eng.spill.pending_pairs() + eng.spill.pending_sids())
    sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ring_f = eng.dataset.fields.cpu().numpy()
    ring_l = eng.dataset.location.cpu().numpy()
    sampled_host = capture.host()
    size = eng.size_host
    flush_drops = int(eng.ring_flush_drops)
    rows = {st.index: name for name, st in eng.channels.items()}
    scored, shapes = capture.host_scores(), capture.shapes or []
    del eng, capture
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Run(setup_s=setup_s, window=window, window_s=window_s,
               ticks=ticks, sampled=sampled_host, final_drains=final,
               pending_after=pending, ring_fields=ring_f,
               ring_location=ring_l, size_rows=size, memory_peak_bytes=peak,
               spans=dict(spans.total), profile=profile,
               flush_drops=flush_drops, setup_parts=parts,
               window_t0=t_window, enrichment=cfg.get("enrichment"),
               scores=scored, score_shapes=shapes, channel_rows=rows)


def mutations(ticks: List[Tick]) -> int:
    """Control-plane mutations the engine reported applied in the completed
    ``ticks`` (adds, removes, cohort users in and out)."""
    return sum(v for t in ticks if t.error is None for _, _, v in t.control)


def apply_mutation(eng, m) -> int:
    """One control-plane call; returns what the engine reports (sIDs
    assigned, subscriptions removed, users attached or detached)."""
    if m.op == "subscribe_bulk":
        got = eng.subscribe_bulk(m.channel, m.params, m.brokers, m.ids)
        return int(np.array_equal(np.asarray(got), m.ids)) * len(m.ids)
    return int(getattr(eng, m.op)(m.channel, m.ids))
