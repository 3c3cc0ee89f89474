"""Adaptive runtime planner: per-channel plan selection from observed stats.

The paper's second optimization — "intelligent modifications to the query
plan" — made adaptive: every channel carries its own ``ChannelPlan`` (scan
mode x layout x backend, ``core/plans.py``), ``execute_all`` partitions
channels into plan-groups (one fused call per distinct plan), and the
``RuntimePlanner`` here closes the loop by observing the per-channel stats
the engine already surfaces — selectivity from ``ExecutionReport``, overflow
pressure from ``DeliveryStats``, churn from epoch advances — and switching a
channel's plan through ``BADEngine.set_plan`` under hysteresis (a proposal
must persist for ``patience`` ticks and a switched channel rests for
``cooldown`` ticks), so plan flapping cannot keep re-partitioning the
plan-groups (each switch migrates ring state through the SpillQueue).

Offline seeding: ``search_plans`` times every candidate plan per channel and
``save_plans``/``load_plans``/``apply_plans`` persist the winner assignment
as JSON (``launch/plan_search.py`` is the CLI wrapper). The file format is
the reference package's, so a plan file written by either package loads in
the other.
"""
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import plans
from repro_torch.core.plans import ChannelPlan


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Hysteresis + decision thresholds for the runtime planner.

    ``patience`` consecutive identical proposals are required before a
    switch, and after a switch the channel is frozen for ``cooldown`` ticks:
    every switch re-partitions plan-groups, rebuilds their stacked caches
    and migrates ring state through the SpillQueue (cheap occasionally,
    ruinous every tick)."""

    ema: float = 0.5                 # weight of the newest observation
    patience: int = 2                # identical proposals before switching
    cooldown: int = 4                # ticks a switched channel is frozen
    dense_selectivity: float = 0.5   # results/scanned above -> window scan
    agg_fanout: float = 2.0          # notified/results above -> aggregate
    overflow_pressure: float = 0.25  # (spilled+dropped)/produced above -> agg
    compact_selectivity: float = 0.15  # window-scan sel below -> compact join
    param_pushdown: bool = True      # proposed for every param-join channel
    backend: Optional[str] = None    # force a backend; None keeps current


@dataclasses.dataclass
class ChannelObservation:
    """EMA-smoothed per-channel signals the planner decides from."""

    selectivity: float = 0.0   # num_results / scanned
    fanout: float = 0.0        # num_notified / max(num_results, 1)
    pressure: float = 0.0      # (spilled + dropped) / produced
    ticks: int = 0

    def update(self, sel: float, fan: float, prs: float, ema: float) -> None:
        if self.ticks == 0:
            self.selectivity, self.fanout, self.pressure = sel, fan, prs
        else:
            keep = 1.0 - ema
            self.selectivity = keep * self.selectivity + ema * sel
            self.fanout = keep * self.fanout + ema * fan
            self.pressure = keep * self.pressure + ema * prs
        self.ticks += 1


@dataclasses.dataclass(frozen=True)
class PlanSwitch:
    tick: int
    channel: str
    old: ChannelPlan
    new: ChannelPlan


class RuntimePlanner:
    """Observes fused-execution reports and re-plans channels in place.

    Drive it one call per engine tick::

        reports = engine.execute_all(None, deliver=True)
        planner.step(reports)

    ``step`` returns the switches applied THIS tick (usually none); the full
    history accumulates in ``planner.switches``. The planner only ever talks
    to the engine through ``set_plan`` — ring/spill migration, cache
    re-keying, and plan-group re-partitioning all ride the ``execute_all``
    machinery on the next tick."""

    def __init__(self, engine, config: Optional[PlannerConfig] = None):
        self.engine = engine
        self.config = config or PlannerConfig()
        self.obs: Dict[str, ChannelObservation] = {}
        self.switches: List[PlanSwitch] = []
        self._streak: Dict[str, Tuple[ChannelPlan, int]] = {}
        self._last_switch: Dict[str, int] = {}
        self._tick = 0

    # -- observation ---------------------------------------------------

    def observe(self, reports: Dict) -> None:
        cfg = self.config
        for name, rep in reports.items():
            sel = rep.num_results / max(rep.scanned, 1)
            fan = rep.num_notified / max(rep.num_results, 1)
            prs = 0.0
            o = rep.overflow
            if o is not None:
                produced = (o.delivered_pairs + o.spilled_pairs
                            + o.dropped_pairs + o.delivered_sids
                            + o.spilled_sids + o.dropped_sids)
                if produced:
                    # ring-resident entries count as spilled EVERY call they
                    # are re-presented (the conservation identity needs
                    # that), so raw spill counts overstate pressure exactly
                    # when the retry ring is absorbing the overflow —
                    # subtract the retried volume so a ring doing its job
                    # doesn't flip the channel to aggregated
                    retried = (getattr(o, "retried_pairs", 0)
                               + getattr(o, "retried_sids", 0))
                    prs = max(0, (o.spilled_pairs + o.dropped_pairs
                                  + o.spilled_sids + o.dropped_sids)
                              - retried) / produced
            self.obs.setdefault(name, ChannelObservation()).update(
                sel, fan, prs, cfg.ema)

    # -- decision ------------------------------------------------------

    def propose(self, name: str) -> ChannelPlan:
        """The plan the current observations argue for — no hysteresis."""
        cfg = self.config
        st = self.engine.channels[name]
        cur = self.engine.channel_plan(name)
        ob = self.obs.get(name)
        if ob is None or ob.ticks == 0:
            return cur
        # sparse channels want the BAD index (watermark-bounded candidate
        # discovery); dense ones can stay on a window scan. The selectivity
        # gate applies on ENTRY only: once on bad_index the observed
        # selectivity is measured against the index's own pre-filtered
        # candidate set (it reads ~1.0 exactly when the index filters
        # perfectly), so an exit threshold on the same signal would evict
        # the index for doing its job and flap every cooldown. "full" is
        # never proposed: it only exists as the paper's unoptimized
        # baseline.
        if not st.spec.fixed_preds:
            scan = "window"
        elif (cur.scan_mode == "bad_index"
              or ob.selectivity < cfg.dense_selectivity):
            scan = "bad_index"
        else:
            scan = "window"
        # aggregation collapses per-subscription rows into per-group slots:
        # worth it when fanout amortizes the group join, or when flat-layout
        # volume is overflowing the delivery caps
        agg = (ob.fanout >= cfg.agg_fanout
               or ob.pressure >= cfg.overflow_pressure)
        pushdown = cfg.param_pushdown and st.spec.join == "param"
        backend = cfg.backend or cur.backend
        if cfg.backend is None:
            # the compact join pays off when a wide scan yields few live
            # candidates but the channel cannot use the BAD index (no fixed
            # predicates pins it to a window scan): the padded grid is
            # mostly dead slots and the CSR stream collapses it. Dense
            # channels propose the padded fused join of the same backend
            # family (compaction would just add scatter overhead).
            if (scan == "window" and not st.spec.fixed_preds
                    and ob.selectivity < cfg.compact_selectivity):
                backend = plans.compact_variant(backend)
            else:
                backend = ("pallas"
                           if plans.backend_family(backend) == "pallas"
                           else "oracle")
        return ChannelPlan(scan, agg, pushdown, backend)

    def step(self, reports: Dict) -> List[PlanSwitch]:
        """Observe one tick's reports, then switch any channel whose
        proposal survived ``patience`` ticks and is out of ``cooldown``."""
        self._tick += 1
        self.observe(reports)
        applied: List[PlanSwitch] = []
        for name in reports:
            if name not in self.engine.channels:
                continue
            cur = self.engine.channel_plan(name)
            want = self.propose(name)
            if want == cur:
                self._streak.pop(name, None)
                continue
            prev, n = self._streak.get(name, (None, 0))
            n = n + 1 if prev == want else 1
            self._streak[name] = (want, n)
            if n < self.config.patience:
                continue
            last = self._last_switch.get(name)
            if last is not None and self._tick - last < self.config.cooldown:
                continue
            self.engine.set_plan(name, want)
            self._streak.pop(name, None)
            self._last_switch[name] = self._tick
            sw = PlanSwitch(self._tick, name, cur, want)
            self.switches.append(sw)
            applied.append(sw)
        return applied

    def stable_since(self) -> Optional[int]:
        """Tick of the last switch (None if never switched): snapshot
        ``engine.maintenance`` after this to show zero rebuilds under a
        stable assignment."""
        return self.switches[-1].tick if self.switches else None


# ---------------------------------------------------------------------------
# offline plan seeding + persistence
# ---------------------------------------------------------------------------

def search_plans(engine, candidates: Optional[Tuple[ChannelPlan, ...]] = None,
                 repeats: int = 2) -> Dict[str, dict]:
    """Time every candidate plan per channel and return the winners.

    The offline analogue of the runtime planner: measures real per-channel
    ``execute_channel`` wall time (best of ``repeats``) for each candidate
    on the engine's device. One untimed execution per candidate first (it
    builds the kernels at their first use and, for the compact backends,
    converges the stream-capacity bucket), so winners are chosen by
    execution time, never by build time. Candidates default to every (scan x layout)
    under the engine's backend family plus its compact variant; each
    candidate runs under its own ``plan.backend`` via the
    ``execute_channel`` backend override. Watermarks are left untouched
    (``advance=False``): searching must not consume the BAD index's pending
    deltas."""
    if candidates is None:
        backend = "pallas" if engine.use_pallas else "oracle"
        candidates = plans.enumerate_plans(
            backends=(backend, plans.compact_variant(backend)))
    out: Dict[str, dict] = {}
    for name in engine.channels:
        rows = []
        for cand in candidates:
            engine.execute_channel(name, cand.flags, advance=False,
                                   timed=False, backend=cand.backend)
            walls = [engine.execute_channel(name, cand.flags, advance=False,
                                            timed=True,
                                            backend=cand.backend).wall_time_s
                     for _ in range(repeats)]
            rows.append({"plan": cand.to_dict(),
                         "wall_s": float(np.min(walls))})
        rows.sort(key=lambda r: r["wall_s"])
        out[name] = {"best": rows[0]["plan"], "candidates": rows}
    return out


def save_plans(path: str, assignment: Dict[str, ChannelPlan],
               meta: Optional[dict] = None) -> None:
    doc = {"plans": {n: p.to_dict() for n, p in assignment.items()}}
    if meta:
        doc["meta"] = meta
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)


def load_plans(path: str) -> Dict[str, ChannelPlan]:
    with open(path) as f:
        doc = json.load(f)
    return {n: ChannelPlan.from_dict(d) for n, d in doc["plans"].items()}


def apply_plans(engine, assignment: Dict[str, ChannelPlan]) -> int:
    """Set each named channel's plan (unknown names ignored); returns the
    number of channels whose plan actually changed."""
    changed = 0
    for name, plan in assignment.items():
        if name in engine.channels:
            changed += int(engine.set_plan(name, plan))
    return changed
