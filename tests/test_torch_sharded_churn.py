"""Port parity for ``repro_torch/core/sharded.py`` under churn, overflow
and ``reshard``, against the reference's ``ShardedBADEngine`` on the 4
forced host devices (the port's shards all on the CPU): the churn-overflow
fuzz through ``run_ticks`` at 1, 2 and 4 shards, and ``TickPipeline``
driving the facade. Everything delivered, drained and counted equals the
reference's; the delivered sID multiset equals a generous-cap single-shard
oracle's (sharding is a physical layout choice). ``reshard`` is in
``test_torch_sharded_reshard.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.churn import ChurnWorkload as JWorkload  # noqa: E402
from repro.core.churn import run_ticks as j_run_ticks  # noqa: E402
from repro.core.plans import ExecutionFlags as JFlags  # noqa: E402
from repro_torch.core.churn import ChurnWorkload, run_ticks  # noqa: E402
from repro_torch.core.plans import ExecutionFlags as TFlags  # noqa: E402

from torch_engine_pairs import COUNTERS  # noqa: E402
from torch_sharded_pairs import (GENEROUS, OVERFLOW_CAPS,  # noqa: E402
                                 batches, counters, delivered, drained, pair, settle,
                                 setup, sub_multiset)

FLAGS = ("window", True, True)
CRIME = "TweetsAboutCrime3"


def _workloads(Workload):
    return [Workload("TweetsAboutDrugs", adds_per_tick=24,
                     removes_per_tick=16, num_brokers=2, user_channel=CRIME,
                     user_churn_per_tick=3),
            Workload("MostThreateningTweets", adds_per_tick=12,
                     removes_per_tick=10, num_brokers=2)]


def _run_ticks(eng, lib, depth=1, ticks=5):
    """The fuzz workload through ``run_ticks`` (``lib`` "ref" or "port"),
    then a settle to empty: (report, sorted pairs, sorted sIDs, live)."""
    sink = {"pairs": [], "sids": []}
    live = {n: np.arange(200, dtype=np.int32)
            for n in ("TweetsAboutDrugs", "MostThreateningTweets")}
    make = batches()[0 if lib == "ref" else 1]
    run = j_run_ticks if lib == "ref" else run_ticks
    Flags = JFlags if lib == "ref" else TFlags
    rep = run(eng, _workloads(JWorkload if lib == "ref" else ChurnWorkload),
              ticks, np.random.default_rng(62), flags=Flags(*FLAGS),
              deliver=True, ingest_per_tick=150, make_batch=make, warmup=1,
              live_sids=live,
              on_tick=lambda t, reps: delivered(reps, sink),
              on_drain=lambda reps: drained(reps, sink),
              pipeline_depth=depth)
    settle(eng, sink)
    return (rep, sorted(sink["pairs"]), sorted(sink["sids"]),
            {k: v.tolist() for k, v in live.items()})


def _engines(num_shards, caps=OVERFLOW_CAPS, reference=True):
    rng = np.random.default_rng(61)
    je, te = pair(num_shards, caps)
    if not reference:
        je = None
    setup(je, te, rng, ("drugs", "threat", "crime"))
    return je, te


@pytest.fixture(scope="module")
def oracle():
    """The port's single shard with generous caps through the same fuzz:
    nothing overflows, so its delivered content is the ground truth."""
    _, te = _engines(1, dict(OVERFLOW_CAPS, **GENEROUS), reference=False)
    rep, pairs, sids, _ = _run_ticks(te, "port")
    assert rep.spilled == rep.dropped == 0
    assert len(sids) > 300
    return pairs, sids


@pytest.mark.multidevice
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_churn_overflow_fuzz_through_run_ticks(multidevice, oracle,
                                               num_shards):
    """Capped engines under churn and sustained overflow, driven by
    ``run_ticks``: the ChurnReport counters, the delivered (row, sID) and
    sID multisets, the surviving population and the per-shard (rebuilds,
    patches) equal the reference's; the sID multiset
    equals the oracle's and the pairs are a sub-multiset of its (pairs whose
    group churned while in a ring go stale by design)."""
    je, te = _engines(num_shards)
    jr, jp, js, jl = _run_ticks(je, "ref")
    tr, tp, ts, tl = _run_ticks(te, "port")
    assert [getattr(jr, k) for k in COUNTERS] == \
        [getattr(tr, k) for k in COUNTERS]
    assert tp == jp and ts == js and tl == jl
    assert counters(je) == counters(te)
    assert tr.maintenance.patches > 0
    assert tr.spilled > 0, "the caps must overflow"
    assert ts == oracle[1]
    assert sub_multiset(tp, oracle[0])


def test_tick_pipeline_drives_the_sharded_engine(oracle):
    """``run_ticks`` at depth 2 (``TickPipeline``, the resolved spill lane,
    batched drains) drives the sharded facade unchanged: its counters and
    delivered sIDs equal depth 1's and the oracle's."""
    _, a = _engines(2, reference=False)
    _, b = _engines(2, reference=False)
    ra, _, sa, la = _run_ticks(a, "port", depth=1)
    rb, _, sb, lb = _run_ticks(b, "port", depth=2)
    keep = [k for k in COUNTERS if k not in ("drain_calls",
                                             "pipeline_depth")]
    assert [getattr(ra, k) for k in keep] == [getattr(rb, k) for k in keep]
    assert rb.pipeline_depth == 2
    assert sa == sb == oracle[1] and la == lb
