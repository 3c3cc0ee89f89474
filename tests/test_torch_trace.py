"""The program's tracer (``repro_torch/core/trace.py``) on small engines of
the port, on the CPU: off, it records nothing and changes nothing; on, its
span tree, execution ids and ``read.*`` spans hold, its rebuild spans
count what ``MaintenanceStats`` counts, and under ``torch.profiler`` each
span has its ``bad:`` range. Then the reduction of ``tools/trace_cell.py``
on synthetic profiler events and on the records of a few churn ticks. On
a card (marker ``gpu``), CUDA's sync check finds no wait for the device
outside a ``read.*`` span."""
import dataclasses
import importlib.util
import pathlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import channel as CH  # noqa: E402
from repro_torch.core import records as R  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.engine import BADEngine  # noqa: E402
from repro_torch.core.plans import ChannelPlan  # noqa: E402
from repro_torch.core.runtime import TickPipeline  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402

from torch_parity import cuda_device  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 1234
CONTROL = ("subscribe_bulk", "remove_subscriptions", "subscribe_users",
           "unsubscribe_users")
DRUGS, THREAT, CRIME = (s.name for s in (CH.tweets_about_drugs(),
                                         CH.most_threatening_tweets(),
                                         CH.tweets_about_crime(3)))
USERS = 300


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", ROOT / "tools" / "trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()


class Cell:
    """A small engine of the main path's shape and its ticks: the two param
    channels on ``compact_pallas`` over population-skewed subscriptions on
    4 brokers and, with ``churn``, TweetsAboutCrime3 on ``pallas`` over a
    cohort of 150 users, with adds, removes and cohort changes before every
    tick; then 512 tweets (10% forced to match TweetsAboutDrugs),
    ``execute_all(None, deliver=True)`` and ``drain_spilled``."""

    def __init__(self, churn: bool = True, dev=CPU):
        self.rng = np.random.default_rng(SEED)
        self.dev, self.churn, self.now = dev, churn, 0
        self.eng = BADEngine(dataset_capacity=4096, index_capacity=1 << 15,
                             max_window=1 << 12, max_candidates=1 << 12,
                             frame_bytes=4096,
                             brokers=tuple(f"Broker{i}" for i in range(4)),
                             use_pallas=True, max_deliver_pairs=1024,
                             max_notify=1 << 15, device=dev)
        specs = [CH.tweets_about_drugs(), CH.most_threatening_tweets()]
        if churn:
            specs.append(CH.tweets_about_crime(3))
        for spec in specs:
            self.eng.create_channel(spec)
        self.live = {}
        for name, n in ((DRUGS, 2500), (THREAT, 500)):
            params, brokers = syn.subscriptions_by_population(self.rng, n, 4)
            self.live[name] = self.eng.subscribe_bulk(name, params, brokers)
            self.eng.set_plan(name, ChannelPlan("bad_index", True, True,
                                                "compact_pallas"))
        if churn:
            self.eng.set_user_locations(*self.users())
            self.eng.subscribe_users(CRIME, self.rng.choice(USERS, 150,
                                                            replace=False))
            self.eng.set_plan(CRIME, ChannelPlan("bad_index", True, True,
                                                 "pallas"))

    def users(self):
        return (self.rng.uniform(-100, 100, (USERS, 2)).astype(np.float32),
                self.rng.integers(0, 4, USERS))

    def control_and_ingest(self):
        if self.churn:
            for name, n in ((DRUGS, 25), (THREAT, 5)):
                params, brokers = syn.subscriptions_by_population(
                    self.rng, n, 4)
                new = self.eng.subscribe_bulk(name, params, brokers)
                gone = self.rng.choice(self.live[name], n, replace=False)
                assert self.eng.remove_subscriptions(name, gone) == n
                self.live[name] = np.concatenate(
                    [np.setdiff1d(self.live[name], gone), new])
            self.eng.unsubscribe_users(CRIME, self.rng.integers(0, USERS, 8))
            self.eng.subscribe_users(CRIME, self.rng.integers(0, USERS, 8))
        self.now += 100
        f, loc = syn.tweet_arrays(self.rng, 512, self.now)
        syn.drug_tweak(f, self.rng)
        self.eng.ingest(R.RecordBatch.from_numpy(f, loc, device=self.dev))

    def tick(self):
        self.control_and_ingest()
        out = self.eng.execute_all(None, deliver=True, timed=False)
        return out, self.eng.drain_spilled()


def _children(records):
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)
    return kids


def test_off_records_nothing_and_span_is_the_shared_noop():
    assert trace.span("dispatch") is trace.NOOP
    assert trace.span("group", channels=3) is trace.NOOP
    c = Cell()
    for _ in range(2):
        c.tick()
    assert trace.collect() == []
    trace.enable()
    assert trace.span("dispatch") is not trace.NOOP


def _snapshot(eng, out, drained):
    reps = {n: (r.num_results, r.num_notified, r.broker_bytes.tolist(),
                dataclasses.astuple(r.overflow),
                [t.clone() for t in r.result]) for n, r in out.items()}
    drains = {n: dataclasses.astuple(d.stats) for n, d in drained.items()}
    rings = {k: (v[0], v[1], [t.clone() for t in v[2]])
             for k, v in eng._rings.items()}
    queue = (eng.spill.pending_pairs(), eng.spill.pending_sids(),
             sorted(eng.spill.pair_keys(), key=str), eng.spill.sid_keys())
    return reps, drains, rings, queue


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("churn", [False, True], ids=["steady", "churn"])
def test_reports_rings_and_queues_are_the_same_on_and_off(churn):
    off, on = Cell(churn), Cell(churn)
    for _ in range(3):
        a = _snapshot(off.eng, *off.tick())
        trace.enable()
        b = _snapshot(on.eng, *on.tick())
        trace.disable()
        assert _same(a, b)
    assert torch.equal(off.eng.dataset.fields, on.eng.dataset.fields)
    assert trace.collect()


def test_span_tree_nesting_and_execution_ids():
    c = Cell()
    c.tick()
    trace.enable()
    c.tick()
    trace.disable()
    recs = trace.collect()
    kids = _children(recs)
    roots = kids[None]
    names = [r.name for r in roots]
    assert names[-4:] == ["ingest", "dispatch", "sync", "drain"], names
    assert set(names[:-4]) == set(CONTROL), names
    dispatch = roots[-3]
    assert all(r.execution == dispatch.execution for r in roots[:-1])
    assert roots[-1].execution == dispatch.execution + 1
    assert all(r.execution == dispatch.execution for r in recs
               if r.name != "drain" and r.parent is not None
               and r.name != "read.drain")
    assert [r.name for r in kids[roots[-4].id]] == ["read.index_insert"]
    groups = kids[dispatch.id]
    assert [r.name for r in groups] == ["group", "group", "advance"]
    by_backend = {g.attrs["backend"]: g for g in groups[:2]}
    assert {g.attrs["scan"] for g in groups[:2]} == {"bad_index"}
    assert by_backend["compact_pallas"].attrs["channels"] == 2
    assert by_backend["pallas"].attrs["channels"] == 1
    assert [r.name for r in kids[by_backend["compact_pallas"].id]] == [
        "read.watermarks", "caches", "discover", "read.stream_totals",
        "join", "deliver"]
    assert [r.name for r in kids[by_backend["pallas"].id]] == [
        "read.watermarks", "caches", "discover", "join", "deliver"]
    for g in groups[:2]:
        caches = next(r for r in kids[g.id] if r.name == "caches")
        inside = [r.name for r in kids.get(caches.id, [])]
        assert inside and set(inside) <= {"patch", "rebuild"}, inside
    sync = roots[-2]
    mats = kids[sync.id]
    assert [r.name for r in mats] == ["materialize", "materialize"]
    for m in mats:
        assert [r.name for r in kids[m.id]] == ["read.reports", "accounting"]
        read = kids[m.id][0]
        assert read.attrs["bytes"] > 0 and read.attrs["bytes"] % 4 == 0
    assert {r.name for r in kids.get(roots[-1].id, [])} <= {"read.drain"}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = next(q for q in recs if q.id == r.parent)
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_a_deferred_sync_carries_its_dispatch_id():
    c = Cell(churn=False)
    pipe = TickPipeline(c.eng, depth=2)
    trace.enable()
    for _ in range(3):
        c.control_and_ingest()
        pipe.step(None, deliver=True)
    pipe.flush()
    trace.disable()
    roots = [r for r in trace.collect() if r.parent is None]
    dispatches = [r for r in roots if r.name == "dispatch"]
    syncs = [r for r in roots if r.name == "sync"]
    assert len(dispatches) == len(syncs) == 3
    assert [s.execution for s in syncs] == [d.execution for d in dispatches]
    # each sync ran after the next tick's dispatch
    for s, d in zip(syncs, dispatches[1:]):
        assert s.start_ns > d.end_ns
    ingests = [r for r in roots if r.name == "ingest"]
    assert [r.execution for r in ingests] == [d.execution
                                              for d in dispatches]


HOST_READS = ("cpu", "tolist", "item", "nonzero", "__int__", "__float__",
              "__bool__", "__index__")


@pytest.mark.parametrize("churn", [True, False], ids=["churn", "steady"])
def test_every_host_read_on_the_tick_path_is_a_read_span(churn, monkeypatch):
    c = Cell(churn)
    c.tick()
    seen, stray = [], []

    def watch(name, fn):
        def read(self, *a, **k):
            if trace._open:
                path = "/".join(s.name for s in trace._open)
                if any(s.name.startswith("read.") for s in trace._open):
                    seen.append(path)
                else:
                    stray.append(f"{path}: Tensor.{name}")
            return fn(self, *a, **k)
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            watch(name, getattr(torch.Tensor, name)))
    trace.enable()
    for _ in range(2):
        c.tick()
    trace.disable()
    monkeypatch.undo()
    assert not stray, sorted(set(stray))
    kinds = {p.split("/")[-1] for p in seen}
    assert {"read.index_insert", "read.watermarks", "read.stream_totals",
            "read.reports"} <= kinds, kinds


def test_rebuild_spans_count_the_rebuilds_and_steady_churn_patches():
    c = Cell()
    c.tick()
    before = c.eng.maintenance.snapshot()
    trace.enable()
    for _ in range(3):
        c.tick()
    trace.disable()
    recs = trace.collect()
    delta = c.eng.maintenance.since(before)
    assert sum(r.name == "rebuild" for r in recs) == delta.rebuilds == 0
    patched = [r for r in recs if r.name == "patch"]
    assert patched and all(r.attrs["applied"] for r in patched)
    assert delta.patches >= len(patched)
    # a changed user table rebuilds the spatial cache: one span, one count
    before = c.eng.maintenance.snapshot()
    c.eng.set_user_locations(*c.users())
    trace.enable()
    c.tick()
    trace.disable()
    recs = trace.collect()
    delta = c.eng.maintenance.since(before)
    assert sum(r.name == "rebuild" for r in recs) == delta.rebuilds == 1
    assert next(r for r in recs if r.name == "rebuild").attrs == {
        "layout": "spatial"}


def test_each_span_has_its_profiler_range():
    """Names and nesting on every profiled tick; each span's duration
    within 50 us of its range's on at least one of three ticks of the same
    spans (the host's cores are shared: a thread descheduled between the
    two clocks' readings widens one tick's difference, not three)."""
    from torch.profiler import ProfilerActivity, profile
    c = Cell()
    c.tick()
    names, diffs = None, []
    for _ in range(3):
        trace.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # the session's first range pays the profiler's start-up
            with torch.profiler.record_function("start-up"):
                pass
            c.tick()
        trace.disable()
        recs = trace.collect()
        events = sorted((e for e in prof.events()
                         if e.name.startswith("bad:")),
                        key=lambda e: e.time_range.start)
        assert [e.name[4:] for e in events] == [r.name for r in recs]
        assert names in (None, [r.name for r in recs])
        names = [r.name for r in recs]
        at = {r.id: i for i, r in enumerate(recs)}
        index = {id(e): i for i, e in enumerate(events)}
        for r, e in zip(recs, events):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("bad:"):
                p = p.cpu_parent
            want = None if r.parent is None else at[r.parent]
            assert (None if p is None else index[id(p)]) == want, r.name
        diffs.append([abs((r.end_ns - r.start_ns) / 1e3
                          - (e.time_range.end - e.time_range.start))
                      for r, e in zip(recs, events)])
    best = [min(d) for d in zip(*diffs)]
    assert max(best) <= 50, sorted(zip(best, names))[-3:]
    # no profiler: the spans are recorded, no range is opened
    trace.enable()
    with trace.span("alone") as sp:
        assert sp.mark is None


# -- the reduction of tools/trace_cell.py, on synthetic events -------------

class Ev:
    """A profiler event as ``trace_cell.split_events`` reads one."""

    def __init__(self, name, a, b, cuda=False, id=0):
        from torch.autograd import DeviceType
        self.name, self.id = name, id
        self.time_range = type("TR", (), {"start": a, "end": b})
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU


def _tick_events():
    """One tick: the benchmark's ``execute`` span over dispatch > group >
    (read.stream_totals, deliver); a kernel launched inside ``deliver``, a
    copy inside the read, a kernel launched outside every program range
    and one with no launch in the trace, each device operation sharing its
    id with the CUDA call that launched it (an operator's id may repeat
    one: ``aten::index`` and the copy's launch), and the annotations'
    copies on the device's timeline."""
    return [
        Ev("span:execute", 0, 100, id=1),
        Ev("bad:dispatch", 1, 90, id=2),
        Ev("bad:group", 2, 89, id=3),
        Ev("bad:read.stream_totals", 10, 40, id=4),
        Ev("aten::to", 11, 39, id=5),
        Ev("cudaMemcpyAsync", 12, 38, id=101),
        Ev("bad:deliver", 41, 60, id=6),
        Ev("aten::index", 42, 44, id=101),
        Ev("cudaLaunchKernel", 43, 44, id=100),
        Ev("aten::copy_", 95, 96, id=8),
        Ev("cudaLaunchKernel", 95.5, 95.8, id=102),
        Ev("kernel_a", 5, 12, cuda=True, id=99),
        Ev("Memcpy DtoH", 38, 39, cuda=True, id=101),
        Ev("gather_kernel", 45, 55, cuda=True, id=100),
        Ev("fill_kernel", 97, 98, cuda=True, id=102),
        Ev("bad:deliver", 41, 60, cuda=True, id=6),
        Ev("bad:dispatch", 1, 90, cuda=True, id=2),
    ]


def test_a_device_copy_of_a_program_range_is_not_device_work():
    tc = _tool()
    ops, spans, ranges, cpu = tc.split_events(_tick_events())
    names = [name for _, _, name, _ in ops]
    assert not any(n.startswith("bad:") for n in names)
    assert sorted(names) == ["Memcpy DtoH", "fill_kernel", "gather_kernel",
                             "kernel_a"]
    assert sorted((a, b) for a, b, _, _ in ops) == [(5, 12), (38, 39),
                                                    (45, 55), (97, 98)]
    assert spans == [(0, 100, "execute")]
    assert not any(n.startswith("bad:") for _, _, n in cpu)


def test_an_idle_gap_is_labelled_by_the_innermost_program_span():
    tc = _tool()
    ops, spans, ranges, cpu = tc.split_events(_tick_events())
    gaps, inside, below = tc.program_gaps(ops, spans, cpu,
                                          tc.Ranges(ranges))
    # gaps 12-38, 39-45 and 55-97, cut where a program range opens or
    # closes; aten::to is open where the first begins
    assert gaps == pytest.approx({
        "execute/read.stream_totals/aten::to": 27e-6, "execute/group": 30e-6,
        "execute/deliver": 9e-6, "execute/dispatch": 1e-6, "execute": 7e-6})
    assert inside == pytest.approx(74e-6)
    assert below == pytest.approx(66e-6)


def test_a_kernel_launched_inside_deliver_is_billed_to_deliver():
    tc = _tool()
    ops, _, ranges, _ = tc.split_events(_tick_events())
    billed, unbilled = tc.bill(ops, tc.Ranges(ranges))
    assert billed == pytest.approx({"deliver": 10e-6,
                                    "read.stream_totals": 1e-6})
    # kernel_a has no launching operator, fill_kernel's lies outside every
    # range: both unbilled; billed plus unbilled is every operation's time
    assert unbilled == pytest.approx(8e-6)
    assert sum(billed.values()) + unbilled == pytest.approx(
        sum((b - a) * 1e-6 for a, b, _, _ in ops))


def test_the_readers_read_nothing_without_program_records():
    tc = _tool()
    assert tc.window_values([], 10) is None
    assert tc.device_values(None) is None
    assert tc.device_values({"program": {"ranges": 0}, "ticks": 3}) is None


def test_a_tiny_traced_churn_run_reads_the_program_values():
    """The window's values from the records of three churn ticks; then
    one profiled tick, whose program ranges the reduction finds (no device
    operation on the CPU, so nothing is billed)."""
    tc = _tool()
    c = Cell()
    c.tick()
    trace.enable()
    for _ in range(3):
        c.tick()
    trace.disable()
    w = tc.window_values(trace.collect(), 3)
    assert w["patch_ms"] > 0 and w["remove_ms"] > 0
    assert w["host_read_ms"] > 0 and w["rebuilds_per_tick"] == 0
    # 2 watermark reads, 1 stream-totals read, 2 report reads and ingest's
    # count a tick
    assert w["host_reads_per_tick"] == 6, w["reads_per_tick"]
    assert w["read_bytes_per_tick"] > 0
    from torch.profiler import ProfilerActivity, profile
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.tick()
    trace.disable()
    recs = trace.collect()
    ops, spans, ranges, _ = tc.split_events(prof.events())
    assert ops == [] and spans == []
    assert sorted(n for _, _, n in ranges) == sorted(r.name for r in recs)
    assert tc.bill(ops, tc.Ranges(ranges)) == ({}, 0.0)


class _SyncsAllowed:
    """A ``read.*`` span with CUDA's sync check off while it is open."""

    def __init__(self, inner):
        self.inner = inner

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        return self.inner.__enter__()

    def __exit__(self, *exc):
        out = self.inner.__exit__(*exc)
        torch.cuda.set_sync_debug_mode(self.mode)
        return out


@pytest.mark.gpu
@pytest.mark.parametrize("churn", [True, False], ids=["churn", "steady"])
def test_on_the_card_the_host_waits_only_in_read_spans(churn, cuda_device,
                                                       monkeypatch):
    """CUDA's own sync check (``torch.cuda.set_sync_debug_mode``) over
    three ticks, switched off inside ``read.*`` spans: it sees every wait
    for the stream, those inside PyTorch's C++ too (a blocking copy from
    the host, ``nonzero``), so what it reports outside them is a wait that
    ``host_read_ms`` would miss."""
    c = Cell(churn, cuda_device)
    c.tick()
    torch.cuda.synchronize()
    span = trace.span

    def checked(name, execution=None, **attrs):
        inner = span(name, execution, **attrs)
        return _SyncsAllowed(inner) if name.startswith("read.") else inner

    monkeypatch.setattr(trace, "span", checked)
    stray = []
    trace.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(3):
                c.tick()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            trace.disable()
    for w in caught:
        # c10's own text; the mode's first setting warns of its own
        # limits, which is not a wait
        if "called a synchronizing CUDA operation" in str(w.message):
            stray.append(f"{pathlib.Path(w.filename).name}:{w.lineno}")
    assert not stray, sorted(set(stray))
    # ingest's count, a group's watermarks and reports, the compact group's
    # stream totals: 6 reads a tick over two plan-groups, 4 over one
    reads = sum(r.name.startswith("read.") for r in trace.collect())
    assert reads >= 3 * (6 if churn else 4), reads
