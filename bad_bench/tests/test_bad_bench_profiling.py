"""The trace reduction: busy time as a union of device intervals, idle
gaps split by the host spans, and the byte counts of the rooflines."""
import pytest

torch = pytest.importorskip("torch")

from bad_bench import peaks, profiling  # noqa: E402


def test_busy_time_counts_overlaps_once():
    assert profiling._union([(0, 10), (5, 12), (20, 25)]) == 17


def test_idle_gaps_are_split_by_span():
    dev = [(0, 10, "k"), (20, 30, "k"), (50, 60, "k")]
    spans = [(5, 25, "execute"), (26, 45, "control")]
    cpu = [(12, 15, "aten::to"), (27, 40, "aten::x")]
    got = profiling.idle_gaps(dev, spans, cpu)
    assert got == pytest.approx({"execute": 10e-6, "control/aten::x": 15e-6,
                                 "between ticks": 5e-6})


def test_join_compact_bytes_reads_only_live_sectors():
    tgt = torch.full((4, 16), -1, dtype=torch.int32)
    tgt[0, :3] = 1
    tgt_n = torch.tensor([3, 0, 0, 0], dtype=torch.int32)
    valid = torch.tensor([True, False, False, False])
    z = torch.zeros((4, 16), dtype=torch.int32)
    got = peaks.join_compact_bytes(tgt, tgt_n, z, z, valid,
                                   torch.zeros(4, dtype=torch.int32))
    assert got == 13 * 64 + 9 * 4 + 32 * 1 + 64 * 1


def test_a_kernel_absent_from_the_trace_reads_nothing():
    from bad_bench.metrics import join_compact_roofline
    run = type("Run", (), {"profile": {"by_name": {"other": 1.0},
                                       "bytes": {"join_compact": 10}}})
    assert join_compact_roofline.read(run) is None


class Ev:
    """A profiler event as ``profiling.split_events`` reads one."""

    def __init__(self, name, a, b, cuda=False, id=0):
        from torch.autograd import DeviceType
        self.name, self.id = name, id
        self.time_range = type("TR", (), {"start": a, "end": b})
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU


def test_a_kernel_is_billed_to_the_innermost_program_span():
    """Nested ``bad:`` ranges: a kernel launched inside ``rank`` is
    ``rank``'s, one launched in ``group`` outside it is ``group``'s, one
    launched outside every range is no span's; the ranges' copies on the
    device's timeline are no operations, and the ranges no host operators
    of the idle gaps."""
    events = [
        Ev("span:execute", 0, 100, id=1),
        Ev("bad:dispatch", 1, 90, id=2), Ev("bad:group", 2, 89, id=3),
        Ev("bad:rank", 10, 40, id=4),
        Ev("cudaLaunchKernel", 12, 13, id=100),
        Ev("cudaLaunchKernel", 50, 51, id=101),
        Ev("cudaLaunchKernel", 95, 96, id=102),
        Ev("flash_kernel", 14, 30, cuda=True, id=100),
        Ev("sort_kernel", 52, 55, cuda=True, id=101),
        Ev("fill_kernel", 97, 98, cuda=True, id=102),
        Ev("bad:rank", 10, 40, cuda=True, id=4),
    ]
    dev_ops, spans, ranges, cpu, launched = profiling.split_events(events)
    assert [n for _, _, n in dev_ops] == ["flash_kernel", "sort_kernel",
                                          "fill_kernel"]
    assert launched == [12, 50, 95] and spans == [(0, 100, "execute")]
    assert not any(n.startswith("bad") or n in ("dispatch", "rank")
                   for _, _, n in cpu)
    Rec = type("Rec", (), {})
    rec = Rec()
    rec.name, rec.start_ns, rec.end_ns = "rank", 0, 30_000
    rec.attrs = {"channels": 2, "backend": "pallas", "exact": True}
    got = profiling.program(
        [(a, b, t) for (a, b, _), t in zip(dev_ops, launched)],
        profiling.Ranges(ranges), [rec, rec])
    spans = got["spans"]
    assert spans["rank"]["device_s"] == pytest.approx(16e-6)
    assert spans["group"]["device_s"] == pytest.approx(3e-6)
    assert "dispatch" not in spans
    assert got["unbilled_s"] == pytest.approx(1e-6)
    assert spans["rank"]["host_s"] == pytest.approx(60e-6)
    assert spans["rank"]["count"] == 2
    assert spans["rank"]["counters"] == {"channels": 4}


def _traced(workload, monkeypatch):
    """``BENCHMARK.json``, a traced run's arguments, the list that counts
    the tracer's ``enable`` calls, the list that keeps the run, and
    ``run``."""
    import argparse
    import json
    import pathlib
    from bad_bench import run, system
    from repro_torch.core import trace
    bench = json.loads((pathlib.Path(__file__).resolve().parents[2]
                        / "BENCHMARK.json").read_text())
    on, kept = [], []
    orig_enable, orig_run = trace.enable, system.run
    monkeypatch.setattr(trace, "enable",
                        lambda: (on.append(1), orig_enable())[1])
    monkeypatch.setattr(system, "run",
                        lambda *a, **k: kept.append(orig_run(*a, **k))
                        or kept[-1])
    args = argparse.Namespace(workload=workload, seed=2 ** 31 + 17,
                              seconds=0, trace=1)
    return bench, args, on, kept, run


def test_a_cell_whose_readers_do_not_ask_leaves_the_tracer_off(
        monkeypatch, capsys):
    from bad_bench.tests.tiny import tiny
    cfg, cell = tiny("paper-1m.fused")
    bench, args, on, kept, run = _traced("paper-1m.fused", monkeypatch)
    assert run.measure(bench, cell, cfg, args, torch.device("cpu")) == 0
    assert not on and set(kept[0].profile) == {
        "wall_s", "busy_s", "by_name", "counts", "kernels", "ticks", "gaps",
        "bytes"}


def test_a_reader_of_the_program_spans_turns_the_tracer_on(monkeypatch,
                                                           capsys):
    """A scored cell whose readers are the two enrichment readers: the
    profiled ticks run with the tracer on and the profile holds the
    program's spans, ``rank`` among them (no device operation on the CPU,
    so nothing is billed and ``score_device_ms`` reads nothing)."""
    import json
    from bad_bench.tests.tiny import tiny_scored
    cfg, cell = tiny_scored(budget=32)
    bench, args, on, kept, run = _traced("fixture.scored", monkeypatch)
    bench = dict(bench, per_layer=[
        {"name": n, "unit": u, "workloads": ["fixture.scored"]}
        for n, u in (("enrich_mfu", "%"), ("score_device_ms", "ms"))])
    assert run.measure(bench, cell, cfg, args, torch.device("cpu")) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    r = kept[0]
    assert on and line["correct"]
    rank = r.profile["program"]["spans"]["rank"]
    assert rank["count"] == 2 * r.profile["ticks"] and rank["host_s"] > 0
    assert rank["device_s"] == 0 and "score_device_ms" not in line["metrics"]
    from bad_bench.reference.scorers import dense
    from bad_bench import enrichment, peaks
    work = sum(dense.flops(enrichment.model_settings(cfg["enrichment"]), s,
                           16) for s in r.score_shapes)
    assert len(r.score_shapes) == 2 * r.profile["ticks"]
    assert line["metrics"]["enrich_mfu"]["value"] == pytest.approx(
        100 * work / (r.profile["wall_s"] * peaks.BF16_OPS_PER_S))
