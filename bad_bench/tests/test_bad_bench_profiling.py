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
