"""The comparison that decides ``correct``, on tiny runs on the CPU: a
sound run passes, and each fault planted in what the program produces,
or in the timed path underneath, comes out as not correct."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bad_bench import check, control, system  # noqa: E402
from bad_bench import traffic as T  # noqa: E402
from bad_bench.reference import reference  # noqa: E402
from bad_bench.tests.tiny import tiny  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def judged(cell_name, seconds=0.6, seed=SEED, patch=None, monkeypatch=None):
    cfg, cell = tiny(cell_name)
    if patch is not None:
        patch(monkeypatch)
    run = system.run(cfg, cell, seed, seconds, False, CPU, 0.0)
    want = reference.expected(cfg, cell, seed, len(run.ticks),
                              set(run.sampled), CPU)
    return run, want, cfg


def numbers(run, want, cfg):
    return check.compare(run, want, cfg, CPU)


@pytest.mark.parametrize("cell", ["paper-1m.fused", "trending-2lang.fused",
                                  "paper-1m.churn"])
def test_a_sound_run_is_correct(cell):
    run, want, cfg = judged(cell)
    got = numbers(run, want, cfg)
    assert check.correct(got), got
    assert run.sampled and len(run.window) >= 1


@pytest.fixture(scope="module")
def churn_run():
    return judged("paper-1m.churn", seconds=1.0)


def _bad(got, *names):
    return not check.correct(got) and all(got[n][0] > 0 for n in names)


def test_one_sid_dropped_is_caught(churn_run):
    run, want, cfg = churn_run
    k, per = next(iter(run.sampled.items()))
    name = next(n for n, (_, s) in per.items() if len(s))
    lines, sids = per[name]
    run.sampled[k] = dict(per, **{name: (lines, sids[1:])})
    try:
        assert _bad(numbers(run, want, cfg), "sid_mismatch")
    finally:
        run.sampled[k] = per


def test_a_notified_count_off_by_one_is_caught(churn_run):
    run, want, cfg = churn_run
    t = run.ticks[-1]
    name = next(iter(t.reports))
    old = t.reports[name]
    t.reports[name] = (old[0], old[1] + 1, old[2], old[3])
    try:
        assert _bad(numbers(run, want, cfg), "count_mismatch")
    finally:
        t.reports[name] = old


def _keep_one_live(monkeypatch):
    from repro_torch.core.engine import BADEngine
    orig = BADEngine.remove_subscriptions

    def remove(self, channel, sids):
        sids = np.asarray(sids)
        return orig(self, channel, sids[1:]) + int(len(sids) > 0)

    monkeypatch.setattr(BADEngine, "remove_subscriptions", remove)


def test_a_churned_subscription_left_live_is_caught(monkeypatch):
    got = numbers(*judged("paper-1m.churn", seconds=1.0,
                          patch=_keep_one_live, monkeypatch=monkeypatch))
    assert _bad(got, "count_mismatch")


def _unchanged_ingest(monkeypatch):
    from repro_torch.core.engine import BADEngine
    orig, calls = BADEngine.ingest, []

    def ingest(self, batch):
        calls.append(1)
        if len(calls) > 5:          # after the pre-load (4 chunks), 1 tick
            return np.zeros(0, np.int32)
        return orig(self, batch)

    monkeypatch.setattr(BADEngine, "ingest", ingest)


def test_a_step_that_leaves_its_state_unchanged_is_caught(monkeypatch):
    got = numbers(*judged("paper-1m.fused", patch=_unchanged_ingest,
                          monkeypatch=monkeypatch))
    assert _bad(got, "ring_row_mismatch", "count_mismatch")


def _half_batch(monkeypatch):
    from repro_torch.core import records as R
    orig = R.RecordBatch.from_numpy

    def half(fields, location=None, device="cuda"):
        n = fields.shape[0]
        if n == 512:                # a tick's batch, not the pre-load's
            fields, location = fields[:n // 2], location[:n // 2]
        return orig(fields, location, device)

    monkeypatch.setattr(R.RecordBatch, "from_numpy", staticmethod(half))


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    got = numbers(*judged("trending-2lang.fused", patch=_half_batch,
                          monkeypatch=monkeypatch))
    assert _bad(got, "count_mismatch")


def _altered_sid(monkeypatch):
    from repro_torch.core import broker
    orig = broker.deliver_all

    def deliver_all(*a, **k):
        out = orig(*a, **k)
        out.fan.notify[0, 0] += 1        # one sID altered where produced
        return out

    monkeypatch.setattr(broker, "deliver_all", deliver_all)
    import repro_torch.core.engine as E
    monkeypatch.setattr(E, "deliver_all", deliver_all)


def test_an_answer_altered_where_produced_is_caught(monkeypatch):
    got = numbers(*judged("paper-1m.fused", patch=_altered_sid,
                          monkeypatch=monkeypatch))
    assert _bad(got, "sid_mismatch")


@pytest.mark.parametrize("cell", ["paper-1m.fused", "trending-2lang.fused",
                                  "paper-1m.churn"])
def test_the_control_is_not_correct(cell):
    """The reference one precision step down, in the program's place,
    fails; at the configuration's precision it passes."""
    cfg, c = tiny(cell)
    sampled = T.sample_ticks(SEED, 0, 8, 1.0, c["samples"])
    want = reference.expected(cfg, c, SEED, 8, sampled, CPU)
    assert check.correct(check.compare(control.as_run(want, cfg, c), want,
                                       cfg, CPU))
    got = control.control_numbers(cfg, c, SEED, 8, CPU)
    assert not check.correct(got)
    assert got["count_mismatch"][0] > 0 and got["pair_mismatch"][0] > 0
