"""The port's checkpoint manager, fault runtime and train loop
(``repro_torch/ckpt``, ``runtime/failure.py``, ``launch/train.py``):
mirrors of the checkpoint and fault tests of ``test_substrate.py`` and
``test_broker_and_train.py``; a bit-exact bf16 round trip (no
``ml_dtypes``); a save followed by an in-place update before ``wait()``;
and the port's ``train()`` against the reference's on reduced
tinyllama-1.1b for 6 steps from the same parameters: equal batches, losses
within 1e-4 relative (float32, six AdamW steps; the update's sign-like
first steps carry the gradients' 1e-6 differences along)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager, leaf_names  # noqa
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.runtime.failure import (FailureInjector,  # noqa: E402
                                         StepTimer, largest_valid_mesh,
                                         run_with_recovery)

from torch_parity import one_thread  # noqa: E402,F401

TRAIN_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here on one intra-op thread (``torch_parity.one_thread``)."""


def test_checkpoint_roundtrip_and_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": tree["a"] + step,
                        "nested": {"b": tree["nested"]["b"] + step}})
    assert mgr.all_steps() == [2, 3]
    got = mgr.restore(3, tree)
    assert torch.equal(got["a"], tree["a"] + 3)
    assert got["nested"]["b"].dtype == torch.int32
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"] + 3)


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, {"w": torch.ones((128, 128))})
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_restore_onto_a_device_and_shape_check(tmp_path):
    """``restore(step, like, device)`` in place of the reference's elastic
    re-sharding: the leaves land on the device asked for, in ``like``'s
    dtypes; a shape that differs raises."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    mgr.save(1, tree)
    got = mgr.restore(1, tree, device="cpu")
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], tree["w"])
    like64 = {"w": torch.zeros((4, 4), dtype=torch.float64)}
    assert mgr.restore(1, like64)["w"].dtype == torch.float64
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, {"w": torch.zeros((2, 8))})


def test_bf16_round_trip_is_bit_exact(tmp_path):
    """A bf16 leaf is stored as its int16 bits with "bfloat16" in the
    manifest, and comes back bit for bit (NaN, infinities and subnormals
    included)."""
    bits = torch.tensor(np.random.default_rng(0).integers(
        -2 ** 15, 2 ** 15, 4096), dtype=torch.int16)
    bits[:4] = torch.tensor([0x7FC0, 0x7F80, -0x0080, 0x0001],
                            dtype=torch.int16)   # NaN, inf, -inf, subnormal
    w = bits.view(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    path = mgr.save(7, {"w": w})
    with open(os.path.join(path, "manifest.json")) as f:
        entry = json.load(f)["leaves"][0]
    assert entry == {"name": "w", "shape": [4096], "dtype": "bfloat16"}
    got = mgr.restore(7, {"w": torch.zeros(4096, dtype=torch.bfloat16)})["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), bits)


def test_snapshot_survives_an_in_place_update(tmp_path):
    """``save`` copies before it returns: an in-place update of the saved
    tensors (the port's optimizers write in place) before ``wait()`` does
    not reach the checkpoint."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int32)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"w": w, "count": count})
    w.add_(1.0)
    count.add_(5)
    mgr.wait()
    got = mgr.restore(1, {"w": w, "count": count})
    assert torch.equal(got["w"], torch.arange(1 << 16, dtype=torch.float32))
    assert int(got["count"]) == 0 and got["count"].dtype == torch.int32


def test_leaf_names_unique_and_stable():
    state = AdamWState(torch.zeros((), dtype=torch.int32),
                       {"layers": [{"wq": torch.zeros(2)}]},
                       {"layers": [{"wq": torch.zeros(2)}]})
    tree = {"params": {"layers": [{"wq": torch.zeros(2)},
                                  {"wq": torch.zeros(2)}]}, "opt": state}
    assert leaf_names(tree) == ["params.layers.0.wq", "params.layers.1.wq",
                                "opt.count", "opt.m.layers.0.wq",
                                "opt.v.layers.0.wq"]
    assert leaf_names(torch.zeros(1)) == ["root"]
    with pytest.raises(ValueError, match="share"):
        leaf_names({"a.b": torch.zeros(1), "a": {"b": torch.zeros(1)}})


def test_writer_error_is_raised_by_wait(tmp_path):
    """A write that fails in the writer thread (here: the directory was
    replaced by a file) is raised by ``wait()``, not lost."""
    root = tmp_path / "ck"
    mgr = CheckpointManager(str(root), async_save=True)
    os.rmdir(root)
    root.write_text("not a directory")
    mgr.save(2, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    mgr.wait()                          # raised once


# ---------------------------------------------------------------------------
# fault tolerance (copies of the reference's runtime/failure.py)
# ---------------------------------------------------------------------------


def test_straggler_detection():
    t = StepTimer(ema_alpha=1.0)
    for w, dt in [("h0", 1.0), ("h1", 1.1), ("h2", 0.9), ("h3", 5.0)]:
        t.record(w, dt)
    assert t.stragglers() == ["h3"]


def test_run_with_recovery_resumes_through_failures(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    injector = FailureInjector(fail_at=(7, 13))
    state = {"step": torch.zeros(())}

    def restore():
        s = mgr.latest_step()
        return s if s is not None else 0

    def loop(start):
        for step in range(start, 20):
            injector.maybe_fail(step)
            if (step + 1) % 5 == 0:
                mgr.save(step + 1, state)
        return 20

    out = run_with_recovery(loop, lambda s: None, restore, 20, 5)
    assert out["final_step"] == 20
    assert out["restarts"] == 2
    assert injector.failures == 2


def test_largest_valid_mesh():
    assert largest_valid_mesh(256, 16) == (16, 16)
    assert largest_valid_mesh(240, 16) == (8, 16)
    with pytest.raises(ValueError):
        largest_valid_mesh(8, 16)


def test_token_stream_matches_the_reference():
    for hosts, host in ((1, 0), (2, 1)):
        port = TokenStream(vocab_size=100, seq_len=16, global_batch=8,
                           num_hosts=hosts, host_id=host)
        ref = JTokenStream(vocab_size=100, seq_len=16, global_batch=8,
                           num_hosts=hosts, host_id=host)
        for step in (0, 3):
            a, b = port.batch(step), ref.batch(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    a = TokenStream(vocab_size=100, seq_len=16, global_batch=8).batch(3)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------


def test_train_loop_checkpoint_restart(tmp_path):
    """Kill the training at a step, restart from the checkpoint, reach the
    end; the resumed run's losses equal the uninterrupted run's."""
    cfg = tconfigs.get_reduced("tinyllama-1.1b")
    kw = dict(steps=12, batch=4, seq=32, ckpt_every=5, log_every=100,
              device="cpu")
    _, _, straight = ttrain.train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    inj = FailureInjector(fail_at=(7,))
    with pytest.raises(RuntimeError):
        ttrain.train(cfg, ckpt_dir=str(tmp_path / "b"), injector=inj, **kw)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path / "b"))
    _, opt, losses = ttrain.train(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(losses) == 7            # steps 5..11
    assert all(np.isfinite(l) for l in losses)
    assert losses == straight[5:]
    assert int(opt.count) == 12


def test_train_loop_loss_decreases(tmp_path):
    cfg = tconfigs.get_reduced("xlstm-125m")
    _, _, losses = ttrain.train(cfg, steps=15, batch=8, seq=32,
                                ckpt_dir=str(tmp_path), ckpt_every=100,
                                log_every=100, resume=False, device="cpu")
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_matches_the_reference(tmp_path):
    """Port ``train()`` against reference ``train()`` on reduced tinyllama
    for 6 steps, both from the reference's key-0 parameters: the same
    batches, losses within 1e-4 relative, the same checkpointed steps."""
    jcfg = jconfigs.get_reduced("tinyllama-1.1b")
    tcfg = tconfigs.get_reduced("tinyllama-1.1b")
    kw = dict(steps=6, batch=4, seq=32, ckpt_every=3, log_every=100)
    for step in range(6):
        want = jtrain.make_batch_fn(jcfg, 4, 32)(step)
        got = ttrain.make_batch_fn(tcfg, 4, 32)(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    _, _, want = jtrain.train(jcfg, ckpt_dir=str(tmp_path / "ref"), **kw)
    init = jax.tree.map(np.asarray, JApi(jcfg).init(jax.random.key(0)))
    _, _, got = ttrain.train(tcfg, ckpt_dir=str(tmp_path / "port"),
                             device="cpu", params=init, **kw)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref")) == ["step_00000003",
                                                  "step_00000006"]
