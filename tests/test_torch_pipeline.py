"""Port parity for the GPipe pipeline (``repro_torch/distributed/
pipeline.py``) against the reference's ``distributed/pipeline.py``:
``pipeline_forward`` at 1, 2 and 4 stages against the reference (conftest's
4 host devices) and against the sequential application of the stages, at
the reference test's atol 1e-5; the schedule (each stage runs once a
microbatch, microbatch ``t`` enters on tick ``t``); and
``bubble_fraction``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import pipeline as J  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro_torch.distributed import pipeline as T  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

ATOL = 1e-5     # tests/test_distributed.py's


def j_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def t_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


@pytest.mark.multidevice
@pytest.mark.parametrize("stages", (1, 2, 4))
@pytest.mark.parametrize("micro", (1, 3, 8))
def test_pipeline_forward_matches_reference_and_sequential(
        multidevice, stages, micro):
    rng = np.random.default_rng(10 * stages + micro)
    w = (rng.normal(size=(stages, 8, 8)) / np.sqrt(8)).astype(np.float32)
    b = rng.normal(size=(stages, 8)).astype(np.float32)
    xs = rng.normal(size=(micro, 2, 8)).astype(np.float32)
    jrun = J.pipeline_forward(jmake_mesh((stages,), ("pod",)), "pod",
                              j_stage, micro)
    want = np.asarray(jrun({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(xs)))
    trun = T.pipeline_forward(make_mesh((stages,), ("pod",), "cpu"), "pod",
                              t_stage, micro)
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = trun(params, torch.from_numpy(xs))
    assert got.shape == xs.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    seq = []
    for i in range(micro):
        x = torch.from_numpy(xs[i])
        for s in range(stages):
            x = t_stage({"w": params["w"][s], "b": params["b"][s]}, x)
        seq.append(x)
    np.testing.assert_allclose(got.numpy(), torch.stack(seq).numpy(),
                               atol=ATOL)
    # the same ops in the same order: equal bits, not only within atol
    assert torch.equal(got, torch.stack(seq))


def test_schedule_fill_and_drain():
    """Each stage applies ``stage_fn`` once a microbatch, microbatch t
    entering stage 0 on tick t, in M + S - 1 ticks; bubble slots skipped."""
    calls = []

    def stage_fn(p, x):
        calls.append((int(p["id"]), int(x[0])))
        return x + 1

    stages, micro = 3, 4
    run = T.pipeline_forward(make_mesh((stages,), ("pod",), "cpu"), "pod",
                             stage_fn, micro)
    xs = torch.arange(micro, dtype=torch.float32)[:, None] * 100
    out = run({"id": torch.arange(stages)}, xs)
    assert torch.equal(out, xs + stages)
    assert len(calls) == stages * micro
    # tick t runs stage s on microbatch t - s (stages in order in a tick)
    ticks = [[(s, 100 * (t - s) + s) for s in range(stages)
              if 0 <= t - s < micro] for t in range(micro + stages - 1)]
    assert calls == [c for tick in ticks for c in tick]
    with pytest.raises(ValueError, match="microbatches"):
        run({"id": torch.arange(stages)}, xs[:2])


def test_stages_on_the_axis_of_a_2d_mesh():
    """Stage s on the device at position s of the axis (position 0 of the
    other axes)."""
    mesh = make_mesh((2, 2), ("pod", "model"), "cpu")
    run = T.pipeline_forward(mesh, "pod", lambda p, x: x * p["k"], 2)
    out = run({"k": torch.tensor([2.0, 3.0])}, torch.ones((2, 4)))
    assert torch.equal(out, torch.full((2, 4), 6.0))


@pytest.mark.parametrize("stages,micro", [(1, 8), (2, 2), (2, 8), (4, 8),
                                          (4, 1), (16, 64)])
def test_bubble_fraction_matches_reference(stages, micro):
    assert T.bubble_fraction(stages, micro) == \
        J.bubble_fraction(stages, micro)
    assert T.bubble_fraction(1, 8) == 0.0
    assert abs(T.bubble_fraction(2, 2) - 1 / 3) < 1e-9
