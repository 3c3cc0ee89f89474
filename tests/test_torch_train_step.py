"""Port parity for the train step (``repro_torch/launch/steps.py
build_train_step``) against the reference's jitted step, with accum 1 and
2, on reduced tinyllama-1.1b (AdamW), qwen2-1.5b (qkv bias), phi3.5-moe
(Adafactor and the MoE aux loss) and seamless-m4t-medium (the
encoder-decoder loss), and tinyllama with bf16 parameters (bf16 gradient
accumulation). The reference's initialised parameters are carried across
by ``interop.params_from_numpy``; the batches are ``make_batch_fn``'s, the
same numpy arrays in both packages.

Tolerances: the loss and grad_norm within 1e-5 relative; the optimizer's
float32 moments within 1e-4 relative L2 a leaf (the gradients' tolerance
in test_torch_train_loss.py), a bf16 moment, or any moment from bf16
gradients, within 1e-3 (a bf16 rounding step apart here and there); each float32 parameter within lr / 10 of the reference's after the
step (an AdamW step is about lr times the gradient's sign where the
gradient is far above eps: an element whose gradient is rounding noise,
such as qwen2's k bias, which the softmax ignores, may take another
fraction of lr), each bf16 parameter within one bf16 step; and the loss at
the updated parameters, each package's own, within 1e-5 relative."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

from torch_parity import one_thread  # noqa: E402,F401

LOSS_RTOL = 1e-5
MOMENT_REL_L2 = 1e-4        # float32 moments from float32 gradients
BF16_REL_L2 = 1e-3          # a bf16 moment, or bf16 gradients
LR = 3e-4                   # make_optimizer's default constant rate
B, S = 4, 16


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here on one intra-op thread (``torch_parity.one_thread``)."""

CASES = [("tinyllama-1.1b", False), ("qwen2-1.5b", False),
         ("phi3.5-moe-42b-a6.6b", False), ("seamless-m4t-medium", False),
         ("tinyllama-1.1b", True)]


def _cfgs(arch: str, bf16: bool):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    return jcfg, tcfg


def _stacked(tcfg, ref_tree) -> dict:
    """path -> tensor of a reference tree in the port's layout."""
    return dict(tree.leaves_with_path(params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a), ref_tree), device="cpu")))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.double(), want.double()
    norm = float(torch.linalg.vector_norm(w))
    diff = float(torch.linalg.vector_norm(g - w))
    return diff / norm if norm else diff


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, 2.0 ** -133,
                       2.0 ** (torch.floor(torch.log2(x.abs() + 1e-45)) - 7))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch,bf16", CASES,
                         ids=[a + ("-bf16" if b else "") for a, b in CASES])
def test_train_step_matches_the_reference(arch, bf16, accum):
    jcfg, tcfg = _cfgs(arch, bf16)
    japi, tapi = JApi(jcfg), TApi(tcfg)
    jp = japi.init(jax.random.key(1))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = ttrain.make_batch_fn(tcfg, B, S)(0)
    ref_batch = jtrain.make_batch_fn(jcfg, B, S)(0)
    assert batch.keys() == ref_batch.keys()
    for k in batch:
        np.testing.assert_array_equal(batch[k], ref_batch[k])

    jopt = jsteps.default_optimizer(jcfg)
    jp1, js1, jm = jax.jit(jsteps.build_train_step(japi, jopt, accum=accum))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    topt = tsteps.default_optimizer(tcfg)
    assert type(topt).__name__ == type(jopt).__name__
    ts = topt.init(tp)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tp1, ts1, tm = tsteps.build_train_step(tapi, topt, accum=accum)(
        tp, ts, tb)
    assert tp1 is tp and ts1 is ts
    for key in ("loss", "grad_norm"):
        assert tm[key].dtype == torch.float32
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert int(ts1.count) == int(js1.count) == 1
    # moments: the reference's stacked state cut along the depth (a shared
    # column factor of a 1-d parameter stays whole)
    for field in ts1._fields[1:]:
        ref = getattr(js1, field)
        for (path, got), want in zip(
                tree.leaves_with_path(getattr(ts1, field)),
                _moment_leaves(tcfg, getattr(ts1, field), ref)):
            assert tuple(got.shape) == tuple(want.shape), (field, path)
            err = _rel_l2(got.float(), want.float())
            limit = (BF16_REL_L2 if bf16 or got.dtype == torch.bfloat16
                     else MOMENT_REL_L2)
            assert err <= limit, (field, path, err)
    ref_params = _stacked(tcfg, jp1)
    for path, got in tree.leaves_with_path(tp1):
        want = ref_params[path]
        assert got.dtype == want.dtype
        if got.dtype == torch.bfloat16:
            ok = (got.float() - want.float()).abs() <= _bf16_step(
                want.float())
        else:
            ok = (got - want).abs() <= 1e-6 * want.abs().max() + LR / 10
        assert bool(ok.all()), path
    # the loss at the updated parameters, each package's own
    jl, _ = japi.loss(jp1, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, _ = tapi.loss(tp1, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)


def _moment_leaves(tcfg, tparams, ref_tree):
    """The reference's moment tree in the port's per-layer order: a stacked
    leaf is cut along the depth unless the port keeps its shape (the (1,)
    placeholders, Adafactor's shared column factor of a 1-d parameter)."""
    host = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), ref_tree)
    for path, leaf in tree.leaves_with_path(tparams):
        stacked = path[0] in ("layers", "enc_layers", "dec_layers")
        node = host[path[0]]
        for k in path[2 if stacked else 1:]:
            node = node[k]
        if stacked and node.shape != tuple(leaf.shape):
            node = node[path[1]]
        yield torch.tensor(node)


@pytest.mark.parametrize("rows,accum", [(6, 4), (2, 4)],
                         ids=["not-a-multiple", "fewer-rows"])
def test_a_batch_that_accum_does_not_divide_is_refused(rows, accum):
    """Rows that do not fold into ``accum`` microbatches raise before any
    gradient is taken, as the reference's reshape to (A, B/A, ...) does,
    and leave the parameters and the optimizer state as they were."""
    _, tcfg = _cfgs("tinyllama-1.1b", False)
    tapi = TApi(tcfg)
    tp = tapi.init(torch.Generator().manual_seed(0))
    before = [p.clone() for p in tree.leaves(tp)]
    topt = tsteps.default_optimizer(tcfg)
    ts = topt.init(tp)
    tb = {k: torch.tensor(v) for k, v in
          ttrain.make_batch_fn(tcfg, rows, S)(0).items()}
    step = tsteps.build_train_step(tapi, topt, accum=accum)
    with pytest.raises(ValueError, match="does not divide"):
        step(tp, ts, tb)
    assert int(ts.count) == 0
    assert all(torch.equal(a, b) for a, b in zip(before, tree.leaves(tp)))
