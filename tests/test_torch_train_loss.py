"""Port parity for the training objective, ``ModelApi.loss``, and its
gradient, for all ten arch ids at ``get_reduced`` (float32), with the
reference's initialised parameters carried across by
``interop.params_from_numpy``.

Tolerances: the loss and the aux term within 1e-5 relative (float32 sums in
another order); each parameter leaf's gradient (the port's autograd against
``jax.grad``, the reference's stacked layers carried to the port's lists by
``params_from_numpy`` too) within 1e-4 relative L2. The SSM families run
16 tokens, under the 128 tokens a chunk at which the reference's
``chunked_gla`` overflows (ROADMAP Queue 3). ``remat`` on and off give
bit-equal gradients in the port (the recompute runs the same CPU ops)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

from torch_parity import one_thread  # noqa: E402,F401

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
B, S, FRAMES, S_DEC = 2, 16, 24, 8


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here on one intra-op thread (``torch_parity.one_thread``)."""


def inputs(cfg, seed: int = 0, mask: bool = False) -> dict:
    """Seeded numpy training inputs for ``cfg``'s frontend."""
    rng = np.random.default_rng(seed)

    def toks(n):
        return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)

    if cfg.is_encdec:
        return {"embeds": rng.normal(size=(B, FRAMES, cfg.d_model))
                .astype(np.float32), "tokens": toks(S_DEC),
                "labels": toks(S_DEC)}
    out = ({"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)}
           if cfg.frontend == "embed" else {"tokens": toks(S)})
    out["labels"] = toks(S)
    if mask:
        out["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return out


def pair(arch: str, seed: int = 1, **kw):
    """(reference api, port api, reference params, port params)."""
    jcfg = jconfigs.get_reduced(arch, **kw)
    tcfg = tconfigs.get_reduced(arch, **kw)
    jp = JApi(jcfg).init(jax.random.key(seed))
    return JApi(jcfg), TApi(tcfg), jp, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def by_path(params) -> dict:
    return {path: t for path, t in tree.leaves_with_path(params)}


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    diff = np.linalg.norm((got - want).ravel())
    norm = np.linalg.norm(np.asarray(want, np.float64).ravel())
    return diff / norm if norm else diff


def check_grads(tcfg, port_grads: list, tparams, ref_grads) -> int:
    """Every leaf of the port's gradient against the reference's, by path;
    returns the number of leaves."""
    ref = by_path(params_from_numpy(tcfg, jax.tree.map(np.asarray, ref_grads),
                                    device="cpu"))
    paths = [p for p, _ in tree.leaves_with_path(tparams)]
    assert set(paths) == set(ref)
    for path, g in zip(paths, port_grads):
        err = rel_l2(g.numpy(), ref[path].numpy())
        assert err <= GRAD_REL_L2, (path, err)
    return len(paths)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_loss_and_grads_match_the_reference(arch):
    japi, tapi, jp, tp = pair(arch)
    batch = inputs(tapi.cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tl, tm = tapi.loss(tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    for got, want in ((tl, jl), (tm["loss"], jm["loss"]),
                      (tm["aux"], jm["aux"]),
                      (tm["ntokens"], jm["ntokens"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                                   atol=0)
    if tapi.cfg.n_experts:
        assert float(tm["aux"]) > 0
    loss, grads = value_and_grad(tapi, tp, tb)
    assert float(loss) == float(tl)
    assert check_grads(tapi.cfg, grads, tp, jg) == len(tree.leaves(tp))


def test_loss_mask_matches_the_reference():
    """An optional ``loss_mask`` weights the positions (and sets
    ``ntokens``), as in the reference."""
    japi, tapi, jp, tp = pair("tinyllama-1.1b")
    batch = inputs(tapi.cfg, seed=3, mask=True)
    (jl, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    loss, grads = value_and_grad(tapi, tp, tb)
    _, tm = tapi.loss(tp, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert float(tm["ntokens"]) == float(jm["ntokens"]) \
        == batch["loss_mask"].sum()
    check_grads(tapi.cfg, grads, tp, jg)


def test_padded_vocab_is_masked():
    """A vocab off the 128 multiple: the padding columns take no
    probability (the loss equals a logsumexp over the live columns)."""
    japi, tapi, jp, tp = pair("qwen2-1.5b", vocab_size=250)
    assert tapi.cfg.padded_vocab == 256
    batch = inputs(tapi.cfg, seed=4)
    jl, _ = japi.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tl, _ = tapi.loss(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    logits, _ = tlm.forward(tp, tapi.cfg, tokens=tb["tokens"])
    live = logits[..., :250].float()
    want = torch.mean(torch.logsumexp(live, -1) - torch.gather(
        live, -1, tb["labels"].long()[..., None])[..., 0])
    np.testing.assert_allclose(float(tl), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_remat_gives_equal_gradients(arch):
    """``remat`` on (each superlayer, or each enc-dec layer, under
    ``torch.utils.checkpoint``) and off: the same loss and bit-equal
    gradients."""
    cfg = tconfigs.get_reduced(arch)
    params = TApi(cfg).init(torch.Generator().manual_seed(2))
    tb = {k: torch.tensor(v) for k, v in inputs(cfg, seed=5).items()}
    out = [value_and_grad(TApi(dataclasses.replace(cfg, remat=r)), params, tb)
           for r in (False, True)]
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
