"""Port parity for the MoE layer (``repro_torch/models/moe.py``) against
the reference's ``repro/models/moe.py`` on seeded numpy inputs, reduced
phi3.5-moe in float32 with the reference's parameters carried across.

The routing is integer and must be equal exactly, dtypes included: the
expert choice ``top_e`` (int32), ``keep`` (bool) and the dispatch row
``dest`` (int32), checked against the reference's routing lines run in
jnp. The output and the aux loss are float32 products summed in another
order: 2e-5 absolute (values of order 1). Cases: every token kept, tokens
dropped over capacity (capacity_factor 0.25), and a tie in the router's
probabilities (two equal router columns: the lower expert wins, as in
``lax.top_k``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 2e-5
ARCH = "phi3.5-moe-42b-a6.6b"


def _cfgs(**kw):
    return jconfigs.get_reduced(ARCH, **kw), tconfigs.get_reduced(ARCH, **kw)


def _params(jcfg, tie: bool):
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(3), jcfg))
    if tie:
        p["router"] = p["router"].copy()
        p["router"][:, 2] = p["router"][:, 1]
    return p, {k: torch.tensor(v) for k, v in p.items()}


def _reference_routing(p, xt, cfg, cap):
    """The reference's routing, its own lines (moe.py:52-68) in jnp."""
    e, k = cfg.n_experts, cfg.moe_top_k
    t = xt.shape[0]
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(t * k)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    keep = pos_in_e < cap
    dest = jnp.where(keep, flat_e * cap + pos_in_e, e * cap)
    return top_e, keep, dest


@pytest.mark.parametrize("capacity_factor,tie", [
    (1.25, False), (0.25, False), (1.25, True), (0.25, True)])
def test_moe_apply_matches_the_reference(rng, capacity_factor, tie):
    jcfg, tcfg = _cfgs(capacity_factor=capacity_factor)
    jp, tp = _params(jcfg, tie)
    x = rng.normal(size=(4, 16, jcfg.d_model)).astype(np.float32)
    t = 64
    cap = tmoe.capacity(t, tcfg)
    assert cap == jmoe.capacity(t, jcfg)
    xt = x.reshape(t, -1)
    want_e, want_keep, want_dest = (np.asarray(a) for a in
                                    _reference_routing(jp, xt, jcfg, cap))
    _, top_e, keep, dest, _ = tmoe.route(tp, torch.tensor(xt), tcfg, cap)
    assert top_e.dtype == torch.int32 and dest.dtype == torch.int32
    assert keep.dtype == torch.bool
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    if capacity_factor < 1:
        assert not want_keep.all()            # tokens were dropped
    elif not tie:                             # (a tie crowds two experts)
        assert want_keep.all()
    if tie:
        # expert 2 is taken only after expert 1, and where the tie falls on
        # the last slot expert 1 takes it
        has1, has2 = (want_e == 1).any(1), (want_e == 2).any(1)
        assert (has1[has2]).all() and (has1 & ~has2).any()
        both = has1 & has2
        assert (np.argmax(want_e[both] == 1, 1)
                < np.argmax(want_e[both] == 2, 1)).all()
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    tout, taux = tmoe.moe_apply(tp, torch.tensor(x), tcfg)
    assert tout.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=TOL, rtol=0)


def test_moe_capacity_and_one_token_decode(rng):
    """The capacity rule (rounded up to 8, at least 8) at the decode's one
    token a row and at a prefill's many; a decode-shaped call matches."""
    jcfg, tcfg = _cfgs()
    for tokens in (1, 8, 64, 4096, 4097):
        assert tmoe.capacity(tokens, tcfg) == jmoe.capacity(tokens, jcfg)
    big = tconfigs.get_config(ARCH)
    assert tmoe.capacity(4096, big) == 640
    jp, tp = _params(jcfg, False)
    x = rng.normal(size=(3, 1, jcfg.d_model)).astype(np.float32)
    jout, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    tout, _ = tmoe.moe_apply(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)


def test_moe_in_bfloat16_keeps_the_router_in_float32(rng):
    """With bf16 weights and compute the router stays float32 and the
    output is bf16; it agrees with the float32 layer within bf16 rounding
    (2e-2 on outputs of order 1) when no expert choice flips (the choices
    are computed from the same float32 logits of bf16 inputs)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, False)
    bcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    x = torch.tensor(rng.normal(size=(2, 8, tcfg.d_model)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    pb = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tp.items()}
    out, aux = tmoe.moe_apply(pb, xb, bcfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    ref, _ = tmoe.moe_apply({k: v.float() for k, v in pb.items()},
                            xb.float(), tcfg)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2,
                               rtol=0)
