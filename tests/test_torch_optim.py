"""Port parity for the optimizers (``repro_torch/optim``): AdamW and
Adafactor (b1 0.9 and 0) for one and several updates against the
reference's, on the same seeded parameters and gradients; the LR
schedules; and mirrors of ``test_substrate.py``'s optimizer tests.

Tolerances: float32 parameters and moments within 1e-6 of the value or of
the leaf's largest magnitude, whichever is larger (the same float32
arithmetic in the same order; mean reductions and ``rsqrt`` may differ in
the last bit, and a parameter that an update brings near 0 keeps the
absolute error of its operands); bf16 parameters and moments within one bf16 step
of the reference's value (a float32 value a last bit apart can round to
the neighbouring bf16). Step counts are equal int32, state shapes equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch import tree  # noqa: E402

F32_RTOL = 1e-6
# a parameter tree as the models have it: unstacked leaves and ``layers``,
# a list with one tree a depth (the reference stacks it on axis 0)
TOP = {"embed": (16, 24), "bias": (24,)}
LAYER = {"w": (8, 12), "norm": (12,), "experts": (3, 8, 12)}
DEPTH = 3


def _np_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (round to nearest even) -> float32, in numpy."""
    bits = x.astype(np.float32).view(np.uint32)
    bits = bits + 0x7FFF + ((bits >> 16) & 1)
    return (bits & 0xFFFF0000).view(np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _host_tree(rng, scale: float, bf16: bool) -> dict:
    """Numpy leaves in the reference's layout (``layers`` stacked)."""
    def draw(shape):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return _np_bf16(a) if bf16 else a

    out = {k: draw(s) for k, s in TOP.items()}
    out["layers"] = {k: draw((DEPTH,) + s) for k, s in LAYER.items()}
    return out


def _port(host: dict, dtype) -> dict:
    """The port's layout of a reference-layout numpy tree."""
    out = {k: torch.tensor(host[k]).to(dtype) for k in TOP}
    out["layers"] = [{k: torch.tensor(host["layers"][k][i]).to(dtype)
                      for k in LAYER} for i in range(DEPTH)]
    return out


def _ref(host: dict, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), host)


def _pairs_of_leaves(port, ref):
    """(name, port leaf, reference leaf or slice) for every port leaf; a
    stacked reference leaf is cut along its depth axis unless the port's
    leaf has the stacked leaf's own shape (a shared column factor)."""
    for k in TOP:
        yield k, port[k], ref[k]
    for i in range(DEPTH):
        for k in LAYER:
            r = ref["layers"][k]
            t = port["layers"][i][k]
            same = tuple(t.shape) == tuple(r.shape)
            yield f"layers.{i}.{k}", t, (r if same else r[i])


def _trees(rng, bf16: bool):
    """(port params, reference params, list of (port, reference) grad
    trees), the same numbers in both."""
    td, jd = ((torch.bfloat16, jnp.bfloat16) if bf16
              else (torch.float32, jnp.float32))
    host = _host_tree(rng, 1.0, bf16)
    grads = []
    for _ in range(4):
        g = _host_tree(rng, 0.1, False)
        grads.append((_port(g, td), _ref(g, jd)))
    return _port(host, td), _ref(host, jd), grads


def _close(got, want, what):
    """float32 within F32_RTOL; bf16 within one bf16 step of ``want``."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    if (isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16):
        step = np.where(w == 0, 2.0 ** -133,
                        2.0 ** (np.floor(np.log2(np.abs(w) + 1e-45)) - 7))
        assert (np.abs(g - w) <= step).all(), (what, np.abs(g - w).max())
    else:
        np.testing.assert_allclose(g, w, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(w).max(),
                                   err_msg=what)


def _pairs(opt_name: str, **kw):
    lr_t, lr_j = topt.constant(1e-2), jopt.constant(1e-2)
    if opt_name == "adamw":
        return topt.AdamW(lr=lr_t, **kw), jopt.AdamW(lr=lr_j, **kw)
    return topt.Adafactor(lr=lr_t, **kw), jopt.Adafactor(lr=lr_j, **kw)


CASES = [("adamw", {}), ("adamw", {"weight_decay": 0.0}),
         ("adafactor", {"b1": 0.9}), ("adafactor", {"b1": 0.0}),
         ("adafactor", {"b1": 0.9, "weight_decay": 0.01})]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("updates", [1, 4])
@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_update_matches_the_reference(name, kw, updates, bf16):
    rng = np.random.default_rng(updates + 10 * bf16)
    tp, jp, grads = _trees(rng, bf16)
    topt_, jopt_ = _pairs(name, **kw)
    ts, js = topt_.init(tp), jopt_.init(jp)
    # the same state: the reference's stacked leaves cut along the depth
    assert type(ts).__name__ == type(js).__name__
    assert ts.count.shape == js.count.shape == ()
    for field in ts._fields[1:]:
        for what, t, j in _pairs_of_leaves(getattr(ts, field),
                                           getattr(js, field)):
            assert tuple(t.shape) == tuple(j.shape), (field, what)
            assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name
    for tg, jg in grads[:updates]:
        out_p, out_s = topt_.update(tg, ts, tp)
        assert out_p is tp and out_s is ts          # updated in place
        jp, js = jopt_.update(jg, js, jp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == int(js.count) \
        == updates
    for what, t, j in _pairs_of_leaves(tp, jp):
        _close(t, j, f"param {what}")
    for field in ts._fields[1:]:
        for what, t, j in _pairs_of_leaves(getattr(ts, field),
                                           getattr(js, field)):
            _close(t, j, f"{field} {what}")


def test_warmup_cosine_matches_the_reference():
    tl = topt.warmup_cosine(3e-4, warmup=4, total=20)
    jl = jopt.warmup_cosine(3e-4, warmup=4, total=20)
    for c in range(0, 25):
        got = tl(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(jl(jnp.asarray(c, jnp.int32))),
                                   rtol=F32_RTOL)
    assert float(topt.constant(0.5)(torch.tensor(3))) == 0.5


def test_make_optimizer():
    assert isinstance(topt.make_optimizer("adamw"), topt.AdamW)
    ada = topt.make_optimizer("adafactor", b1=0.0)
    assert isinstance(ada, topt.Adafactor) and ada.b1 == 0.0
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")


# mirrors of tests/test_substrate.py's optimizer tests


def _quadratic_params():
    return {"w": torch.tensor([1.5, -2.0, 3.0]),
            "b": torch.tensor([[0.5, -0.5], [1.0, 2.0]])}


@pytest.mark.parametrize("opt", [
    topt.AdamW(lr=topt.constant(0.05), weight_decay=0.0),
    topt.Adafactor(lr=topt.constant(0.5)),
    topt.Adafactor(lr=topt.constant(0.5), b1=0.0)],
    ids=["adamw", "adafactor", "adafactor-b1-0"])
def test_optimizers_descend_quadratic(opt):
    params = _quadratic_params()
    state = opt.init(params)

    def loss(p):
        return sum(torch.sum(x ** 2) for x in tree.leaves(p))

    l0 = float(loss(params))
    for _ in range(60):
        flat = [p.detach().requires_grad_() for p in tree.leaves(params)]
        g = torch.autograd.grad(loss(tree.unflatten(params, flat)), flat)
        params, state = opt.update(tree.unflatten(params, list(g)), state,
                                   params)
    assert float(loss(params)) < 0.05 * l0


def test_adafactor_factored_state_is_small():
    p = {"w": torch.zeros((64, 128))}
    st = topt.Adafactor(lr=topt.constant(1e-3)).init(p)
    assert st.v_row["w"].shape == (64,)
    assert st.v_col["w"].shape == (128,)
    assert st.m["w"].dtype == torch.bfloat16


def test_adafactor_b1_zero_has_no_moment():
    p = {"w": torch.zeros((64, 128))}
    st = topt.Adafactor(lr=topt.constant(1e-3), b1=0.0).init(p)
    assert st.m["w"].shape == (1,)
