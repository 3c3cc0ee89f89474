"""Port parity for the recurrent blocks (``repro_torch/models/ssm.py``)
against the reference's ``repro/models/ssm.py`` on seeded numpy inputs:
Mamba2, mLSTM and sLSTM apply (with and without an initial state), decode
and their states on reduced configs in float32 with the reference's
parameters; ``chunked_gla`` where the reference's chunked form is finite
(T <= 64, one chunk of T as the blocks take it, and the reduced chunk of
32), and against the reference's own one-token recurrence ``gla_step`` at
T = 256 with the published chunk of 256, where the reference's chunked form
overflows (the finding this file pins).

Tolerances, float32: 2e-5 absolute on block outputs (magnitude about 1),
and 2e-5 times max(1, the largest magnitude) on states and on
``chunked_gla``'s outputs, whose sums grow with T."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 2e-5
# (arch, ssm function prefix)
BLOCKS = [("zamba2-2.7b", "mamba2"), ("xlstm-125m", "mlstm"),
          ("xlstm-125m", "slstm")]


def _close(got, want, scaled=False):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    atol = TOL * (max(1.0, float(np.abs(want).max())) if scaled else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _states(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], scaled=True)


def _block(arch, prefix, seed=2, **kw):
    jcfg = jconfigs.get_reduced(arch, **kw)
    tcfg = tconfigs.get_reduced(arch, **kw)
    jp = jax.tree.map(np.asarray, getattr(jssm, f"{prefix}_init")(
        jax.random.key(seed), jcfg))
    tp = {k: torch.tensor(v) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _gla_inputs(rng, b, h, t, dk, dv, lo=0.5, hi=0.99):
    q, k = (rng.normal(size=(b, h, t, dk)).astype(np.float32) for _ in "qk")
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    log_a = np.log(rng.uniform(lo, hi, (b, h, t))).astype(np.float32)
    return q, k, v, log_a


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("arch,prefix", BLOCKS)
def test_block_apply_decode_and_state(rng, arch, prefix):
    """apply over 12 tokens (chunk 12) and over 64 (two chunks of 32, the
    state carried) from a carried-in state, then three decode steps:
    outputs and every state leaf, dtypes included."""
    jcfg, tcfg, jp, tp = _block(arch, prefix)
    japply, tapply = (getattr(m, f"{prefix}_apply") for m in (jssm, tssm))
    jdec, tdec = (getattr(m, f"{prefix}_decode") for m in (jssm, tssm))
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    jout, jst = japply(jp, jnp.asarray(x), jcfg)
    tout, tst = tapply(tp, torch.tensor(x), tcfg)
    _close(tout, jout)
    _states(tst, jst)
    shapes = getattr(tssm, f"{prefix}_state_shapes")(tcfg, 2)
    assert {k: (tuple(s.shape), s.dtype) for k, s in shapes.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tst.items()}
    if prefix != "slstm":            # the chunked blocks take a state in
        x2 = rng.normal(size=(2, 64, jcfg.d_model)).astype(np.float32)
        jo2, jst2 = japply(jp, jnp.asarray(x2), jcfg, jst)
        to2, tst2 = tapply(tp, torch.tensor(x2), tcfg, tst)
        _close(to2, jo2)
        _states(tst2, jst2)
    for _ in range(3):
        x1 = rng.normal(size=(2, jcfg.d_model)).astype(np.float32)
        jout, jst = jdec(jp, jnp.asarray(x1), jcfg, jst)
        tout, tst = tdec(tp, torch.tensor(x1), tcfg, tst)
        _close(tout, jout)
        _states(tst, jst)


@pytest.mark.parametrize("t,chunk", [(8, 8), (64, 64), (64, 32), (40, 8)])
def test_chunked_gla_matches_where_the_reference_is_finite(rng, t, chunk):
    """The reference's chunked form at T <= 64: one chunk of T (the
    published chunk of 256 cut to T, as the blocks call it) or several,
    with and without an initial state."""
    q, k, v, log_a = _gla_inputs(rng, 2, 3, t, 8, 5)
    s0 = rng.normal(size=(2, 3, 8, 5)).astype(np.float32)
    for init in (None, s0):
        jo, js = jssm.chunked_gla(q, k, v, log_a, chunk,
                                  None if init is None else jnp.asarray(init))
        to, ts = tssm.chunked_gla(*_t(q, k, v, log_a), chunk,
                                  None if init is None else torch.tensor(init))
        assert np.isfinite(np.asarray(jo)).all()
        _close(to, jo, scaled=True)
        _close(ts, js, scaled=True)


def _recurrence(q, k, v, log_a):
    """The reference's ``gla_step`` token by token: (o (B, H, T, Dv), S)."""
    b, h, t, dk = q.shape
    state = jnp.zeros((b, h, dk, v.shape[-1]), jnp.float32)
    outs = []
    for i in range(t):
        o, state = jssm.gla_step(q[:, :, i], k[:, :, i], v[:, :, i],
                                 log_a[:, :, i], state)
        outs.append(o)
    return jnp.stack(outs, axis=2), state


def test_chunked_gla_overflow_in_the_reference_is_finite_in_the_port(rng):
    """The finding: with decays of 0.5-0.7 a token the within-chunk log
    decay L passes -88 after about 128 tokens, so the reference's
    ``kc * exp(-L)`` overflows float32, ``exp(L)`` underflows to 0, and its
    chunked output at T = 256 with chunk 256 holds NaN. The port forms
    exp(L_i - L_j) <= 1 instead: finite, and equal to the reference's own
    recurrence ``gla_step`` run token by token (within 2e-5 of the largest
    magnitude)."""
    q, k, v, log_a = _gla_inputs(rng, 1, 2, 256, 8, 4, lo=0.5, hi=0.7)
    jo, _ = jssm.chunked_gla(q, k, v, log_a, 256)
    assert not np.isfinite(np.asarray(jo)).all()
    to, ts = tssm.chunked_gla(*_t(q, k, v, log_a), 256)
    assert torch.isfinite(to).all() and torch.isfinite(ts).all()
    ro, rs = _recurrence(q, k, v, log_a)
    _close(to, ro, scaled=True)
    _close(ts, rs, scaled=True)


@pytest.mark.parametrize("arch,prefix", BLOCKS[:2])
def test_published_chunk_at_256_tokens(rng, arch, prefix):
    """The finding's setting: the block at d_model 256 with the published
    chunk of 256 over 256 tokens. The reference's output is not finite;
    the port's is, and its last token equals the port's own one-token
    decode after a 255-token prefill (the ``gla_step`` recurrence), within
    1e-4 (outputs of order 1 after float32 sums over 255 tokens summed in
    two orders)."""
    jcfg, tcfg, jp, tp = _block(arch, prefix, d_model=256, ssm_chunk=256)
    japply, tapply = (getattr(m, f"{prefix}_apply") for m in (jssm, tssm))
    tdec = getattr(tssm, f"{prefix}_decode")
    x = rng.normal(size=(1, 256, 256)).astype(np.float32)
    jout, _ = japply(jp, jnp.asarray(x), jcfg)
    assert not np.isfinite(np.asarray(jout)).all()
    tout, _ = tapply(tp, torch.tensor(x), tcfg)
    assert torch.isfinite(tout).all()
    _, st = tapply(tp, torch.tensor(x[:, :255]), tcfg)
    last, _ = tdec(tp, torch.tensor(x[:, 255]), tcfg, st)
    np.testing.assert_allclose(last.numpy(), tout[:, 255].numpy(), atol=1e-4,
                               rtol=0)


def test_mamba2_conv_state_below_the_conv_width(rng):
    """A prompt shorter than W - 1 tokens: the port pads the conv state
    with the zeros the causal conv pads with, so decoding after a 1- or
    2-token prompt equals the forward over the whole sequence (the
    reference's slice is short there and its decode fails on the shape)."""
    _, tcfg, _, tp = _block("zamba2-2.7b", "mamba2")
    x = torch.tensor(rng.normal(size=(2, 6, tcfg.d_model)).astype(np.float32))
    full, _ = tssm.mamba2_apply(tp, x, tcfg)
    for prompt in (1, 2, 3):
        out, st = tssm.mamba2_apply(tp, x[:, :prompt], tcfg)
        assert st["conv"].shape == (2, tcfg.ssm_conv - 1, st["conv"].shape[2])
        for i in range(prompt, 6):
            out, st = tssm.mamba2_decode(tp, x[:, i], tcfg, st)
            np.testing.assert_allclose(out.numpy(), full[:, i].numpy(),
                                       atol=TOL, rtol=0)
