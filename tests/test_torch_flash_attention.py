"""Port parity for flash_attention: the port's plain version
(``repro_torch/kernels/flash_attention/ref.py``) and its wrapper on CPU
tensors against the reference's oracle and its TPU kernel run in interpret
mode, on the sweep shapes of ``tests/test_kernels.py`` and more. Tolerances
are the reference kernel test's: 3e-5 in float32, 2e-2 in bfloat16 (the
plain versions round the softmax weights to bf16 before the PV product, the
kernels do not). The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_ref  # noqa: E402

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SWEEP = [(1, 2, 1, 128, 32), (2, 4, 2, 256, 64), (1, 8, 8, 128, 128),
         (1, 6, 2, 384, 64)]


def _inputs(rng, b, h, kh, s, d, dtype):
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(x):
    if hasattr(x, "detach"):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s,d", SWEEP)
def test_sweep_plain_and_wrapper(rng, b, h, kh, s, d, dtype):
    """Causal sweep: the port's plain version against the reference's
    oracle (same arithmetic: bf16 weights in the PV product), and the
    port's wrapper on the CPU against the reference's TPU kernel in
    interpret mode (tiles of 128, as the reference's test)."""
    jx, tx = _inputs(rng, b, h, kh, s, d, dtype)
    got = t_ref.flash_attention(*tx, causal=True)
    assert got.dtype == tx[0].dtype and got.shape == (b, h, s, d)
    np.testing.assert_allclose(_f32(got), _f32(j_ref.flash_attention(
        *jx, causal=True)), atol=TOL[dtype])
    np.testing.assert_allclose(
        _f32(t_ops.flash_attention(*tx, causal=True, tq=128, tk=128)),
        _f32(j_ops.flash_attention(*jx, causal=True, tq=128, tk=128)),
        atol=TOL[dtype])


@pytest.mark.parametrize("s", [256, 10, 1])
def test_noncausal(rng, s):
    """Full attention on tile-aligned S (S <= 256 is one tile)."""
    jx, tx = _inputs(rng, 1, 2, 2, s, 64, "float32")
    want = j_ops.flash_attention(*jx, causal=False)
    np.testing.assert_allclose(
        _f32(t_ops.flash_attention(*tx, causal=False)), _f32(want),
        atol=3e-5)
    np.testing.assert_allclose(
        _f32(t_ref.flash_attention(*tx, causal=False)),
        _f32(j_ref.flash_attention(*jx, causal=False)), atol=3e-5)


@pytest.mark.parametrize("s", [200, 300, 10])
def test_ragged_s_padding(rng, s):
    """Causal S off the tile: the reference pads to the tile and slices;
    the port's wrapper pads nothing (its kernel masks the ragged end). The
    scorer's S = 10 record fields is one of the cases."""
    jx, tx = _inputs(rng, 2, 6, 2, s, 16, "float32")
    got = t_ops.flash_attention(*tx, causal=True, tq=128, tk=128)
    want = j_ops.flash_attention(*jx, causal=True, tq=128, tk=128)
    assert got.shape == (2, 6, s, 16)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-5)
    assert np.isfinite(_f32(got)).all()


def test_noncausal_off_tile_refused_like_the_reference(rng):
    """A non-causal S off the tile: the reference's Pallas wrapper refuses
    it; its default path (the einsum plain version) takes it, and so does
    the port's wrapper, whose kernel masks the ragged end itself (the
    refusal was lifted when the encoder-decoder came to launch the kernel at
    any frame count and at Sk != Sq). The port equals the reference's
    oracle."""
    jx, tx = _inputs(rng, 1, 2, 1, 300, 32, "float32")
    with pytest.raises(ValueError, match="tile-aligned"):
        j_ops.flash_attention(*jx, causal=False)
    np.testing.assert_allclose(
        _f32(t_ops.flash_attention(*tx, causal=False)),
        _f32(j_ref.flash_attention(*jx, causal=False)), atol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,sq,sk,d", [
    (2, 4, 4, 4, 96, 64), (1, 6, 2, 7, 300, 32), (2, 4, 2, 40, 3, 16),
    (1, 2, 2, 16, 16, 80)])
def test_cross_attention_key_length(rng, b, h, kh, sq, sk, d, dtype):
    """Non-causal attention with k/v of their own length Sk (the
    encoder-decoder's cross-attention: a few decoder positions over many
    frames, and the reverse): the port's plain version and wrapper against
    the reference's oracle, which takes Sk from k."""
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    want = _f32(j_ref.flash_attention(*jx, causal=False))
    for fn in (t_ref.flash_attention, t_ops.flash_attention):
        got = fn(*tx, causal=False)
        assert got.shape == (b, h, sq, d) and got.dtype == tx[0].dtype
        np.testing.assert_allclose(_f32(got), want, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_80(rng, causal, dtype):
    """zamba2's head dim 80: the port's wrapper on the CPU against the
    reference's TPU kernel in interpret mode (which takes any D), and the
    plain version against the reference's oracle."""
    jx, tx = _inputs(rng, 1, 4, 2, 128, 80, dtype)
    np.testing.assert_allclose(
        _f32(t_ops.flash_attention(*tx, causal=causal)),
        _f32(j_ops.flash_attention(*jx, causal=causal, tq=128, tk=128)),
        atol=TOL[dtype])
    np.testing.assert_allclose(
        _f32(t_ref.flash_attention(*tx, causal=causal)),
        _f32(j_ref.flash_attention(*jx, causal=causal)), atol=TOL[dtype])


def test_first_row_sees_one_key_and_no_row_is_nan(rng):
    """Row 0 of a causal attention has exactly one live key, so its output
    is v[0] of its KV head; with keys of very large norm every other row is
    a near one-hot softmax. No row is NaN in either package. (A row with no
    live key at all cannot be built through either package's entry points:
    causal row i always sees key 0, a full row sees all S keys; the CUDA
    kernel's l == 0 -> 0 rule is the TPU kernel's, and flash_decode's
    kv_len = 0 case in tests/test_torch_flash_decode.py is the reachable
    fully masked row.)"""
    jx, tx = _inputs(rng, 1, 4, 2, 64, 32, "float32")
    big = [t * 30.0 for t in tx]
    got = t_ops.flash_attention(*big, causal=True)
    want = j_ops.flash_attention(*(jnp.asarray(t.numpy()) for t in big),
                                 causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=3e-5 * 30)
    np.testing.assert_allclose(_f32(got[:, :, 0]),
                               _f32(torch.repeat_interleave(big[2], 2, 1)
                                    [:, :, 0]), atol=3e-5 * 30)
    assert np.isfinite(_f32(got)).all()


def test_wrapper_counts_no_launch_on_the_cpu(rng):
    before = t_ops.LAUNCHES
    _, tx = _inputs(rng, 1, 2, 1, 16, 16, "float32")
    t_ops.flash_attention(*tx)
    assert t_ops.LAUNCHES == before and t_ops.SHAPE is None


def _refused(case):
    """(q, k, v) that the kernel does not take, and the message's key."""
    f32, bf16 = torch.float32, torch.bfloat16
    good = lambda *s, dt=bf16: torch.zeros(s, dtype=dt)  # noqa: E731
    if case == "head_dim":
        return good(1, 2, 8, 48), good(1, 1, 8, 48), good(1, 1, 8, 48), "D in"
    if case == "float16":
        x = good(1, 2, 8, 32, dt=torch.float16)
        return x, x[:, :1], x[:, :1], "bfloat16"
    if case == "heads":
        return good(1, 3, 8, 32), good(1, 2, 8, 32), good(1, 2, 8, 32), \
            "multiple of KH"
    if case == "strided":
        k = good(1, 1, 32, 8).transpose(2, 3)
        return good(1, 2, 8, 32), k, good(1, 1, 8, 32), "contiguous"
    if case == "dtypes":
        return good(1, 2, 8, 32), good(1, 1, 8, 32, dt=f32), \
            good(1, 1, 8, 32), "contiguous"
    flat = torch.zeros(1 + 2 * 8 * 32, dtype=bf16)
    q = flat[1:].view(1, 2, 8, 32)              # 2 bytes past an aligned start
    return q, good(1, 1, 8, 32), good(1, 1, 8, 32), "16-byte"


@pytest.mark.parametrize("case", ["head_dim", "float16", "heads", "strided",
                                  "dtypes", "misaligned"])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(case):
    """``check_inputs`` is what the wrapper runs before a launch on the card;
    it runs on any device, so its refusals are held here."""
    q, k, v, match = _refused(case)
    if case == "misaligned":
        assert q.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match=match):
        t_ops.check_inputs(q, k, v)


def test_kernel_checks_key_length():
    """Sk != Sq passes the checks when not causal, and is refused when
    causal (the causal kernel takes Sk = Sq, as the reference's)."""
    q = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 16, 1024, 64), dtype=torch.bfloat16)
    assert t_ops.check_inputs(q, k, k.clone(), causal=False) == \
        (2, 16, 16, 4, 64)
    with pytest.raises(ValueError, match="causal attention needs k"):
        t_ops.check_inputs(q, k, k.clone(), causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_checks_take_the_served_shapes(dtype):
    """The scorer's and the serve prefill's shapes (cut in batch) pass."""
    for b, h, kh, s, d in ((4, 12, 2, 10, 128), (1, 12, 2, 512, 128),
                           (2, 8, 8, 40, 64), (3, 12, 2, 10, 16)):
        q = torch.zeros((b, h, s, d), dtype=dtype)
        k = torch.zeros((b, kh, s, d), dtype=dtype)
        assert t_ops.check_inputs(q, k, k.clone()) == (b, h, kh, s, d)
