"""Port parity for flash_decode: the port's plain partials, merge and
normalisation (``repro_torch/kernels/flash_decode/ref.py``) and its wrapper
on CPU tensors against the reference's oracle and TPU kernel in interpret
mode: the sweep of ``tests/test_kernels.py``, ``merge_partials`` against the
monolithic result, the empty shard and ``kv_len`` = 0. Float32 tolerance
3e-5 on normalised outputs (the reference's), partials at 2e-5 + 1e-5
relative (sums of up to hundreds of terms in another order). The CUDA kernel is held against the plain version on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import ops as j_ops  # noqa: E402
from repro.kernels.flash_decode import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as t_ref  # noqa: E402


def _inputs(rng, b, h, kh, s, d, kv_len=None):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, kh, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kh, s, d)).astype(np.float32)
    if kv_len is None:
        kv_len = rng.integers(1, s + 1, (b,))
    kv_len = np.asarray(kv_len, np.int32)
    return ([jnp.asarray(a) for a in (q, k, v, kv_len)],
            [torch.tensor(a) for a in (q, k, v, kv_len)])


def _close(port, ref, atol=3e-5, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("b,h,kh,s,d", [
    (1, 2, 1, 128, 32), (2, 4, 2, 384, 64), (3, 8, 8, 256, 128),
    (2, 12, 2, 544, 128)])
def test_sweep(rng, b, h, kh, s, d):
    """Normalised output of the plain version and of the wrapper against
    the reference's oracle and its interpret-mode kernel; the partials
    (acc, m, l) against the reference's."""
    jx, tx = _inputs(rng, b, h, kh, s, d)
    want = j_ref.decode_attention(*jx)
    _close(t_ref.decode_attention(*tx), want)
    _close(t_ops.decode_attention(*tx), j_ops.decode_attention(*jx, tk=128))
    for got, ref in zip(t_ops.decode_attention_partial(*tx),
                        j_ref.decode_attention_partial(*jx)):
        assert got.dtype == torch.float32
        _close(got, ref, atol=2e-5, rtol=1e-5)


def test_merge_matches_monolithic(rng):
    """A 4-way split of the cache merged by ``merge_partials`` equals the
    monolithic result, and the merged partials equal the reference's
    merged partials."""
    jx, tx = _inputs(rng, 2, 4, 2, 512, 64, kv_len=[500, 70])
    (q, k, v, kv_len), (jq, jk, jv, jlen) = tx, jx
    t_parts, j_parts = [], []
    for i in range(4):
        sl = slice(i * 128, (i + 1) * 128)
        t_parts.append(t_ref.decode_attention_partial(
            q, k[:, :, sl], v[:, :, sl], torch.clamp(kv_len - i * 128, 0, 128)))
        j_parts.append(j_ref.decode_attention_partial(
            jq, jk[:, :, sl], jv[:, :, sl], jnp.clip(jlen - i * 128, 0, 128)))
    t_acc, j_acc = t_parts[0], j_parts[0]
    for tp, jp in zip(t_parts[1:], j_parts[1:]):
        t_acc = t_ref.merge_partials(*t_acc, *tp)
        j_acc = j_ref.merge_partials(*j_acc, *jp)
    for got, ref in zip(t_acc, j_acc):
        _close(got, ref, atol=2e-5, rtol=1e-5)
    _close(t_ref.normalize(t_acc[0], t_acc[2], q.dtype),
           j_ref.decode_attention(*jx))


def test_empty_shard(rng):
    """A shard with no live key does not poison the merge."""
    jx, tx = _inputs(rng, 1, 2, 1, 128, 32, kv_len=[64])
    q, k, v, _ = tx
    a1 = t_ref.decode_attention_partial(q, k, v, torch.tensor([64], dtype=torch.int32))
    a2 = t_ref.decode_attention_partial(q, k, v, torch.tensor([0], dtype=torch.int32))
    acc, m, l = t_ref.merge_partials(*a1, *a2)
    got = t_ref.normalize(acc, l, q.dtype)
    _close(got, j_ref.decode_attention(*jx))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("impl", ["plain", "wrapper"])
def test_kv_len_zero_is_the_empty_partial(rng, impl):
    """Where no key is live: m = -inf, l = 0, acc = 0, output 0, no NaN,
    as the reference's partials; a row beside it with kv_len 1 attends its
    first key only."""
    jx, tx = _inputs(rng, 2, 4, 2, 64, 16, kv_len=[0, 1])
    fn = (t_ref.decode_attention_partial if impl == "plain"
          else t_ops.decode_attention_partial)
    acc, m, l = fn(*tx)
    ja, jm, jl = j_ref.decode_attention_partial(*jx)
    assert torch.isneginf(m[0]).all() and (l[0] == 0).all()
    assert (acc[0] == 0).all()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    _close(l, jl)
    out = t_ops.decode_attention(*tx)
    assert (out[0] == 0).all() and torch.isfinite(out).all()
    _close(out[1], torch.repeat_interleave(tx[2][1, :, 0], 2, 0))


def test_bf16_cache(rng):
    """bf16 q and cache: partials stay float32 and match the reference's
    oracle on the same bf16 values; the output is bf16."""
    jx, tx = _inputs(rng, 2, 6, 1, 96, 64)
    tx = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in tx]
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) if t.is_floating_point()
          else jnp.asarray(t.numpy()) for t in tx]
    for got, ref in zip(t_ops.decode_attention_partial(*tx),
                        j_ref.decode_attention_partial(*jx)):
        assert got.dtype == torch.float32
        _close(got, ref, atol=1e-5, rtol=1e-5)
    out = t_ops.decode_attention(*tx)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(
        j_ref.decode_attention(*jx), np.float32), atol=2e-2)


@pytest.mark.parametrize("b,kh,s", [(1, 1, 1), (8, 2, 544), (1, 8, 32768),
                                    (64, 8, 100), (2, 2, 33)])
def test_splits_cover_the_cache_in_whole_tiles(b, kh, s):
    split, n = t_ops.splits(b, kh, s)
    assert split % t_ops.TILE == 0 and split * n >= s > split * (n - 1)
    assert b * kh * n <= max(b * kh, 2 * t_ops.SMS + b * kh)
