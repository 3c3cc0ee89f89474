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


def _key_shares(length, n_split):
    """The [begin, end) keys each rank of a cluster takes of a row with
    ``length`` live keys, by the rule of ``key_share`` in
    ``csrc/flash_decode.cu``: whole tiles, the same number to each rank but
    the last busy one. The card-only tests hold the kernel's outputs on
    ragged rows against the plain version, which is what shows the kernel
    keeps to it."""
    per = -(-(-(-length // t_ops.TILE)) // n_split)
    return [(min(r * per * t_ops.TILE, length),
             min((r + 1) * per * t_ops.TILE, length))
            for r in range(n_split)]


@pytest.mark.parametrize("b,kh,s", [(1, 1, 1), (8, 2, 544), (1, 8, 32768),
                                    (64, 8, 100), (2, 2, 33)])
def test_splits_cover_the_cache_in_whole_tiles(b, kh, s):
    """The cluster rule at several SM counts: a size in ``CLUSTERS`` up to
    the card's largest, B * KH * size within two blocks an SM, at least two
    tiles a block, and no larger size would keep all three; each row's live
    keys divided among the ranks in whole tiles, in order."""
    tiles = -(-s // t_ops.TILE)
    per_sm, min_tiles = t_ops.PER_SM, t_ops.MIN_TILES
    assert (per_sm, min_tiles) == (2, 2)
    for sms in (132, 114, 78, 16):
        for most in (8, 16):
            n = t_ops.cluster_size(b, kh, s, sms, most)
            assert n in t_ops.CLUSTERS and n <= most
            assert n == 1 or (b * kh * n <= per_sm * sms
                              and min_tiles * n <= tiles)
            assert (2 * n > most or b * kh * 2 * n > per_sm * sms
                    or min_tiles * 2 * n > tiles)
            for length in sorted({0, 1, s // 2, max(0, s - 1), s}):
                shares = _key_shares(length, n)
                assert len(shares) == n and shares[0][0] == 0
                assert shares[-1][1] == length
                for (b0, e0), (b1, _) in zip(shares, shares[1:]):
                    assert e0 == b1                       # contiguous
                for lo, hi in shares:
                    assert lo <= hi
                    assert lo % t_ops.TILE == 0 or lo == hi == length
                    assert hi % t_ops.TILE == 0 or hi == length
                busy = [hi - lo for lo, hi in shares if hi > lo]
                assert len(set(busy[:-1])) <= 1           # equal but the last


def test_cluster_size_at_the_serve_shape():
    """qwen2-1.5b decoding at batch 8 on 132 SMs: 16 clusters of 8 blocks
    at the serve cache (17 tiles, two or three a block), of 16 at a
    32,768-key cache (256 blocks, about two an SM); a batch that fills the
    SMs twice alone takes no split, and a two-tile cache none either."""
    assert t_ops.cluster_size(8, 2, 544, 132) == 8
    assert t_ops.cluster_size(8, 2, 32768, 132) == 16
    assert t_ops.cluster_size(8, 2, 32768, 132, most=8) == 8
    assert t_ops.cluster_size(1, 1, 32768, 132) == 16
    assert t_ops.cluster_size(66, 2, 544, 132) == 2
    assert t_ops.cluster_size(132, 2, 544, 132) == 1
    assert t_ops.cluster_size(4, 2, 40, 132) == 1          # two tiles only
    assert t_ops.cluster_size(4, 2, 128, 132) == 2


def test_key_shares_leave_late_ranks_empty_on_a_short_row():
    """A row of 33 live keys over 8 ranks: two tiles for ranks 0 and 1,
    nothing for the other six (the kernel writes their empty partial)."""
    assert _key_shares(33, 8) == [(0, 32), (32, 33)] + [(33, 33)] * 6
    assert _key_shares(0, 4) == [(0, 0)] * 4


def _cpu_inputs(b=2, h=4, kh=2, s=64, d=32, dtype=torch.bfloat16):
    return (torch.zeros((b, h, d), dtype=dtype),
            torch.zeros((b, kh, s, d), dtype=dtype),
            torch.zeros((b, kh, s, d), dtype=dtype),
            torch.full((b,), s, dtype=torch.int32))


def test_check_inputs_takes_what_the_kernel_takes():
    assert t_ops.check_inputs(*_cpu_inputs()) == (2, 4, 2, 64, 32)
    q, k, v, kv_len = _cpu_inputs(h=32, kh=1, d=128, dtype=torch.float32)
    assert t_ops.check_inputs(q, k, v, kv_len) == (2, 32, 1, 64, 128)


@pytest.mark.parametrize("case,match", [
    ("d48", "D in"), ("g64", "H / KH"), ("f16", "bfloat16"),
    ("kv_int64", "kv_len"), ("v_dtype", "v must"), ("k_strided", "k must"),
    ("q_2d", "3-d")])
def test_check_inputs_refuses_shapes_it_does_not_take(case, match):
    q, k, v, kv_len = _cpu_inputs()
    if case == "d48":
        q, k, v, kv_len = _cpu_inputs(d=48)
    elif case == "g64":
        q, k, v, kv_len = _cpu_inputs(h=64, kh=1)
    elif case == "f16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "kv_int64":
        kv_len = kv_len.long()
    elif case == "v_dtype":
        v = v.float()
    elif case == "k_strided":
        k = torch.zeros((2, 2, 64, 64), dtype=torch.bfloat16)[..., :32]
    elif case == "q_2d":
        q = q[0]
    with pytest.raises(ValueError, match=match):
        t_ops.check_inputs(q, k, v, kv_len)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_check_inputs_refuses_a_misaligned_view(which):
    """The bulk copies need k and v on a 16-byte boundary (q keeps the same
    rule): a contiguous view 2 bytes into a buffer is refused."""
    q, k, v, kv_len = _cpu_inputs()
    t = {"q": q, "k": k, "v": v}[which]
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    shifted = flat[1:1 + t.numel()].view(t.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    args = {"q": q, "k": k, "v": v, which: shifted}
    with pytest.raises(ValueError, match="16-byte"):
        t_ops.check_inputs(args["q"], args["k"], args["v"], kv_len)


@pytest.mark.parametrize("b,h,kh,s", [(2, 32, 32, 96), (3, 6, 2, 200)])
def test_head_dim_80(rng, b, h, kh, s):
    """zamba2's head dim 80 (its decode: H = KH = 32): the normalised
    output and the partials of the port's plain version and wrapper against
    the reference's oracle; the checks take the shape."""
    jx, tx = _inputs(rng, b, h, kh, s, 80)
    want = j_ref.decode_attention(*jx)
    _close(t_ref.decode_attention(*tx), want)
    _close(t_ops.decode_attention(*tx), want)
    for got, ref in zip(t_ops.decode_attention_partial(*tx),
                        j_ref.decode_attention_partial(*jx)):
        _close(got, ref, atol=2e-5, rtol=1e-5)
    assert t_ops.check_inputs(*tx) == (b, h, kh, s, 80)


def test_cross_step_over_the_encoder_cache(rng):
    """The encoder-decoder's cross step: one query a head over a cache of
    encoder frames, every key live (kv_len = the frame count), G = 1."""
    jx, tx = _inputs(rng, 2, 16, 16, 1024 // 8, 64, kv_len=[128, 128])
    _close(t_ops.decode_attention(*tx), j_ref.decode_attention(*jx))
