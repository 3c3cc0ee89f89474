"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Card-only (marker ``gpu``): every test skips without a CUDA device. This file
imports neither JAX nor the reference package, so it also runs where only
the port is installed:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.predicates import Predicate, compile_conditions  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402
from repro_torch.kernels.join_compact import ops as jc_ops  # noqa: E402
from repro_torch.kernels.join_compact import ref as jc_ref  # noqa: E402
from repro_torch.kernels.predicate_filter import ops as pf_ops  # noqa: E402
from repro_torch.kernels.predicate_filter import ref as pf_ref  # noqa: E402
from repro_torch.kernels.spatial_match import ops as sm_ops  # noqa: E402

from torch_parity import cuda_device  # noqa: E402,F401

pytestmark = pytest.mark.gpu
OPS = ["==", "!=", "<", "<=", ">", ">="]


def _conds(rng, nchan, nfields=10):
    chans = []
    for _ in range(nchan):
        seen, preds = {}, []
        for _ in range(int(rng.integers(1, 4))):
            f, op, v = (int(rng.integers(0, nfields)),
                        OPS[int(rng.integers(0, 6))],
                        int(rng.integers(-40, 40)))
            if op == "!=" and seen.setdefault(f, v) != v:
                continue
            preds.append(Predicate.parse(f, op, v))
        chans.append(preds)
    return compile_conditions(chans)


def test_predicate_filter_kernel_matches_plain(rng, cuda_device):
    fields = torch.as_tensor(rng.integers(-50, 50, (70000, 10))
                             .astype(np.int32), device=cuda_device)
    conds = _conds(rng, 5)
    lo, hi, neq = (torch.as_tensor(a, device=cuda_device)
                   for a in pf_ops.canonical_arrays(conds, 10))
    before = pf_ops.LAUNCHES
    for n in (1, 255, 257, 70000):
        x = fields[:n].contiguous()
        got = pf_ops.predicate_filter(x, conds)
        assert got.is_cuda and got.dtype == torch.bool
        assert torch.equal(got, pf_ref.predicate_filter(x, lo, hi, neq))
    torch.cuda.synchronize()
    assert pf_ops.LAUNCHES == before + 4


def test_predicate_filter_kernel_int32_extremes(cuda_device):
    fields = torch.tensor([[-2**31, 2**31 - 1, 0, 5, 0, 0, 0, 0, 0, 0]],
                          dtype=torch.int32, device=cuda_device)
    conds = compile_conditions([[Predicate.parse(0, "<=", -2**31 + 1)],
                                [Predicate.parse(1, ">=", 2**31 - 1)],
                                [Predicate.parse(3, "==", 5),
                                 Predicate.parse(3, "!=", 4)]])
    assert pf_ops.predicate_filter(fields, conds).tolist() == [[True] * 3]


def test_spatial_match_kernel_matches_plain(rng, cuda_device):
    before = sm_ops.LAUNCHES
    for r, u in ((1, 1), (300, 700), (16384, 257), (33, 10000)):
        t = torch.as_tensor(rng.uniform(-100, 100, (r, 2)).astype(np.float32),
                            device=cuda_device)
        us = torch.as_tensor(rng.uniform(-100, 100, (u, 2)).astype(np.float32),
                             device=cuda_device)
        got = sm_ops.spatial_match(t, us, 10.0)
        assert got.is_cuda and got.dtype == torch.bool
        assert torch.equal(got, sm_ops.spatial_match_plain(t, us, 10.0))
    torch.cuda.synchronize()
    assert sm_ops.LAUNCHES == before + 4


def test_predicate_filter_rows_kernel_matches_plain(rng, cuda_device):
    before = pf_ops.ROWS_LAUNCHES
    for c, n in ((1, 1), (3, 255), (3, 257), (5, 9000)):
        fields = torch.as_tensor(rng.integers(-50, 50, (c, n, 10))
                                 .astype(np.int32), device=cuda_device)
        conds = _conds(rng, c)
        lo, hi, neq = (torch.as_tensor(a, device=cuda_device)
                       for a in pf_ops.canonical_arrays(conds, 10))
        got = pf_ops.predicate_filter_rows(fields, conds)
        assert got.is_cuda and got.dtype == torch.bool and got.shape == (c, n)
        assert torch.equal(got, pf_ref.predicate_filter_rows(fields, lo, hi,
                                                             neq))
    torch.cuda.synchronize()
    assert pf_ops.ROWS_LAUNCHES == before + 4


def test_spatial_match_stacked_kernel_matches_plain(rng, cuda_device):
    before = sm_ops.STACKED_LAUNCHES
    for c, r, u in ((1, 1, 1), (3, 300, 700), (3, 33, 10000)):
        t = torch.as_tensor(rng.uniform(-100, 100, (c, r, 2))
                            .astype(np.float32), device=cuda_device)
        us = torch.as_tensor(rng.uniform(-100, 100, (c, u, 2))
                             .astype(np.float32), device=cuda_device)
        us[:, u // 2:] = -sm_ops.FAR          # the engine's padded users
        radius = torch.linspace(5.0, 20.0, c, device=cuda_device)
        got = sm_ops.spatial_match(t, us, radius)
        assert got.is_cuda and got.dtype == torch.bool
        assert torch.equal(got, sm_ops.spatial_match_plain(t, us, radius))
        assert not got[:, :, u // 2:].any()
    torch.cuda.synchronize()
    assert sm_ops.STACKED_LAUNCHES == before + 3


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_join_compact_kernel_matches_plain(rng, cuda_device):
    """Exact, dtypes included, on ``chip_smoke.join_cases`` (maxT 1, 2, 3,
    4, 7, 16, 17 and 64 with S off every block size, three rows 16,384
    wide, no live target, no valid entry, tgt_n > maxT, tgt_n 0 with every
    entry valid, byte sums that wrap past int32), both layouts: on new
    tensors the quad path runs where maxT % 4 == 0 and the pair path
    elsewhere; on views 4 B off the 16-B boundary only the pair path."""
    cs = _chip_smoke()
    before = (jc_ops.LAUNCHES, jc_ops.VECTOR_LAUNCHES)
    launches = vector = 0
    for tag, case in cs.join_cases(rng):
        max_t = case[0].shape[1]
        for lead in (0, 1):
            dev = [cs.offset_copy(torch.as_tensor(a, device=cuda_device),
                                  lead) for a in case]
            assert jc_ops.vector_ok(dev, max_t) == (lead == 0
                                                    and max_t % 4 == 0)
            for aggregated in (False, True):
                got = jc_ops.join_pairs(*dev, 3, aggregated)
                want = jc_ref.join_pairs(*dev, 3, aggregated)
                assert got[0].dtype == torch.bool
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), \
                        (tag, lead, aggregated)
                launches += 1
                vector += lead == 0 and max_t % 4 == 0
    torch.cuda.synchronize()
    assert (jc_ops.LAUNCHES, jc_ops.VECTOR_LAUNCHES) == (
        before[0] + launches, before[1] + vector)
    jc_ops.SHAPE = None
    small = [torch.as_tensor(a, device=cuda_device)
             for a in cs.join_inputs(rng, 4099, 64)]
    jc_ops.join_pairs(*small, 3, True)
    jc_ops.join_pairs(*(a[:1000].contiguous() for a in small), 3, True)
    assert jc_ops.SHAPE == (4099, 64)      # the largest launch is kept


def test_join_compact_stores_stay_in_the_output(rng, cuda_device):
    """Every output is a view into a buffer whose neighbours hold a
    sentinel, on both paths: no quad or pair writes past its rows, and the
    values inside match the plain version."""
    cs = _chip_smoke()
    for tag, case in cs.join_cases(rng):
        for lead in (0, 1):
            dev = [cs.offset_copy(torch.as_tensor(a, device=cuda_device),
                                  lead) for a in case]
            for aggregated in (False, True):
                got = cs.join_into_sentinel(dev, aggregated, lead)
                want = jc_ref.join_pairs(*dev, 4, aggregated)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), \
                        (tag, lead, aggregated)


@pytest.mark.parametrize("shape,aggregated", [((16384, 16), True),
                                              ((8192, 16384), False)])
def test_join_compact_vector_path_at_the_path_shapes(rng, cuda_device, shape,
                                                     aggregated):
    """The fused path's shape and the compact phase's real grid take the
    quad path, exactly."""
    cs = _chip_smoke()
    case = cs.case_join_compact(cuda_device, rng, shape, aggregated)
    assert case["info"]["path"] == "vector"
    before = (jc_ops.LAUNCHES, jc_ops.VECTOR_LAUNCHES)
    got, want = case["wrapper"](), case["plain"]()
    torch.cuda.synchronize()
    assert (jc_ops.LAUNCHES, jc_ops.VECTOR_LAUNCHES) == (before[0] + 1,
                                                         before[1] + 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros((4, 10), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        pf_ops.predicate_filter(x, _conds(np.random.default_rng(0), 2))
    t = torch.zeros((4, 3), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sm_ops.spatial_match(t, t, 1.0)
    i32 = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="valid"):
        jc_ops.join_pairs(i32, i32[:, 0].contiguous(), i32, i32,
                          i32[:, 0].contiguous(), i32[:, 0].contiguous(), 2,
                          False)


# flash kernels: float32 and bfloat16 against the plain versions, per
# element |kernel - plain| <= atol + rtol |plain|: the reference kernel
# test's 3e-5 (f32) and 2e-2 (bf16, where the plain version rounds the
# softmax weights to bf16 and the kernel does not), and in bf16 one more
# rounding step of the output (2^-7 |plain|), as chip_smoke.py holds them
FLASH_TOL = {torch.float32: (3e-5, 0.0), torch.bfloat16: (2e-2, 2.0 ** -7)}


def _within(got, want, dtype) -> bool:
    atol, rtol = FLASH_TOL[dtype]
    got, want = got.double(), want.double()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _normal(rng, shape, dtype, device):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                           device=device).to(dtype)


# the bf16 kernel packs the G query heads of a KV head into one (G * S, D)
# slab cut in 64-row tiles: slabs that end inside a tile (G * S = 66, 60,
# 40), a full slab of 6 x 64 rows, tiles that lie inside one head (S = 512)
# and G = 1
PACKED_CASES = [(2, 12, 2, 11, 128, True), (1, 6, 1, 64, 128, False),
                (3, 12, 2, 10, 16, True), (1, 12, 2, 512, 128, True),
                (2, 8, 8, 40, 64, True)]
SENTINEL = -12288.0     # exact in bf16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(rng, cuda_device, dtype):
    before = fa_ops.LAUNCHES
    cases = [(1, 2, 1, 1, 16, True), (2, 6, 1, 10, 32, True),
             (2, 12, 2, 10, 128, False), (1, 6, 6, 33, 64, True),
             (2, 12, 2, 300, 128, True), (1, 4, 2, 256, 64, False),
             (3, 8, 2, 97, 128, True), *PACKED_CASES]
    for b, h, kh, s, d, causal in cases:
        q = _normal(rng, (b, h, s, d), dtype, cuda_device)
        k, v = (_normal(rng, (b, kh, s, d), dtype, cuda_device)
                for _ in range(2))
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        want = fa_ref.flash_attention(q, k, v, causal=causal)
        assert got.dtype == dtype and got.shape == q.shape
        assert _within(got, want, dtype), ((b, h, kh, s, d, causal), float(
            (got.float() - want.float()).abs().max()))
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + len(cases)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_stores_stay_in_the_output(rng, cuda_device,
                                                          dtype):
    """The output is a view into a buffer whose 64 rows on each side hold a
    sentinel: a tile stored past its slab's end (or before the first) would
    overwrite it. The values inside match the plain version."""
    for b, h, kh, s, d, causal in PACKED_CASES:
        q = _normal(rng, (b, h, s, d), dtype, cuda_device)
        k, v = (_normal(rng, (b, kh, s, d), dtype, cuda_device)
                for _ in range(2))
        pad, n = 64 * d, q.numel()
        buf = torch.full((n + 2 * pad,), SENTINEL, dtype=dtype,
                         device=cuda_device)
        out = buf[pad:pad + n].view(q.shape)
        fa_ops._launch(q, k, v, causal, d ** -0.5, out=out)
        torch.cuda.synchronize()
        assert bool((buf[:pad] == SENTINEL).all()
                    and (buf[pad + n:] == SENTINEL).all()), (b, h, kh, s, d)
        want = fa_ref.flash_attention(q, k, v, causal=causal)
        assert _within(out, want, dtype), ((b, h, kh, s, d, causal), float(
            (out.float() - want.float()).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(rng, cuda_device, dtype):
    """Partials and output against the plain version: kv_len 0, 1, ragged
    and the full cache; G = 1 and 6; a cache longer than one split."""
    before = fd_ops.LAUNCHES
    cases = [(2, 1, 1, 64, 16), (4, 12, 2, 544, 128), (3, 6, 6, 100, 32),
             (1, 6, 1, 5000, 64)]
    for b, h, kh, s, d in cases:
        q = _normal(rng, (b, h, d), dtype, cuda_device)
        k, v = (_normal(rng, (b, kh, s, d), dtype, cuda_device)
                for _ in range(2))
        lens = [s, 0, 1, int(rng.integers(2, s))][:b]
        kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        got = fd_ops.decode_attention_partial(q, k, v, kv_len)
        want = fd_ref.decode_attention_partial(q, k, v, kv_len)
        for g, w, name in zip(got, want, ("acc", "m", "l")):
            assert g.dtype == torch.float32 and g.shape == w.shape, name
            assert torch.equal(torch.isneginf(g), torch.isneginf(w)), name
            fin = torch.isfinite(w)
            assert torch.isfinite(g[fin]).all(), name
            err = float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0
            assert err <= 2e-5 + 1e-5 * float(w[fin].abs().max()), (name, err)
        out = fd_ops.decode_attention(q, k, v, kv_len)
        assert out.dtype == dtype and torch.isfinite(out.float()).all()
        assert not out[kv_len == 0].float().any()            # kv_len 0
        assert _within(out, fd_ref.decode_attention(q, k, v, kv_len), dtype)
    torch.cuda.synchronize()
    assert fd_ops.LAUNCHES == before + 2 * len(cases)
    assert fd_ops.SHAPE is not None


def _attention_between_sentinels(q, k, v, causal, dtype, device):
    """``flash_attention`` written into a view whose 64 rows on each side
    hold a sentinel: asserts they survive and returns the output."""
    d = q.shape[-1]
    pad, n = 64 * d, q.numel()
    buf = torch.full((n + 2 * pad,), SENTINEL, dtype=dtype, device=device)
    out = buf[pad:pad + n].view(q.shape)
    fa_ops._launch(q, k, v, causal, d ** -0.5, out=out)
    torch.cuda.synchronize()
    assert bool((buf[:pad] == SENTINEL).all()
                and (buf[pad + n:] == SENTINEL).all()), tuple(q.shape)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_80(rng, cuda_device, dtype):
    """Head dim 80 (zamba2): in bf16 the D = 128 plan over 80-wide tensor
    maps, so the loads' columns 80-127 are TMA's zeros and the store clips
    them (a column stored past 80 would overwrite the next row, or the
    sentinel after the last); causal and full, G = 1 and 2, S on and off
    the tile, against the plain version."""
    for b, h, kh, s, causal in ((2, 32, 32, 512, True), (1, 4, 2, 300, True),
                                (2, 4, 2, 97, False), (1, 2, 2, 10, True),
                                (1, 2, 1, 64, False)):
        q = _normal(rng, (b, h, s, 80), dtype, cuda_device)
        k, v = (_normal(rng, (b, kh, s, 80), dtype, cuda_device)
                for _ in range(2))
        got = _attention_between_sentinels(q, k, v, causal, dtype,
                                           cuda_device)
        want = fa_ref.flash_attention(q, k, v, causal=causal)
        assert _within(got, want, dtype), ((b, h, kh, s, causal), float(
            (got.float() - want.float()).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_key_length(rng, cuda_device, dtype):
    """Non-causal attention with k/v of their own length Sk: the
    encoder-decoder's cross-attention (4 decoder positions over 1,024
    frames), ragged lengths either way, Sk <= 16 (the short key tile),
    head dims 16 to 128, against the plain version, between sentinels."""
    for b, h, kh, sq, sk, d in ((2, 16, 16, 4, 1024, 64),
                                (1, 6, 2, 7, 300, 32), (2, 4, 2, 130, 3, 16),
                                (2, 8, 8, 5, 77, 80), (1, 12, 2, 70, 600, 128),
                                (3, 2, 1, 65, 16, 64)):
        q = _normal(rng, (b, h, sq, d), dtype, cuda_device)
        k, v = (_normal(rng, (b, kh, sk, d), dtype, cuda_device)
                for _ in range(2))
        got = _attention_between_sentinels(q, k, v, False, dtype,
                                           cuda_device)
        want = fa_ref.flash_attention(q, k, v, causal=False)
        assert _within(got, want, dtype), ((b, h, kh, sq, sk, d), float(
            (got.float() - want.float()).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_head_dim_80(rng, cuda_device, dtype):
    """Head dim 80 on both entries at zamba2's decode (H = KH = 32, 8 rows,
    a 528-key cache, ragged kv_len) and with G = 6, between sentinels."""
    for b, h, kh, s in ((8, 32, 32, 528), (3, 12, 2, 300)):
        q, k, v, kv_len = _decode_case(rng, cuda_device, dtype, b, h, kh, s,
                                       80, [s, 0, 1, s // 2, 33, s - 1])
        for normalized in (True, False):
            out_dtype = dtype if normalized else torch.float32
            pad, n = 64 * 80, q.numel()
            buf = torch.full((n + 2 * pad,), SENTINEL, dtype=out_dtype,
                             device=cuda_device)
            out = buf[pad:pad + n].view(q.shape)
            got = fd_ops._launch(q, k, v, kv_len, 80 ** -0.5, normalized,
                                 out=out)
            torch.cuda.synchronize()
            assert bool((buf[:pad] == SENTINEL).all()
                        and (buf[pad + n:] == SENTINEL).all())
            want = (fd_ref.decode_attention(q, k, v, kv_len) if normalized
                    else fd_ref.decode_attention_partial(q, k, v, kv_len))
            _decode_close(got, want, normalized, dtype)


def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 2, 8, 48), device=cuda_device)       # D = 48
    with pytest.raises(ValueError, match=r"D in \(16, 32, 64, 80, 128\)"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 32), device=cuda_device)
    k = torch.zeros((1, 2, 9, 32), device=cuda_device)       # Sk != Sq
    with pytest.raises(ValueError, match="causal attention needs k"):
        fa_ops.flash_attention(q, k, k, causal=True)
    q = torch.zeros((1, 2, 8, 32), dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        fa_ops.flash_attention(q, q, q)
    flat = torch.zeros(1 + 2 * 8 * 32, dtype=torch.bfloat16,
                       device=cuda_device)
    q = flat[1:].view(1, 2, 8, 32)                           # 2-byte offset
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    q = torch.zeros((1, 2, 48), device=cuda_device)
    k = torch.zeros((1, 1, 8, 48), device=cuda_device)
    with pytest.raises(ValueError, match=r"D in \(16, 32, 64, 80, 128\)"):
        fd_ops.decode_attention(q, k, k, torch.zeros((1,), dtype=torch.int32,
                                                     device=cuda_device))
    q = torch.zeros((1, 2, 32), device=cuda_device)
    k = torch.zeros((1, 1, 8, 32), device=cuda_device)
    with pytest.raises(ValueError, match="kv_len"):
        fd_ops.decode_attention(q, k, k, torch.zeros((1,), dtype=torch.int64,
                                                     device=cuda_device))


# the clustered flash_decode kernel: partials within 2e-5 + 1e-5 x
# max|plain| (m exactly -inf, l = acc = 0 where no key is live), outputs
# within FLASH_TOL (0 where no key is live)
def _decode_close(got, want, normalized, dtype):
    if normalized:
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        assert _within(got, want, dtype), float(
            (got.float() - want.float()).abs().max())
        return
    empty = torch.isneginf(want[1])
    assert torch.isneginf(got[1][empty]).all()
    assert not got[2][empty].any() and not got[0][empty].any()
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.equal(torch.isneginf(g), torch.isneginf(w)), name
        fin = torch.isfinite(w)
        err = float((g[fin] - w[fin]).abs().max()) if fin.any() else 0.0
        assert err <= 2e-5 + 1e-5 * float(w[fin].abs().max()), (name, err)


def _decode_case(rng, device, dtype, b, h, kh, s, d, lens):
    q = _normal(rng, (b, h, d), dtype, device)
    k, v = (_normal(rng, (b, kh, s, d), dtype, device) for _ in range(2))
    kv_len = torch.tensor([lens[i % len(lens)] for i in range(b)],
                          dtype=torch.int32, device=device)
    return q, k, v, kv_len


def _both_entries(q, k, v, kv_len, dtype):
    for normalized in (True, False):
        got = (fd_ops.decode_attention(q, k, v, kv_len) if normalized
               else fd_ops.decode_attention_partial(q, k, v, kv_len))
        want = (fd_ref.decode_attention(q, k, v, kv_len) if normalized
                else fd_ref.decode_attention_partial(q, k, v, kv_len))
        _decode_close(got, want, normalized, dtype)


def _cluster(device, q, k):
    """The blocks a cluster that a call on (q, k) takes on ``device``."""
    from repro_torch.kernels import _build
    b, h, d = q.shape
    return fd_ops.plan(_build.library(), device, b, h, k.shape[1],
                       k.shape[2], d, q.dtype)


def _largest_cluster(device):
    q = torch.zeros((1, 1, 128), dtype=torch.bfloat16, device=device)
    return _cluster(device, q, torch.zeros((1, 1, 1024, 128),
                                           dtype=torch.bfloat16,
                                           device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_each_cluster_size(rng, cuda_device, dtype):
    """B * KH chosen from the SM count so that the wrapper picks each
    cluster size the card takes (16 only where it does)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    most = _largest_cluster(cuda_device)
    for n in [c for c in fd_ops.CLUSTERS if c <= most]:
        b, s = max(1, sms // n), 64 * n
        want_n = fd_ops.cluster_size(b, 1, s, sms, most)
        q, k, v, kv_len = _decode_case(rng, cuda_device, dtype, b, 2, 1, s,
                                       128, [s, 0, 33, s - 1])
        _both_entries(q, k, v, kv_len, dtype)
        got_n = _cluster(cuda_device, q, k)
        assert got_n == want_n == n, (n, want_n, got_n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_ragged_batch_leaves_ranks_empty(rng, cuda_device,
                                                     dtype):
    """Rows of 1, 31, 33 and 0 live keys beside a full one: most ranks of
    their clusters get no key and write the empty partial."""
    q, k, v, kv_len = _decode_case(rng, cuda_device, dtype, 8, 12, 2, 1024,
                                   128, [1024, 1, 31, 33, 0, 700, 64, 1023])
    _both_entries(q, k, v, kv_len, dtype)
    assert _cluster(cuda_device, q, k) >= 4


@pytest.mark.parametrize("g", [1, 3, 4, 6, 8, 32])
def test_flash_decode_groups_and_head_dims(rng, cuda_device, g):
    """Each group size the block layouts differ by (each compiled bound of
    heads a warp, one or two warp groups, one to four warps a group) at
    every head dim, both types."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in fd_ops.HEAD_DIMS:
            q, k, v, kv_len = _decode_case(rng, cuda_device, dtype, 3, g, 1,
                                           200, d, [200, 0, 77])
            _both_entries(q, k, v, kv_len, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_stores_stay_in_the_output(rng, cuda_device, dtype):
    """Both entries write into a view whose 64 rows on each side hold a
    sentinel; the values inside match the plain version."""
    for b, h, kh, s, d in ((2, 12, 2, 544, 128), (3, 6, 1, 100, 32),
                           (4, 2, 2, 33, 16)):
        q, k, v, kv_len = _decode_case(rng, cuda_device, dtype, b, h, kh, s,
                                       d, [s, 0, 1, s // 2])
        for normalized in (True, False):
            out_dtype = dtype if normalized else torch.float32
            pad, n = 64 * d, q.numel()
            buf = torch.full((n + 2 * pad,), SENTINEL, dtype=out_dtype,
                             device=cuda_device)
            out = buf[pad:pad + n].view(q.shape)
            got = fd_ops._launch(q, k, v, kv_len, d ** -0.5, normalized,
                                 out=out)
            torch.cuda.synchronize()
            assert bool((buf[:pad] == SENTINEL).all()
                        and (buf[pad + n:] == SENTINEL).all())
            want = (fd_ref.decode_attention(q, k, v, kv_len) if normalized
                    else fd_ref.decode_attention_partial(q, k, v, kv_len))
            _decode_close(got, want, normalized, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_replays_in_a_cuda_graph(rng, cuda_device, dtype):
    """One call of each entry captured in a CUDA graph, replayed after new
    values are written into q, the cache and kv_len (the wrapper reads
    kv_len on the device only)."""
    q, k, v, kv_len = _decode_case(rng, cuda_device, dtype, 4, 12, 2, 544,
                                   128, [544, 0, 100, 1])
    fd_ops.decode_attention(q, k, v, kv_len)
    fd_ops.decode_attention_partial(q, k, v, kv_len)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd_ops.decode_attention(q, k, v, kv_len)
        part = fd_ops.decode_attention_partial(q, k, v, kv_len)
    for t in (q, k, v):
        t.copy_(_normal(rng, tuple(t.shape), dtype, cuda_device))
    kv_len.copy_(torch.tensor([7, 541, 0, 260], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    _decode_close(out, fd_ref.decode_attention(q, k, v, kv_len), True, dtype)
    _decode_close(part, fd_ref.decode_attention_partial(q, k, v, kv_len),
                  False, dtype)


def test_flash_decode_refuses_a_misaligned_view(rng, cuda_device):
    q, k, v, kv_len = _decode_case(rng, cuda_device, torch.bfloat16, 2, 4, 2,
                                   64, 32, [64, 3])
    flat = torch.zeros(k.numel() + 8, dtype=k.dtype, device=cuda_device)
    shifted = flat[1:1 + k.numel()].view(k.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fd_ops.decode_attention(q, shifted, v, kv_len)
    with pytest.raises(ValueError, match="16-byte"):
        fd_ops.decode_attention_partial(q, k, shifted, kv_len)


def test_flash_decode_enqueues_one_kernel_a_call(cuda_device):
    """One call of each entry at the serve shape enqueues one flash_decode
    kernel and nothing else: ``chip_smoke.py``'s check, which brackets the
    call with two marker kernels and profiles a window again where the
    profiler shows no marker, as it can for a process's first."""
    seen = _chip_smoke().one_kernel_per_decode_call(cuda_device)
    assert sorted(seen) == ["decode_attention", "decode_attention_partial"]


# the vectorized predicate_filter: bit-exact at N off every 16-byte vector
# and 256-row block, F = 1 and 10, both entries


@pytest.mark.parametrize("f", [1, 10])
def test_predicate_filter_vector_and_block_edges(rng, cuda_device, f):
    for c in (1, 3, 6):
        conds = _conds(rng, c, f)
        lo, hi, neq = (torch.as_tensor(a, device=cuda_device)
                       for a in pf_ops.canonical_arrays(conds, f))
        for n in (1, 3, 255, 257, 65537):
            x = torch.as_tensor(rng.integers(-40, 40, (n, f))
                                .astype(np.int32), device=cuda_device)
            got = pf_ops.predicate_filter(x, conds)
            assert got.shape == (n, c)
            assert torch.equal(got, pf_ref.predicate_filter(x, lo, hi, neq))


@pytest.mark.parametrize("c", [1, 6])
def test_predicate_filter_rows_vector_and_block_edges(rng, cuda_device, c):
    for f in (1, 10):
        conds = _conds(rng, c, f)
        lo, hi, neq = (torch.as_tensor(a, device=cuda_device)
                       for a in pf_ops.canonical_arrays(conds, f))
        for n in (1, 3, 255, 257, 65537):
            x = torch.as_tensor(rng.integers(-40, 40, (c, n, f))
                                .astype(np.int32), device=cuda_device)
            got = pf_ops.predicate_filter_rows(x, conds)
            assert torch.equal(got, pf_ref.predicate_filter_rows(x, lo, hi,
                                                                 neq))


def test_predicate_filter_rows_int32_extremes(cuda_device):
    x = torch.tensor([[[-2**31, 2**31 - 1, 0, 5, 0, 0, 0, 0, 0, 0]]] * 3,
                     dtype=torch.int32, device=cuda_device).view(3, 1, 10)
    conds = compile_conditions([[Predicate.parse(0, "<=", -2**31 + 1)],
                                [Predicate.parse(1, ">=", 2**31 - 1)],
                                [Predicate.parse(3, "==", 5),
                                 Predicate.parse(3, "!=", 4)]])
    assert pf_ops.predicate_filter_rows(x, conds).tolist() == [[True]] * 3
    conds = compile_conditions([[Predicate.parse(0, ">", -2**31)],
                                [Predicate.parse(1, "<", 2**31 - 1)],
                                [Predicate.parse(3, "!=", 5)]])
    assert pf_ops.predicate_filter_rows(x, conds).tolist() == [[False]] * 3


def test_predicate_filter_refuses_a_misaligned_view(cuda_device):
    shifted = torch.zeros(257 * 10 + 1, dtype=torch.int32,
                          device=cuda_device)[1:].view(257, 10)
    conds = _conds(np.random.default_rng(0), 2)
    with pytest.raises(ValueError, match="16-byte"):
        pf_ops.predicate_filter(shifted, conds)
    with pytest.raises(ValueError, match="16-byte"):
        pf_ops.predicate_filter_rows(shifted[None], _conds(
            np.random.default_rng(0), 1))


@pytest.mark.parametrize("c,f", [(12, 10), (2, 40), (128, 16), (300, 10)])
def test_predicate_filter_wide_tables(rng, cuda_device, c, f):
    """More than 8 channels, or more than 32 fields: the tables are
    compacted one channel a thread instead of one channel a warp. More
    channels than a block's 48 KB of shared memory holds beside its rows
    (the reference kernel's own budget, C = 128 at F = 16, and 300 at the
    schema's F = 10): both entries take the channels in chunks, and the
    rows form at N = 1 and 3 puts hundreds of channels in one block."""
    conds = _conds(rng, c, f)
    lo, hi, neq = (torch.as_tensor(a, device=cuda_device)
                   for a in pf_ops.canonical_arrays(conds, f))
    for n in (1, 3, 257, 4099):
        x = torch.as_tensor(rng.integers(-40, 40, (n, f)).astype(np.int32),
                            device=cuda_device)
        assert torch.equal(pf_ops.predicate_filter(x, conds),
                           pf_ref.predicate_filter(x, lo, hi, neq))
        xr = torch.as_tensor(rng.integers(-40, 40, (c, n, f))
                             .astype(np.int32), device=cuda_device)
        assert torch.equal(pf_ops.predicate_filter_rows(xr, conds),
                           pf_ref.predicate_filter_rows(xr, lo, hi, neq))



@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_shuffle_notify_on_the_card_matches_ref(rng, cuda_device, num_shards):
    """The cross-shard notify shuffle on CUDA tensors (every shard on the
    one card) gives ``shuffle_notify_ref``'s bits, on the card."""
    from repro_torch.distributed.collectives import (shuffle_notify,
                                                     shuffle_notify_ref)
    for cap in (1, 33, 4096):
        sids = rng.integers(0, 1 << 20, (num_shards, cap)).astype(np.int32)
        sids[rng.random(sids.shape) < 0.4] = -1
        owners = np.where(sids >= 0, rng.integers(0, num_shards, sids.shape),
                          -1).astype(np.int32)
        got = shuffle_notify([cuda_device] * num_shards,
                             torch.as_tensor(sids, device=cuda_device),
                             torch.as_tensor(owners, device=cuda_device))
        assert got.is_cuda and got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.cpu().numpy(), shuffle_notify_ref(sids, owners, num_shards))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sp_decode_attention_matches_one_flash_decode(rng, cuda_device,
                                                      dtype):
    """Four sequence slices of the cache on the one card, kv_len rows
    ending in every slice, at slice boundaries, in the first slice only
    (slices 2-4 empty for that row) and nowhere: the merged partials equal
    one ``flash_decode`` call within FLASH_TOL, 4 partial launches a
    call."""
    from repro_torch.distributed.collectives import sp_decode_attention
    from repro_torch.distributed.partition import Rules
    b, h, kh, s, d = 8, 12, 2, 544, 128
    q = _normal(rng, (b, h, d), dtype, cuda_device)
    k = _normal(rng, (b, kh, s, d), dtype, cuda_device)
    v = _normal(rng, (b, kh, s, d), dtype, cuda_device)
    kv_len = torch.tensor([543, 136, 100, 1, 544, 137, 408, 0],
                          dtype=torch.int32, device=cuda_device)
    rules = Rules([cuda_device] * 4)
    before = fd_ops.LAUNCHES
    got = sp_decode_attention(rules, q, k, v, kv_len)
    assert fd_ops.LAUNCHES - before == 4
    assert got.dtype == dtype and got.shape == q.shape
    one = fd_ops.decode_attention(q, k, v, kv_len)
    assert _within(got.float(), one.float(), dtype)
    assert _within(got.float(), fd_ref.decode_attention(q, k, v, kv_len)
                   .float(), dtype)
    assert not got[7].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_under_autograd(rng, cuda_device, dtype):
    """``flash_attention`` on tensors that need a gradient goes through its
    ``torch.autograd.Function``: the forward launches the kernel (one
    launch a call, within the forward tolerance of the plain version), the
    backward launches nothing and gives q, k and v the plain version's
    gradient exactly (it is the plain version's graph, recomputed). Causal,
    non-causal with Sk != Sq (the enc-dec's encoder and cross-attention),
    head dim 80, and only q needing a gradient."""
    cases = [(2, 8, 2, 130, 64, True, 130), (1, 32, 4, 256, 64, True, 256),
             (2, 16, 16, 4, 64, False, 1024), (1, 6, 2, 70, 32, False, 300),
             (2, 8, 8, 40, 80, True, 40)]
    for b, h, kh, s, d, causal, sk in cases:
        q = _normal(rng, (b, h, s, d), dtype, cuda_device)
        k, v = (_normal(rng, (b, kh, sk, d), dtype, cuda_device)
                for _ in range(2))
        cot = _normal(rng, (b, h, s, d), dtype, cuda_device)
        for need in ((True, True, True), (True, False, False)):
            ins = [t.clone().requires_grad_(n) for t, n in zip((q, k, v),
                                                               need)]
            before = fa_ops.LAUNCHES
            out = fa_ops.flash_attention(*ins, causal=causal)
            assert out.grad_fn is not None
            assert fa_ops.LAUNCHES == before + 1
            want = fa_ref.flash_attention(*ins, causal=causal)
            assert _within(out.detach(), want.detach(), dtype)
            wrt = [t for t in ins if t.requires_grad]
            got = torch.autograd.grad(out, wrt, cot)
            plain = torch.autograd.grad(want, wrt, cot)
            torch.cuda.synchronize()
            assert fa_ops.LAUNCHES == before + 1
            for g, p in zip(got, plain):
                assert g.dtype == dtype and g.shape == p.shape
                assert torch.equal(g, p), ((b, h, kh, s, d, causal, sk),
                                           float((g - p).abs().max()))
    # without a gradient to record, the plain launch: no graph
    with torch.no_grad():
        out = fa_ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


def test_train_step_on_the_card_reaches_every_leaf(cuda_device):
    """One accumulating train step of a small tinyllama-shaped model on the
    card (bf16 compute, remat on): every parameter leaf, the attention
    projections included, gets a nonzero gradient through the kernel, and
    the kernel launches twice an attention block and microbatch (forward
    and remat recompute)."""
    import dataclasses
    from repro_torch import configs, tree
    from repro_torch.launch.steps import (build_train_step,
                                         default_optimizer, value_and_grad)
    from repro_torch.models.model import ModelApi
    cfg = dataclasses.replace(configs.get_reduced("tinyllama-1.1b"),
                              compute_dtype=torch.bfloat16, remat=True)
    api = ModelApi(cfg)
    params = api.init(torch.Generator(cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 64))
                             .astype(np.int32), device=cuda_device)
             for k in ("tokens", "labels")}
    before = fa_ops.LAUNCHES
    _, grads = value_and_grad(api, params, batch)
    assert fa_ops.LAUNCHES - before == 2 * cfg.superlayer_repeat
    zero = [path for (path, _), g in zip(tree.leaves_with_path(params), grads)
            if not bool(g.ne(0).any())]
    assert not zero, zero
    opt = default_optimizer(cfg)
    state = opt.init(params)
    before = fa_ops.LAUNCHES
    _, _, metrics = build_train_step(api, opt, accum=2)(params, state, batch)
    assert fa_ops.LAUNCHES - before == 2 * 2 * cfg.superlayer_repeat
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_psum_tree_on_the_card_matches_cpu(rng, cuda_device, n):
    """int8 error-feedback compression over a ("pod",) axis of n positions
    of the card against the same reduction on the CPU: outputs (float32
    and bf16 leaves) and residuals bit for bit."""
    from repro_torch.distributed.compression import compressed_psum_tree
    from repro_torch.launch.mesh import make_mesh
    tree = {"w": rng.normal(size=(300, 7)) * 1e-3,
            "b": [rng.normal(size=(129,)) * 5.0, np.zeros(16)],
            "h": rng.normal(size=(4, 33))}
    host = {"w": torch.tensor(tree["w"], dtype=torch.float32),
            "b": [torch.tensor(x, dtype=torch.float32) for x in tree["b"]],
            "h": torch.tensor(tree["h"], dtype=torch.bfloat16)}
    res = {"w": torch.tensor(rng.normal(size=(300, 7)) * 1e-5,
                             dtype=torch.float32),
           "b": [torch.zeros(129), torch.zeros(16)], "h": torch.zeros(4, 33)}
    want_out, want_r = compressed_psum_tree(
        host, res, make_mesh((n,), ("pod",), "cpu"), "pod")
    on_card = lambda t: {"w": t["w"].to(cuda_device),  # noqa: E731
                         "b": [x.to(cuda_device) for x in t["b"]],
                         "h": t["h"].to(cuda_device)}
    got_out, got_r = compressed_psum_tree(
        on_card(host), on_card(res),
        make_mesh((n,), ("pod",), cuda_device), "pod")
    for key in ("w", "h"):
        assert got_out[key].is_cuda and got_out[key].dtype == host[key].dtype
        assert torch.equal(got_out[key].cpu(), want_out[key])
        assert torch.equal(got_r[key].cpu(), want_r[key])
    for i in range(2):
        assert torch.equal(got_out["b"][i].cpu(), want_out["b"][i])
        assert torch.equal(got_r["b"][i].cpu(), want_r["b"][i])


def test_two_stage_pipeline_with_flash_attention(cuda_device):
    """A small qwen2-shaped model's 4 layers in two pipeline stages on the
    card (bf16, head dim 64), 4 microbatches: bit-equal to the layers
    applied to each microbatch in turn, one flash_attention launch a layer
    and microbatch."""
    import dataclasses
    from repro_torch import configs, tree
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import blocks
    from repro_torch.models.layers import rope_frequencies
    from repro_torch.models.model import ModelApi
    cfg = dataclasses.replace(
        configs.get_reduced("qwen2-1.5b"), d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, superlayer_repeat=4, n_layers=4,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    gen = torch.Generator(cuda_device).manual_seed(0)
    layers = ModelApi(cfg).init(gen)["layers"]
    xs = torch.randn((4, 2, 128, cfg.d_model), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    cos, sin = rope_frequencies(64, 128, cfg.rope_theta, cuda_device)

    def apply(ps, x):
        for p in ps:
            x, _ = blocks.superlayer_train(p, None, x, cfg, cos, sin)
        return x

    def stage_fn(sp, x):
        return apply([tree.tree_map(lambda a, j=j: a[j], sp)
                      for j in range(2)], x)

    stacked = tree.tree_map(
        lambda *ls: torch.stack(ls).unflatten(0, (2, 2)), *layers)
    run = pipeline_forward(make_mesh((2,), ("pod",), cuda_device), "pod",
                           stage_fn, 4)
    with torch.no_grad():
        want = torch.stack([apply(layers, xs[i]) for i in range(4)])
        before = fa_ops.LAUNCHES
        got = run(stacked, xs)
    assert fa_ops.LAUNCHES - before == 4 * 4
    assert got.is_cuda and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ---- deliver: the broker's convert and send stages -----------------------

DELIVER_SENTINEL = -0x5A5A5A5B
DELIVER_PAD = 64        # guard elements on each side of a buffer


def _deliver_case(name, device, seed=0):
    from torch_delivery_cases import CASES, case
    return case(np.random.default_rng(seed), device=device,
                **dict(CASES)[name])


def _same_fields(got, want, path=""):
    """Every field of two values (tuples field by field), dtypes and shapes
    included, bit for bit."""
    if got is None or want is None:
        assert got is None and want is None, path
    elif isinstance(got, tuple):
        for f, g, w in zip(getattr(got, "_fields", range(len(got))), got,
                           want):
            _same_fields(g, w, f"{path}.{f}")
    else:
        assert (got.dtype == want.dtype and got.shape == want.shape
                and got.device == want.device and torch.equal(got, want)), path


def _same_delivery(got, want, path="", sentinel=None):
    """Two FusedDelivery values: each channel's first ``delivered`` wire
    lines and every other field bit for bit; the kernel leaves the lines
    past that count as the buffer held them, so where ``sentinel`` was
    planted there through ``out=`` every one of them still holds it."""
    pay, ref = got.pack.payload, want.pack.payload
    assert (pay.dtype == ref.dtype and pay.shape == ref.shape
            and pay.device == ref.device), path
    for c, d in enumerate(want.pack.delivered.tolist()):
        assert torch.equal(pay[c, :d], ref[c, :d]), (path, c)
        if sentinel is not None:
            assert bool((pay[c, d:] == sentinel).all()), (path, c)
    _same_fields(got._replace(pack=got.pack._replace(payload=None)),
                 want._replace(pack=want.pack._replace(payload=None)), path)


def _planted_payload(want):
    """``out=`` for the kernel: a wire buffer of the plain version's shape
    filled with DELIVER_SENTINEL."""
    t = want.pack.payload
    return {"payload": torch.full(t.shape, DELIVER_SENTINEL, dtype=t.dtype,
                                  device=t.device)}


def _deliver_names():
    from torch_delivery_cases import CASES
    return [name for name, _ in CASES]


@pytest.mark.parametrize("name", _deliver_names())
def test_deliver_kernel_matches_plain(cuda_device, name):
    """Each channel's delivered wire lines and every other field of
    ``FusedDelivery`` equal the plain version's bit for bit, and the lines
    past each count keep a sentinel planted through ``out=``: ring-less and
    ring-aware (stale epochs included), group tables and the identity
    fanout, caps below, at and above the produced totals with overflow into
    the ring and past it into the spill streams, every line live, C = 1, 2
    and 3, lines and notify on the 16-byte path and off it; one launch
    each."""
    from repro_torch.core import broker
    from repro_torch.kernels.deliver import ops as dl_ops
    for seed in (0, 1, 2):
        args = _deliver_case(name, cuda_device, seed)
        before = (dl_ops.LAUNCHES, dl_ops.VECTOR_LAUNCHES)
        got = broker.deliver_all(**args)
        want = broker.deliver_plain(**args)
        planted = dl_ops.deliver(**args, out=_planted_payload(want))
        torch.cuda.synchronize()
        _same_delivery(got, want, f"{name} seed {seed}")
        _same_delivery(planted, want, f"{name} seed {seed} planted",
                       DELIVER_SENTINEL)
        width = got.pack.payload.shape[-1]
        assert (dl_ops.LAUNCHES, dl_ops.VECTOR_LAUNCHES) == (
            before[0] + 2,
            before[1] + 2 * dl_ops.vector_ok([got.pack.payload], width))
        if name == "every-line-live":
            assert int(want.pack.delivered.min()) == \
                want.pack.payload.shape[1]


def test_deliver_kernel_at_the_param_group_shape(cuda_device):
    """paper-1m's param plan-group, (2, 131,072, 10,252): each channel's
    live lines, notify and every other field equal the plain version's bit
    for bit, on the 16-byte path; the 10.5 GB of lines past the delivered
    counts keep the sentinel planted there through ``out=``."""
    from repro_torch.core import broker
    from repro_torch.kernels.deliver import ops as dl_ops
    from torch_delivery_cases import PARAM_GROUP, case
    args = case(np.random.default_rng(7), device=cuda_device, **PARAM_GROUP)
    out = {"payload": torch.full((2, 131072, 10252), DELIVER_SENTINEL,
                                 dtype=torch.int32, device=cuda_device)}
    before = dl_ops.VECTOR_LAUNCHES
    got = dl_ops.deliver(**args, out=out)
    torch.cuda.synchronize()
    assert dl_ops.VECTOR_LAUNCHES == before + 1
    assert got.pack.payload.shape == (2, 131072, 10252)
    want = broker.deliver_plain(**args)
    for c in range(2):
        d = int(want.pack.delivered[c])
        assert 1000 < d < 131072
        assert torch.equal(got.pack.payload[c, :d], want.pack.payload[c, :d])
        assert bool((got.pack.payload[c, d:] == DELIVER_SENTINEL).all())
    del want
    torch.cuda.empty_cache()
    _same_delivery(got, broker.deliver_plain(**args), "param group",
                   DELIVER_SENTINEL)


def _guarded(dev, dtype, n, lead=0):
    """A 1-D view of ``n`` elements into a buffer whose DELIVER_PAD
    elements on each side (and ``lead`` more in front) hold a sentinel."""
    buf = torch.empty(n + 2 * DELIVER_PAD + lead, dtype=dtype, device=dev)
    if dtype == torch.bool:
        buf.view(torch.uint8).fill_(0x5A)
    else:
        buf.fill_(DELIVER_SENTINEL)
    return buf, buf[DELIVER_PAD + lead:DELIVER_PAD + lead + n]


def _guards_hold(buf, n, lead=0) -> bool:
    raw = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
    want = 0x5A if buf.dtype == torch.bool else DELIVER_SENTINEL
    head, tail = raw[:DELIVER_PAD + lead], raw[DELIVER_PAD + lead + n:]
    return bool((head == want).all()) and bool((tail == want).all())


@pytest.mark.parametrize("name", ["ringless-group", "ringless-identity",
                                  "caps-low", "ring-past-the-spill",
                                  "wide-vector", "big-groups-overflow",
                                  "many-tiles", "every-line-live"])
@pytest.mark.parametrize("lead", [0, 1])
def test_deliver_stores_stay_in_the_output(cuda_device, monkeypatch, name,
                                           lead):
    """Every buffer the kernel writes (payload, notify, spill mask, the
    spill streams, the successor ring, the counters and the scratch) is a
    view between sentinels: no store lands outside it, nor on a wire line
    past a channel's delivered count, and the values inside match the plain
    version. ``lead`` 1 puts payload and notify 4 B
    off the 16-byte boundary, onto the word path."""
    from repro_torch.core import broker
    from repro_torch.kernels.deliver import ops as dl_ops
    made = []

    def carve(dev, dtype, sizes):
        views = []
        for n in sizes:
            buf, view = _guarded(dev, dtype, n)
            made.append((buf, n, 0))
            views.append(view)
        return views

    monkeypatch.setattr(dl_ops, "_carve", carve)
    args = _deliver_case(name, cuda_device, 3)
    want = broker.deliver_plain(**args)
    out = {}
    for key, t in (("payload", want.pack.payload),
                   ("notify", want.fan.notify),
                   ("spill_mask", want.pack.spill_mask)):
        if key == "spill_mask" and args.get("ring") is not None:
            continue
        buf, view = _guarded(cuda_device, t.dtype, t.numel(), lead)
        made.append((buf, t.numel(), lead))
        out[key] = view.view(t.shape)
    got = dl_ops.deliver(**args, out=out)
    torch.cuda.synchronize()
    _same_delivery(got, want, name, DELIVER_SENTINEL)
    for buf, n, lead_ in made:
        assert _guards_hold(buf, n, lead_), (name, buf.dtype, n)


def test_deliver_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.deliver import ops as dl_ops
    args = _deliver_case("ringless-group", cuda_device)
    r = args["result"]
    args["result"] = r._replace(pair_rows=r.pair_rows.to(torch.int64))
    with pytest.raises(ValueError, match="rows"):
        dl_ops.deliver(**args)
    args = _deliver_case("ringless-group", cuda_device)
    args["group_sids"] = args["group_sids"][:, :, 0]
    with pytest.raises(ValueError, match="group table"):
        dl_ops.deliver(**args)
    with pytest.raises(ValueError, match="CUDA"):
        dl_ops.deliver(**_deliver_case("ringless-group", "cpu"))
    from torch_delivery_cases import CASES, case
    args = case(np.random.default_rng(0), device=cuda_device,
                **dict(dict(CASES)["ringless-group"],
                       brokers=dl_ops.MAX_BROKERS + 1))
    with pytest.raises(ValueError, match="brokers"):
        dl_ops.deliver(**args)


@pytest.mark.parametrize("name", ["ringless-group", "ring-group"])
def test_deliver_at_the_most_brokers_it_takes(cuda_device, name):
    """At ``MAX_BROKERS`` the per-broker tally fills 48 KB of shared memory
    beside the kernels' own: the launch opts in to it and equals the plain
    version."""
    from repro_torch.core import broker
    from repro_torch.kernels.deliver import ops as dl_ops
    from torch_delivery_cases import CASES, case
    args = case(np.random.default_rng(5), device=cuda_device,
                **dict(dict(CASES)[name], brokers=dl_ops.MAX_BROKERS))
    before = dl_ops.LAUNCHES
    got = broker.deliver_all(**args)
    torch.cuda.synchronize()
    assert dl_ops.LAUNCHES == before + 1
    assert got.pack.per_broker.shape == (args["result"].pair_valid.shape[0],
                                         dl_ops.MAX_BROKERS)
    _same_delivery(got, broker.deliver_plain(**args), name)


@pytest.mark.parametrize("backend", ["oracle", "compact_pallas"])
def test_every_delivery_of_an_engine_tick_takes_the_kernel(cuda_device,
                                                           monkeypatch,
                                                           backend):
    """An engine on the card, its buffers small enough that rings and
    spills fill: every ``deliver_all`` of its fused ticks (both
    plan-groups, ring-aware) and of a single-channel execution (ring-less)
    launched the kernel, and every report, delivery buffer and drain
    equals the same engine's on the CPU."""
    from repro_torch.core.plans import ChannelPlan, ExecutionFlags
    from repro_torch.kernels.deliver import ops as dl_ops
    from torch_delivery_cases import ingest, small_engine
    calls = [0]
    real = dl_ops.deliver

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(dl_ops, "deliver", counted)
    plans_ = {name: ChannelPlan("bad_index", True, True, backend)
              for name in ("TweetsAboutDrugs", "MostThreateningTweets",
                           "TweetsAboutCrime3")}
    engines = [small_engine(dev, 11, plans_) for dev in ("cpu", cuda_device)]
    for eng, _ in engines:
        eng.debug_delivery_buffers = True
    before = dl_ops.LAUNCHES
    for tick in range(4):
        reps = []
        for eng, rng in engines:
            ingest(eng, rng, 300, 1 + 500 * tick)
            reps.append(eng.execute_all(None, timed=False, deliver=True))
        a, b = reps
        assert list(a) == list(b)
        for name in a:
            x, y = a[name], b[name]
            assert (x.num_results, x.num_notified) == (y.num_results,
                                                       y.num_notified)
            assert x.overflow == y.overflow, (tick, name)
            for f in ("payload", "notify"):
                gx, gy = getattr(x, f), getattr(y, f)
                assert (gx is None) == (gy is None)
                assert gx is None or np.array_equal(gx, gy), (tick, name, f)
        if tick % 2:
            da, db = (eng.drain_spilled() for eng, _ in engines)
            assert list(da) == list(db)
            for name in da:
                assert da[name].stats == db[name].stats, (tick, name)
    assert sum(r.overflow.overflow for r in b.values()) > 0
    single = [eng.execute_channel("TweetsAboutDrugs", ExecutionFlags(),
                                  deliver=True) for eng, _ in engines]
    assert single[0].overflow == single[1].overflow
    torch.cuda.synchronize()
    assert calls[0] > 0 and dl_ops.LAUNCHES - before == calls[0]
