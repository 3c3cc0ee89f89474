"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Card-only (marker ``gpu``): every test skips without a CUDA device. This file
imports neither JAX nor the reference package, so it also runs where only
the port is installed:

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
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


def _conds(rng, nchan):
    chans = []
    for _ in range(nchan):
        seen, preds = {}, []
        for _ in range(int(rng.integers(1, 4))):
            f, op, v = (int(rng.integers(0, 10)), OPS[int(rng.integers(0, 6))],
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


def test_join_compact_kernel_matches_plain(rng, cuda_device):
    before = jc_ops.LAUNCHES
    for s, max_t in ((1, 1), (37, 5), (1000, 33), (4099, 64)):
        args = (rng.integers(-1, 20, (s, max_t)).astype(np.int32),
                rng.integers(0, max_t + 1, s).astype(np.int32),
                rng.integers(0, 9, (s, max_t)).astype(np.int32),
                rng.integers(0, 3, (s, max_t)).astype(np.int32),
                rng.random(s) < 0.7,
                (2 ** 31 - 1 - rng.integers(0, 40, s)).astype(np.int32))
        dev = [torch.as_tensor(a, device=cuda_device) for a in args]
        for aggregated in (False, True):
            got = jc_ops.join_pairs(*dev, 3, aggregated)
            want = jc_ref.join_pairs(*dev, 3, aggregated)
            assert got[0].dtype == torch.bool
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
    torch.cuda.synchronize()
    assert jc_ops.LAUNCHES == before + 8
    jc_ops.SHAPE = None
    jc_ops.join_pairs(*dev, 3, True)
    jc_ops.join_pairs(*(a[:1000].contiguous() for a in dev), 3, True)
    assert jc_ops.SHAPE == (4099, 64)      # the largest launch is kept


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


def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 2, 8, 48), device=cuda_device)       # D = 48
    with pytest.raises(ValueError, match="D in"):
        fa_ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 32), dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        fa_ops.flash_attention(q, q, q)
    flat = torch.zeros(1 + 2 * 8 * 32, dtype=torch.bfloat16,
                       device=cuda_device)
    q = flat[1:].view(1, 2, 8, 32)                           # 2-byte offset
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    q = torch.zeros((1, 2, 32), device=cuda_device)
    k = torch.zeros((1, 1, 8, 32), device=cuda_device)
    with pytest.raises(ValueError, match="kv_len"):
        fd_ops.decode_attention(q, k, k, torch.zeros((1,), dtype=torch.int64,
                                                     device=cuda_device))
