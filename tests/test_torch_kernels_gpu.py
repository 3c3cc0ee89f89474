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


def test_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros((4, 10), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        pf_ops.predicate_filter(x, _conds(np.random.default_rng(0), 2))
    t = torch.zeros((4, 3), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        sm_ops.spatial_match(t, t, 1.0)
