"""Port parity: spatial_match. The port's plain version computes the TPU
kernel's expansion form in a fixed float32 order; the reference's kernel
(interpret mode on the CPU) computes the cross term with a dot that may
contract to FMA. So the two hit maps must agree exactly everywhere except on
pairs within rounding of the radius: |dist^2 - r^2| <= 8 * 2^-23 *
(|t|^2 + |u|^2 + r^2), evaluated in float64."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.spatial_match import ops as jsm  # noqa: E402
from repro.kernels.spatial_match import ref as jsm_ref  # noqa: E402
from repro_torch.kernels.spatial_match import ops as tsm  # noqa: E402
from repro_torch.kernels.spatial_match import ref as tsm_ref  # noqa: E402

from torch_parity import assert_same, to_np  # noqa: E402


def _band(t, u, radius):
    """Pairs whose float64 squared distance lies within rounding of r^2."""
    t64, u64 = t.astype(np.float64), u.astype(np.float64)
    d2 = ((t64[:, None, :] - u64[None, :, :]) ** 2).sum(-1)
    r2 = float(np.float32(radius)) ** 2
    scale = (t64 ** 2).sum(-1)[:, None] + (u64 ** 2).sum(-1)[None, :] + r2
    return np.abs(d2 - r2) <= 8 * 2.0 ** -23 * scale


@pytest.mark.parametrize("r,u", [(1, 1), (10, 33), (300, 700)])
@pytest.mark.parametrize("radius", [10.0, 0.7])
def test_expansion_form_matches_reference_off_the_band(rng, r, u, radius):
    t = (rng.normal(size=(r, 2)) * 25).astype(np.float32)
    us = (rng.normal(size=(u, 2)) * 25).astype(np.float32)
    want = to_np(jsm.spatial_match(jnp.asarray(t), jnp.asarray(us), radius))
    got = tsm.spatial_match(torch.as_tensor(t), torch.as_tensor(us), radius)
    assert got.dtype == torch.bool and tuple(got.shape) == (r, u)
    diff = want != to_np(got)
    assert not (diff & ~_band(t, us, radius)).any(), \
        "hit maps differ off the radius band"


def test_exact_on_half_grid(rng):
    """On a 0.5 grid with |x| <= 100 every step of both forms is exact in
    float32, so kernel form, euclidean oracle and reference all agree."""
    t = (np.round(rng.uniform(-100, 100, (200, 2)) * 2) / 2).astype(np.float32)
    us = (np.round(rng.uniform(-100, 100, (150, 2)) * 2) / 2).astype(np.float32)
    tt, tu = torch.as_tensor(t), torch.as_tensor(us)
    want = jsm.spatial_match(jnp.asarray(t), jnp.asarray(us), 10.0)
    assert_same(want, tsm.spatial_match(tt, tu, 10.0), "kernel form")
    assert_same(jsm_ref.spatial_match(jnp.asarray(t), jnp.asarray(us), 10.0),
                tsm_ref.spatial_match(tt, tu, 10.0), "euclidean oracle")
    assert_same(want, tsm_ref.spatial_match(tt, tu, 10.0), "forms agree")


def test_far_padding_never_matches():
    t = torch.tensor([[tsm.FAR, tsm.FAR], [0.0, 0.0], [-tsm.FAR, 3.0]])
    u = torch.tensor([[-tsm.FAR, -tsm.FAR], [0.5, 0.5], [tsm.FAR, tsm.FAR]])
    hit = tsm.spatial_match(t, u, 10.0)
    assert hit.tolist() == [[False, False, False], [False, True, False],
                            [False, False, False]]
