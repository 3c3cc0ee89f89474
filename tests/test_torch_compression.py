"""Port parity for int8 error-feedback gradient compression
(``repro_torch/distributed/compression.py``) against the reference's
``distributed/compression.py``.

The reference has two arithmetic forms, and the port follows each bit for
bit: ``quantize_int8`` / ``ef_compress`` run eagerly divide by 127, while
the XLA program compiled for ``compressed_psum_tree``'s ``shard_map`` body
multiplies by float32(1/127) (another scale in about 4% of tensors) and
fuses the residual's ``target - q * scale`` into one FMA. The rule held
here: every int8 ``q``, scale, output and residual equal to the
reference's, bit for bit, with 0 elements off in every case. The
reference called outside ``jit`` runs the eager form in its ``shard_map``
too; against that call the port is held to a bound (one int8 step at a
rounding boundary, one ulp of the scale), and the elements off are
counted. Mesh axes of 2 and 4 positions use conftest's 4 host devices on
the reference's side and the CPU, four times, on the port's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as J  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro_torch.distributed import compression as T  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def bits(x) -> np.ndarray:
    a = np.asarray(x.detach().cpu().float().numpy()
                   if hasattr(x, "detach") else np.asarray(x, np.float32))
    return a.view(np.int32)


def off(ref, port) -> int:
    """Elements whose bits differ."""
    return int((bits(ref) != bits(port)).sum())


SIZES = (1, 257, 509)     # few shapes: the reference compiles one a shape


def vectors(seed: int, count: int):
    """Seeded float32 vectors over twelve decades, with an all-zero one and
    one of values at exact multiples of a scale (every element at a
    rounding boundary of x / scale)."""
    rng = np.random.default_rng(seed)
    out = [np.zeros(257, np.float32),
           (np.arange(-254, 255, dtype=np.float32) * 0.5)]
    for i in range(count):
        out.append((rng.normal(size=SIZES[i % 3]) * 10.0 ** rng.uniform(-6, 6))
                   .astype(np.float32))
    return out


def test_quantize_and_ef_compress_eager_bit_for_bit():
    residual_rng = np.random.default_rng(7)
    total = 0
    for x in vectors(0, 600):
        r = (residual_rng.normal(size=x.shape) * 1e-3).astype(np.float32)
        jq, js = J.quantize_int8(jnp.asarray(x))
        tq, ts = T.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
        assert off(js, ts) == 0
        assert off(J.dequantize_int8(jq, js), T.dequantize_int8(tq, ts)) == 0
        jq, js, jr = J.ef_compress(jnp.asarray(x), jnp.asarray(r))
        tq, ts, tr = T.ef_compress(torch.from_numpy(x), torch.from_numpy(r))
        np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
        assert off(js, ts) == 0 and off(jr, tr) == 0
        total += x.size
    assert total > 100_000


@pytest.mark.multidevice
@pytest.mark.parametrize("dtype", (np.float32, "bfloat16"))
@pytest.mark.parametrize("n", (1, 2, 4))
def test_compressed_psum_tree_bit_for_bit(multidevice, n, dtype):
    jm = jmake_mesh((n,), ("pod",))
    tm = make_mesh((n,), ("pod",), "cpu")
    fn = jax.jit(lambda t, r: J.compressed_psum_tree(t, r, jm, "pod"))
    rng = np.random.default_rng(n)
    xs = vectors(n, 60)
    tree = {f"g{i}": x for i, x in enumerate(xs)}
    res = {k: (rng.normal(size=x.shape) * 1e-3).astype(np.float32)
           for k, x in tree.items()}
    jt = {k: jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else x.dtype)
          for k, x in tree.items()}
    tt = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        for k, v in jt.items()}
    jout, jres = fn(jt, {k: jnp.asarray(v) for k, v in res.items()})
    tout, tres = T.compressed_psum_tree(
        tt, {k: torch.from_numpy(v) for k, v in res.items()}, tm, "pod")
    assert list(tout) == list(tree)
    elements = offs = 0
    for k in tree:
        assert tout[k].dtype == tt[k].dtype and tres[k].dtype == torch.float32
        offs += off(jout[k], tout[k]) + off(jres[k], tres[k])
        elements += 2 * tree[k].size
    assert offs == 0, f"{offs} of {elements} elements off"
    # the compiled scale differs from the eager one on some tensors: the
    # two forms are really both exercised
    differ = sum(off(J.quantize_int8(jnp.asarray(x))[1],
                     T._ef_compress_compiled(torch.from_numpy(x),
                                             torch.zeros(x.shape))[1])
                 for x in xs)
    assert differ > 0


@pytest.mark.multidevice
@pytest.mark.parametrize("n", (1, 4))
def test_compressed_psum_tree_called_eagerly_within_the_bound(multidevice, n):
    """tests/test_substrate.py::test_compressed_psum_tree_single_axis on
    both packages, and at 4 positions. Called outside ``jit``, the
    reference's ``shard_map`` runs its body in the eager form
    (``ef_compress``'s: a division by 127, no FMA), which the port's
    ``compressed_psum_tree`` does not follow (it follows the compiled
    form, bit for bit above). Against the eager call the port is held to
    this bound: its scale within one ulp of the reference's, so each
    output within one ulp of the scale times |q| and the product's
    rounding, or one int8 step away where ``x / scale`` sits at a rounding
    boundary. The elements off are counted."""
    rng = np.random.default_rng(0)
    jm, tm = jmake_mesh((n,), ("pod",)), make_mesh((n,), ("pod",), "cpu")
    counts = {"equal": 0, "ulps": 0, "one_step": 0}
    for _ in range(8):
        g = rng.normal(size=(64,)).astype(np.float32)
        jout, _ = J.compressed_psum_tree(
            {"g": jnp.asarray(g)}, J.init_residuals({"g": jnp.asarray(g)}),
            jm, "pod")
        tg = {"g": torch.from_numpy(g)}
        tout, tres = T.compressed_psum_tree(tg, T.init_residuals(tg), tm,
                                            "pod")
        np.testing.assert_allclose(tout["g"].numpy(), g,
                                   atol=np.abs(g).max() / 100)
        assert tres["g"].dtype == torch.float32
        want = np.asarray(jout["g"], np.float64)
        got = tout["g"].numpy().astype(np.float64)
        step = np.abs(g).max() / 127.0
        diff = np.abs(got - want)
        # |q| ulps of the scale and the two products' roundings: 2^-22
        ulps = diff <= 2.0 ** -22 * np.abs(want)
        one_step = np.abs(diff - step) <= 2.0 ** -21 * (np.abs(want) + step)
        assert (ulps | one_step).all()
        counts["equal"] += int((diff == 0).sum())
        counts["ulps"] += int(((diff > 0) & ulps).sum())
        counts["one_step"] += int((one_step & ~ulps).sum())
    # the scale's rounding moves most outputs by an ulp; a step is rare
    assert counts["ulps"] > 0 and counts["one_step"] <= 8, counts


def test_ef_compression_unbiased_accumulation_on_both(rng):
    """tests/test_substrate.py::test_ef_compression_unbiased_accumulation
    on both packages, step by step equal."""
    x = rng.normal(size=(256,)).astype(np.float32)
    jr, tr = jnp.zeros(256, jnp.float32), torch.zeros(256)
    jsent, tsent = jnp.zeros(256, jnp.float32), torch.zeros(256)
    for _ in range(50):
        jq, js, jr = J.ef_compress(jnp.asarray(x), jr)
        tq, ts, tr = T.ef_compress(torch.from_numpy(x), tr)
        jsent = jsent + J.dequantize_int8(jq, js)
        tsent = tsent + T.dequantize_int8(tq, ts)
        assert off(jr, tr) == 0 and off(jsent, tsent) == 0
    np.testing.assert_allclose((tsent / 50).numpy(), x, atol=2e-3)


def test_init_residuals_and_the_identity():
    """init_residuals gives float32 zeros; each new residual is exactly
    target - dequantize(q, scale)."""
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16),
            "b": [torch.arange(5, dtype=torch.float32)]}
    res = T.init_residuals(tree)
    assert res["a"].dtype == torch.float32 and res["a"].shape == (3, 4)
    assert float(res["b"][0].abs().sum()) == 0
    g = torch.Generator().manual_seed(0)
    x, r = torch.randn(1000, generator=g), torch.randn(1000, generator=g)
    q, s, new_r = T.ef_compress(x, r)
    assert torch.equal(new_r, (x + r) - T.dequantize_int8(q, s))
