"""Port parity: records (ring-buffer append, gather) and the synthetic data
generators, against the reference package on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import records as JR  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

from torch_parity import assert_same  # noqa: E402


def _batches(rng, sizes, num_fields=10):
    for n in sizes:
        f = rng.integers(-1000, 1000, (n, num_fields)).astype(np.int32)
        loc = rng.normal(size=(n, 2)).astype(np.float32)
        yield f, loc


def test_append_across_ring_wraparound(rng):
    cap = 64
    jds = JR.ActiveDataset.create(cap)
    tds = TR.ActiveDataset.create(cap, device="cpu")
    for f, loc in _batches(rng, [30, 30, 1, 50, 64, 7]):
        jds, jrows = JR.append(jds, JR.RecordBatch.from_numpy(f, loc))
        trows = TR.append(tds, TR.RecordBatch.from_numpy(f, loc, device="cpu"))
        assert_same(jrows, trows, "row_ids")
        assert_same(jds.fields, tds.fields, "fields")
        assert_same(jds.location, tds.location, "location")
        assert_same(jds.size, tds.size, "size")
    assert int(tds.size) > 2 * cap          # wrapped more than once


def test_gather_rows_matches_reference(rng):
    cap = 32
    jds = JR.ActiveDataset.create(cap)
    tds = TR.ActiveDataset.create(cap, device="cpu")
    for f, loc in _batches(rng, [20, 25]):
        jds, _ = JR.append(jds, JR.RecordBatch.from_numpy(f, loc))
        TR.append(tds, TR.RecordBatch.from_numpy(f, loc, device="cpu"))
    live = rng.integers(45 - cap, 45, 40).astype(np.int32)
    jb = JR.gather_rows(jds, jnp.asarray(live))
    tb = TR.gather_rows(tds, torch.as_tensor(live))
    assert_same(jb.fields, tb.fields, "fields")
    assert_same(jb.location, tb.location, "location")


def test_record_batch_defaults_and_host_copy():
    f = np.arange(20, dtype=np.int64).reshape(2, 10)
    jb = JR.RecordBatch.from_numpy(f)
    tb = TR.RecordBatch.from_numpy(f, device="cpu")
    assert_same(jb.fields, tb.fields, "fields")
    assert_same(jb.location, tb.location, "location")
    assert tb.host_fields.dtype == np.int32
    f[0, 0] = 99                           # the batch owns its copy
    assert int(tb.fields[0, 0]) == 0


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.RecordBatch.from_numpy(np.zeros((1, 10), np.int32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.ActiveDataset.create(8)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_generators_match_reference(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    jb = jsyn.tweet_batch(a, 500, t0=3)
    f, loc = tsyn.tweet_arrays(b, 500, t0=3)
    assert_same(jb.fields, f, "fields")
    assert_same(jb.location, loc, "location")
    assert_same(jsyn.drug_tweak(np.asarray(jb.fields).copy(), a, 0.2),
                tsyn.drug_tweak(f.copy(), b, 0.2), "drug_tweak")
    for x, y in zip(jsyn.subscriptions_by_population(a, 1000, 3),
                    tsyn.subscriptions_by_population(b, 1000, 3)):
        assert_same(x, y, "subscriptions")
    tb = tsyn.tweet_batch(np.random.default_rng(seed), 500, t0=3,
                          device="cpu")
    assert_same(jb.fields, tb.fields, "tweet_batch")
