"""Port parity for the sharded engine's entity partitioning
(``repro_torch/distributed/partition.py``) against the reference's
``repro/distributed/partition.py``: the three hash functions bit for bit,
dtypes included, on random ids up to 2^31 - 1 and 1-7 shards, the error
on negative ids, and the decode rules' context."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.distributed import partition as jpart  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402

from torch_parity import assert_same  # noqa: E402

FNS = ("shard_for_sids", "shard_for_users", "broker_owner")


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("num_shards", range(1, 8))
def test_hash_matches_reference(fn, num_shards):
    rng = np.random.default_rng(num_shards)
    ids = np.concatenate([
        rng.integers(0, 2**31 - 1, 4096, dtype=np.int64),
        np.arange(64), [2**31 - 1, 2**31 - 2, 0]]).astype(np.int32)
    for arr in (ids, ids.astype(np.int64), ids[:0], ids.reshape(23, -1)):
        got = getattr(tpart, fn)(arr, num_shards)
        assert_same(getattr(jpart, fn)(arr, num_shards), got,
                    f"{fn} S={num_shards}")
        assert got.dtype == np.int32
        if got.size:
            assert 0 <= got.min() and got.max() < num_shards


def test_consecutive_ids_spread_over_shards():
    """The multiplicative hash decorrelates from sequential allocation:
    every run of 4 consecutive sIDs lands on more than one of 4 shards."""
    owners = tpart.shard_for_sids(np.arange(4000), 4).reshape(-1, 4)
    assert (np.ptp(owners, axis=1) > 0).all()
    assert (tpart.shard_for_sids(np.arange(4000), 4)
            != tpart.shard_for_users(np.arange(4000), 4)).any()


@pytest.mark.parametrize("fn", ("shard_for_sids", "shard_for_users"))
def test_negative_ids_raise_like_reference(fn):
    bad = np.asarray([3, -1, 7], np.int32)
    with pytest.raises(ValueError, match="non-negative"):
        getattr(jpart, fn)(bad, 4)
    with pytest.raises(ValueError, match="non-negative"):
        getattr(tpart, fn)(bad, 4)


def test_rules_context_nests_and_restores():
    import torch
    assert tpart.active_rules() is None
    outer = tpart.Rules([torch.device("cpu")] * 4)
    assert outer.model_axis == "model" and outer.model_size == 4
    assert outer.batch_axes is None
    assert tpart.Rules().model_axis is None
    with tpart.use_rules(outer):
        assert tpart.active_rules() is outer
        with tpart.use_rules(None):
            assert tpart.active_rules() is None
        assert tpart.active_rules() is outer
    assert tpart.active_rules() is None
