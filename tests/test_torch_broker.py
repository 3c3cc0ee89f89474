"""Port parity: ring-less fused broker delivery (``deliver_all`` and its
convert / send stages) under tight caps — wire buffers, spill streams and
per-broker accounting equal to the reference's, dtypes included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import broker as JBr  # noqa: E402
from repro_torch.core import broker as TBr  # noqa: E402
from repro_torch.core import plans as TPl  # noqa: E402

from conftest import random_stacked_broker_result  # noqa: E402
from torch_parity import assert_same, assert_same_tuple, to_np  # noqa: E402


def _to_port(res):
    return TPl.ChannelResult(*(torch.tensor(to_np(x)) for x in res))


def _assert_delivery(jd, td, tag):
    assert_same_tuple(jd.pack, td.pack, f"{tag}.pack")
    assert_same_tuple(jd.fan, td.fan, f"{tag}.fan")
    assert_same_tuple(jd.pair_spill, td.pair_spill, f"{tag}.pair_spill")
    assert_same_tuple(jd.sid_spill, td.sid_spill, f"{tag}.sid_spill")


@pytest.mark.parametrize("seed", range(3))
def test_deliver_all_tight_caps(seed):
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 4))
    n_groups, cap = 6, 5
    res, sids, _, _ = random_stacked_broker_result(rng, C, 9, 4, n_groups, cap)
    tb = rng.integers(0, 3, (C, n_groups)).astype(np.int32)
    counts = (sids >= 0).sum(-1).astype(np.int32)
    caps_p = rng.integers(0, 12, C).astype(np.int32)
    caps_n = rng.integers(0, 30, C).astype(np.int32)
    tres = _to_port(res)
    for max_pairs, max_notify, spill in ((4, 8, 3), (16, 40, 64)):
        for use_counts, use_caps in ((False, False), (True, True)):
            kw = dict(target_brokers=tb, num_brokers=3)
            if use_counts:
                kw["counts"] = counts
            if use_caps:
                kw.update(caps_pairs=caps_p, caps_notify=caps_n)
            jd = JBr.deliver_all(res, jnp.asarray(sids), 2, max_pairs,
                                 max_notify, spill,
                                 **{k: jnp.asarray(v) if isinstance(
                                     v, np.ndarray) else v
                                    for k, v in kw.items()})
            td = TBr.deliver_all(tres, torch.as_tensor(sids), 2, max_pairs,
                                 max_notify, spill,
                                 **{k: torch.as_tensor(v) if isinstance(
                                     v, np.ndarray) else v
                                    for k, v in kw.items()})
            _assert_delivery(jd, td, f"mp={max_pairs} counts={use_counts}")


def test_identity_fanout(rng):
    """Spatial channels deliver through a 0-wide sID table (targets are the
    end users)."""
    res, _, _, _ = random_stacked_broker_result(rng, 2, 7, 5, 4, 3)
    tres = _to_port(res)
    tb = rng.integers(0, 2, (2, 4)).astype(np.int32)
    jd = JBr.deliver_all(res, jnp.zeros((2, 0), jnp.int32), 3, 6, 9, 4,
                         target_brokers=jnp.asarray(tb), num_brokers=2)
    td = TBr.deliver_all(tres, torch.zeros((2, 0), dtype=torch.int32), 3, 6,
                         9, 4, target_brokers=torch.as_tensor(tb),
                         num_brokers=2)
    _assert_delivery(jd, td, "identity")


def test_pack_and_fanout_stages_alone(rng):
    res, sids, _, _ = random_stacked_broker_result(rng, 3, 6, 3, 5, 4)
    tres = _to_port(res)
    tb = rng.integers(0, 2, (3, 5)).astype(np.int32)
    jp = JBr.pack_payloads_all(res, jnp.asarray(sids), 4, 7,
                               target_brokers=jnp.asarray(tb), num_brokers=2)
    tp = TBr.pack_payloads_all(tres, torch.as_tensor(sids), 4, 7,
                               target_brokers=torch.as_tensor(tb),
                               num_brokers=2)
    assert_same_tuple(jp, tp, "pack")
    assert_same_tuple(JBr.fanout_sids_all(res, jnp.asarray(sids), 11),
                      TBr.fanout_sids_all(tres, torch.as_tensor(sids), 11),
                      "fanout")


def test_resolve_pair_sids_and_traffic_summary(rng):
    table = rng.integers(-1, 50, (6, 4)).astype(np.int32)
    tg = rng.integers(-2, 8, 10).astype(np.int32)
    for t in (table, np.zeros((6, 0), np.int32), np.zeros((0, 4), np.int32)):
        assert_same(JBr.resolve_pair_sids(t, tg), TBr.resolve_pair_sids(t, tg),
                    "resolve")
    res, _, _, _ = random_stacked_broker_result(rng, 1, 4, 2, 3, 2)
    one = type(res)(*(x[0] for x in res))
    stats = dict(delivered_pairs=3, spilled_pairs=1, dropped_pairs=0,
                 delivered_sids=5, spilled_sids=0, dropped_sids=2,
                 delivered_pairs_broker=(2, 1))
    a = JBr.broker_traffic_summary(one, JBr.DeliveryStats(**stats))
    b = TBr.broker_traffic_summary(_to_port(res)._replace(
        **{f: torch.as_tensor(to_np(getattr(one, f))) for f in one._fields}),
        TBr.DeliveryStats(**stats))
    assert a.keys() == b.keys()
    for k in a:
        assert_same(a[k], b[k], k)
    s = TBr.DeliveryStats(**stats)
    assert (s.produced_pairs, s.produced_sids, s.overflow) == (4, 7, 3)
    assert s.merged(s).delivered_pairs_broker == (2, 1)
