"""Port parity: the subscription control plane (Algorithm 1 aggregator,
stable slots, flat slots, deltas, aggregate / flatten_groups /
param_to_targets) and UserParameters, driven in lockstep with the reference
through an interleaved add/remove fuzz."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import subscriptions as JS  # noqa: E402
from repro.core import user_params as JU  # noqa: E402
from repro_torch.core import subscriptions as TS  # noqa: E402
from repro_torch.core import user_params as TU  # noqa: E402

from torch_parity import assert_same  # noqa: E402


def _assert_aggregators(ja, ta, tag):
    jg, tg = ja.build(), ta.build()
    for k in ("group_params", "group_brokers", "group_sids", "group_counts"):
        assert_same(getattr(jg, k), getattr(tg, k), f"{tag} build.{k}")
    for x, y in zip(ja.slot_arrays(), ta.slot_arrays()):
        assert_same(x, y, f"{tag} slot_arrays")
    for x, y in zip(ja.flat_slot_arrays(), ta.flat_slot_arrays()):
        assert_same(x, y, f"{tag} flat_slot_arrays")
    jf, tf = JS.flatten_groups(jg), TS.flatten_groups(tg)
    for k in ("sids", "params", "brokers"):
        assert_same(getattr(jf, k), getattr(tf, k), f"{tag} flatten.{k}")
    for x, y in zip(JS.param_to_targets(jg.group_params, 20),
                    TS.param_to_targets(tg.group_params, 20)):
        assert_same(x, y, f"{tag} param_to_targets")
    jd, td = ja.take_delta(), ta.take_delta()
    assert (jd.slots, jd.params, jd.flat_slots, jd.flat_cells, jd.full) == \
        (td.slots, td.params, td.flat_slots, td.flat_cells, td.full), tag
    assert ja.num_subscriptions == ta.num_subscriptions


@pytest.mark.parametrize("cap,seed", [(4, 0), (16, 1), (1, 2)])
def test_aggregator_interleaved_fuzz(cap, seed):
    rng = np.random.default_rng(seed)
    ja, ta = JS.Aggregator(cap), TS.Aggregator(cap)
    live = []
    for step in range(40):
        kind = rng.integers(0, 5)
        if kind == 0 or not live:
            n = int(rng.integers(1, 30))
            p = rng.integers(0, 20, n).astype(np.int32)
            b = rng.integers(0, 3, n).astype(np.int32)
            s1, s2 = ja.add_bulk(p, b), ta.add_bulk(p, b)
            assert_same(s1, s2, "add_bulk sids")
            live += list(zip(s1.tolist(), p.tolist(), b.tolist()))
        elif kind == 1:
            p, b = int(rng.integers(0, 20)), int(rng.integers(0, 3))
            sid = ja.add_subscription(p, b)
            assert ta.add_subscription(p, b) == sid
            live.append((sid, p, b))
        elif kind == 2:
            sid, p, b = live.pop(int(rng.integers(0, len(live))))
            assert ja.remove_subscription(p, b, sid) is True
            assert ta.remove_subscription(p, b, sid) is True
        elif kind == 3:
            k = int(rng.integers(1, len(live) + 1))
            idx = rng.choice(len(live), k, replace=False)
            sids = np.array([live[i][0] for i in idx] + [10**6], np.int32)
            assert_same(ja.remove_bulk(sids), ta.remove_bulk(sids), "removed")
            gone = set(idx.tolist())
            live = [x for i, x in enumerate(live) if i not in gone]
        else:
            n = int(rng.integers(1, 10))
            p = rng.integers(0, 20, n).astype(np.int32)
            b = rng.integers(0, 3, n).astype(np.int32)
            s1, s2 = ja.rebuild_bulk(p, b), ta.rebuild_bulk(p, b)
            assert_same(s1, s2, "rebuild_bulk sids")
            live += list(zip(s1.tolist(), p.tolist(), b.tolist()))
        _assert_aggregators(ja, ta, f"step {step}")


def test_aggregate_and_frame_rule(rng):
    p = rng.integers(0, 50, 2000).astype(np.int32)
    b = rng.integers(0, 4, 2000).astype(np.int32)
    jg = JS.aggregate(JS.SubscriptionTable.build(p, b), 128)
    tg = TS.aggregate(TS.SubscriptionTable.build(p, b), 128)
    for k in ("group_params", "group_brokers", "group_sids", "group_counts"):
        assert_same(getattr(jg, k), getattr(tg, k), k)
    for fb in (4, 100, 40 * 1024, 123457):
        assert JS.cap_from_frame_bytes(fb) == TS.cap_from_frame_bytes(fb)


def test_user_parameters_and_semi_join(rng):
    params = rng.integers(0, 12, 40)
    ju, tu = JU.UserParameters.create(12), TU.UserParameters.create(12)
    ju.add_bulk(params)
    tu.add_bulk(params)
    ju.remove_bulk(params[:30])
    tu.remove_bulk(params[:30])
    ju.add(3)
    tu.add(3)
    assert_same(ju.refcount, tu.refcount, "refcount")
    tmask = tu.mask("cpu")
    assert_same(ju.mask(), tmask, "mask")
    vals = rng.integers(-3, 16, 100).astype(np.int32)
    assert_same(JU.semi_join(jnp.asarray(vals), ju.mask()),
                TU.semi_join(torch.as_tensor(vals), tmask), "semi_join")
    with pytest.raises(ValueError):
        tu.remove_bulk(np.array([5] * 99))
