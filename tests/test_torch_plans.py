"""Port parity: the padded single-channel plans — candidate discovery under
the four scan modes, the param join for every layout x pushdown, and the
spatial join on both kernel backends — over a ring buffer that wrapped."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bad_index as JB  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.core import plans as JPl  # noqa: E402
from repro.core import predicates as JP  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core import subscriptions as subs  # noqa: E402
from repro.data.synthetic import drug_tweak, tweet_batch  # noqa: E402
from repro.kernels.spatial_match import ops as jsm  # noqa: E402
from repro_torch.core import bad_index as TB  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import plans as TPl  # noqa: E402
from repro_torch.core import predicates as TP  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.kernels.spatial_match import ops as tsm  # noqa: E402

from torch_parity import assert_same, assert_same_tuple  # noqa: E402

CAP, BATCH, LAST_TS, LAST_SIZE = 256, 120, 100, 120


@pytest.fixture(scope="module")
def world():
    """Both packages' dataset + BAD index after three batches (the ring
    wraps), the drugs channel's conditions, and both target layouts."""
    rng = np.random.default_rng(3)
    jspec, tspec = jch.tweets_about_drugs(), tch.tweets_about_drugs()
    jc = JP.compile_conditions([list(jspec.fixed_preds)])
    tc = TP.compile_conditions([list(tspec.fixed_preds)])
    jds = JR.ActiveDataset.create(CAP)
    tds = TR.ActiveDataset.create(CAP, device="cpu")
    jix = JB.BADIndexState.create(1, 128)
    tix = TB.BADIndexState.create(1, 128, device="cpu")
    for t0 in (1, 100, 200):
        b = tweet_batch(rng, BATCH, t0=t0, rate_per_s=40)
        f = drug_tweak(np.asarray(b.fields).copy(), rng, 0.3)
        loc = (np.round(np.asarray(b.location) * 2) / 2).astype(np.float32)
        jds, jrows = JR.append(jds, JR.RecordBatch.from_numpy(f, loc))
        jix = JB.insert(jix, jrows, JP.evaluate_conditions(jnp.asarray(f), jc))
        trows = TR.append(tds, TR.RecordBatch.from_numpy(f, loc, device="cpu"))
        TB.insert(tix, trows, TP.evaluate_conditions(torch.as_tensor(f), tc))
    agg = subs.Aggregator(4)
    agg.add_bulk(rng.integers(0, 50, 300), rng.integers(0, 3, 300))
    groups = agg.build()
    flat = subs.flatten_groups(groups)
    targets = {}
    for aggregated, (p, b, c) in (
            (True, (groups.group_params, groups.group_brokers,
                    groups.group_counts)),
            (False, (flat.params, flat.brokers, np.ones_like(flat.params)))):
        bp, bc = subs.param_to_targets(p, 50)
        arrs = [np.asarray(a, np.int32) for a in (p, b, c, bp, bc)]
        targets[aggregated] = (
            JPl.TargetArrays(*map(jnp.asarray, arrs)),
            TPl.TargetArrays(*map(torch.as_tensor, arrs)))
    up = np.zeros(50, bool)
    up[rng.integers(0, 50, 20)] = True
    users = (np.round(rng.normal(size=(30, 2)) * 60) / 2).astype(np.float32)
    return dict(jds=jds, tds=tds, jix=jix, tix=tix, jc=jc, tc=tc,
                targets=targets, up=up, users=users,
                brokers=rng.integers(0, 3, 30).astype(np.int32))


def _candidates(w, scan):
    if scan == "full":
        return (JPl.candidates_full_scan(w["jds"], w["jc"], jnp.int32(LAST_TS),
                                         128),
                TPl.candidates_full_scan(w["tds"], w["tc"], LAST_TS, 128))
    if scan == "window":
        return (JPl.candidates_window(w["jds"], w["jc"], jnp.int32(LAST_SIZE),
                                      256),
                TPl.candidates_window(w["tds"], w["tc"], LAST_SIZE, 256))
    if scan == "trad_index":
        return (JPl.candidates_trad_index(w["jds"], w["jc"], 0,
                                          jnp.int32(LAST_SIZE), 256, 64),
                TPl.candidates_trad_index(w["tds"], w["tc"], 0, LAST_SIZE,
                                          256, 64))
    return (JPl.candidates_bad_index(w["jds"], w["jix"], 0, 128),
            TPl.candidates_bad_index(w["tds"], w["tix"], 0, 128))


@pytest.mark.parametrize("scan", JPl.SCAN_MODES)
@pytest.mark.parametrize("aggregated", [False, True])
@pytest.mark.parametrize("pushdown", [False, True])
def test_param_join_matches_reference(world, scan, aggregated, pushdown):
    jcand, tcand = _candidates(world, scan)
    assert_same_tuple(jcand, tcand, f"{scan} candidates")
    jt, tt = world["targets"][aggregated]
    up = world["up"] if pushdown else None
    jres = JPl.join_param_targets(
        world["jds"], jcand, jt, JR.STATE, 30 * 1024, 3,
        None if up is None else jnp.asarray(up), aggregated)
    tres = TPl.join_param_targets(
        world["tds"], tcand, tt, TR.STATE, 30 * 1024, 3,
        None if up is None else torch.as_tensor(up), aggregated)
    assert_same_tuple(jres, tres, f"{scan} agg={aggregated} push={pushdown}")
    assert int(tres.num_results) > 0


@pytest.mark.parametrize("scan", ["window", "bad_index"])
@pytest.mark.parametrize("kernel", [False, True])
def test_spatial_join_matches_reference(world, scan, kernel):
    jcand, tcand = _candidates(world, scan)
    users, brokers = world["users"], world["brokers"]
    jres = JPl.join_spatial(world["jds"], jcand, jnp.asarray(users),
                            jnp.asarray(brokers), 10.0, 30 * 1024, 3,
                            jsm.spatial_match if kernel else None)
    tres = TPl.join_spatial(world["tds"], tcand, torch.as_tensor(users),
                            torch.as_tensor(brokers), 10.0, 30 * 1024, 3,
                            tsm.spatial_match if kernel else None)
    assert_same_tuple(jres, tres, f"spatial {scan} kernel={kernel}")
    assert int(tres.num_results) > 0


def test_spatial_broker_bytes_wrap_like_reference(world):
    """Per-broker byte sums past 2^31 wrap exactly as the reference's int32
    sums do (the port multiplies per-broker counts by the payload)."""
    jcand, tcand = _candidates(world, "bad_index")
    users, brokers = world["users"], world["brokers"]
    payload = 2**30 + 7
    jres = JPl.join_spatial(world["jds"], jcand, jnp.asarray(users),
                            jnp.asarray(brokers), 10.0, payload, 3)
    tres = TPl.join_spatial(world["tds"], tcand, torch.as_tensor(users),
                            torch.as_tensor(brokers), 10.0, payload, 3)
    assert_same_tuple(jres, tres, "spatial wrap")
    assert int(tres.broker_results.max()) >= 2


def test_slot_row_ids_and_compact(rng):
    for size, cap in ((0, 8), (5, 8), (8, 8), (21, 8)):
        jds = JR.ActiveDataset(jnp.zeros((cap, 10), jnp.int32),
                               jnp.zeros((cap, 2), jnp.float32),
                               jnp.int32(size))
        tds = TR.ActiveDataset(torch.zeros((cap, 10), dtype=torch.int32),
                               torch.zeros((cap, 2)),
                               torch.tensor(size, dtype=torch.int32))
        assert_same(JPl._slot_row_ids(jds, jnp.arange(cap, dtype=jnp.int32)),
                    TPl._slot_row_ids(tds, torch.arange(cap, dtype=torch.int32)),
                    f"slot_row_ids size={size}")
    rows = rng.integers(0, 100, 50).astype(np.int32)
    for p in (0.0, 0.3, 1.0):
        mask = rng.random(50) < p
        for out in (1, 10, 64):
            a = JPl._compact(jnp.asarray(rows), jnp.asarray(mask), out)
            b = TPl._compact(torch.as_tensor(rows), torch.as_tensor(mask), out)
            assert_same(a[0], b[0], "compact rows")
            assert_same(a[1], b[1], "compact valid")


def test_plan_types_and_backend_names():
    assert TPl.BACKENDS == JPl.BACKENDS and TPl.SCAN_MODES == JPl.SCAN_MODES
    for b in TPl.BACKENDS:
        assert TPl.backend_family(b) == JPl.backend_family(b)
        assert TPl.is_compact(b) == JPl.is_compact(b)
    plan = TPl.ChannelPlan("bad_index", True, True, "pallas")
    assert plan.to_dict() == JPl.ChannelPlan("bad_index", True, True,
                                             "pallas").to_dict()
    assert TPl.ChannelPlan.from_dict(plan.to_dict()) == plan
    assert plan.flags == TPl.ExecutionFlags.fully_optimized()
    with pytest.raises(ValueError):
        TPl.ChannelPlan(backend="triton")
