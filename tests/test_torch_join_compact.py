"""Port parity for the compacted execution join: the ``join_compact``
plain version bit for bit against the reference's ``ref.join_pairs`` and its
interpret-mode Pallas kernel on the edge cases; the stream functions
(``compact_candidates``, ``join_param_stream``, ``join_spatial_stream``,
``stream_to_stacked``) and the ``flatten_*`` builders on the same numpy
inputs, overflowing streams included; the engine's stream buckets and the
``execute_channel`` backend override."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plans as JPl  # noqa: E402
from repro.core import records as JRec  # noqa: E402
from repro.kernels.join_compact import ops as jjc_ops  # noqa: E402
from repro.kernels.join_compact import ref as jjc_ref  # noqa: E402
from repro_torch.core import plans as TPl  # noqa: E402
from repro_torch.core import records as TRec  # noqa: E402
from repro_torch.core.engine import _STREAM_FLOOR, _STREAM_PATIENCE  # noqa: E402
from repro_torch.kernels.join_compact import ops as tjc_ops  # noqa: E402

from torch_engine_pairs import (PARAM, JFlags, JPlan, TFlags,  # noqa: E402
                                TPlan, _assert_queues, _assert_reports,
                                _buckets, _engines, _ingest)
from torch_parity import assert_same, assert_same_tuple, stats_tuple  # noqa: E402

I32_MAX = 2 ** 31 - 1

# the reference's stream and stacked functions, compiled once per static
# configuration: dispatching their many small ops one by one costs more
compact_candidates = jax.jit(JPl.compact_candidates, static_argnums=1)
join_param_stream = jax.jit(JPl.join_param_stream, static_argnums=(5, 7, 9))
join_spatial_stream = jax.jit(JPl.join_spatial_stream, static_argnums=6)
stream_to_stacked = jax.jit(JPl.stream_to_stacked, static_argnums=3)
join_param_targets_all = jax.jit(JPl.join_param_targets_all,
                                 static_argnums=(5, 7))
join_spatial_all = jax.jit(JPl.join_spatial_all, static_argnums=6)
flatten_result_pairs = jax.jit(JPl.flatten_result_pairs, static_argnums=1)
flatten_values_all = jax.jit(JPl.flatten_values_all, static_argnums=2)


def _pair_inputs(rng, s, max_t, payload_hi=4000):
    return (rng.integers(-1, 20, (s, max_t)).astype(np.int32),
            rng.integers(0, max_t + 1, s).astype(np.int32),
            rng.integers(0, 9, (s, max_t)).astype(np.int32),
            rng.integers(0, 3, (s, max_t)).astype(np.int32),
            rng.random(s) < 0.7,
            rng.integers(1, payload_hi, s).astype(np.int32))


def _edge_cases():
    rng = np.random.default_rng(0)
    yield "ragged", _pair_inputs(rng, 37, 5)
    yield "maxT=1", _pair_inputs(rng, 130, 1)
    tgt, tn, mem, br, valid, pay = _pair_inputs(rng, 33, 4)
    yield "all tgt=-1", (np.full_like(tgt, -1), tn, mem, br, valid, pay)
    yield "valid all False", (tgt, tn, mem, br, np.zeros_like(valid), pay)
    tgt, tn, mem, br, valid, pay = _pair_inputs(rng, 45, 6)
    pay = (I32_MAX - rng.integers(0, 40, 45)).astype(np.int32)
    yield "payload near int32 max", (tgt, tn, mem, br, valid, pay)
    tgt, tn, mem, br, valid, pay = _pair_inputs(rng, 29, 8)
    past = (8 + rng.integers(1, 5, 29)).astype(np.int32)
    past[::7] = I32_MAX
    yield "tgt_n > maxT", (tgt, past, mem, br, valid, pay)
    yield "tgt_n=0, valid all True", (tgt, np.zeros_like(tn), mem, br,
                                      np.ones_like(valid), pay)


@pytest.mark.parametrize("aggregated", [False, True])
def test_join_pairs_plain_matches_ref_and_interpret_kernel(aggregated):
    """The port's plain join_pairs (what a CPU tensor runs) equals the
    reference's jnp ref and its interpret-mode Pallas kernel bit for bit,
    dtypes included, on ragged S, maxT = 1, no live target, no valid entry,
    payloads whose byte sums wrap past int32, tgt_n past maxT and tgt_n 0
    with every entry valid."""
    for tag, (tgt, tn, mem, br, valid, pay) in _edge_cases():
        args = (tgt, tn, mem, br, valid, pay)
        want = jjc_ref.join_pairs(*map(jnp.asarray, args), 3, aggregated)
        kern = jjc_ops.join_pairs(*map(jnp.asarray, args), 3, aggregated,
                                  ts=16)
        before = (tjc_ops.LAUNCHES, tjc_ops.SHAPE)
        got = tjc_ops.join_pairs(*map(torch.as_tensor, args), 3, aggregated)
        assert (tjc_ops.LAUNCHES, tjc_ops.SHAPE) == before   # plain version
        for name, w, k, g in zip(("pair_valid", "members", "pair_bytes",
                                  "bids"), want, kern, got):
            assert_same(w, g, f"{tag} {name} (ref)")
            assert_same(k, g, f"{tag} {name} (interpret kernel)")


@pytest.mark.parametrize("max_t,offset,want", [
    (16, 0, True), (16384, 0, True), (5, 0, False), (33, 0, False),
    (16, 1, False)])
def test_vector_ok_takes_aligned_quads(max_t, offset, want):
    """The kernel's quad path takes maxT % 4 == 0 on tensors that start on a
    16-byte boundary: new tensors do; a contiguous view one element (4 B)
    into its storage does not, whichever tensor it is."""
    rng = np.random.default_rng(max_t)
    args = [torch.as_tensor(a) for a in _pair_inputs(rng, 3, max_t)]
    if offset:
        buf = torch.zeros(3 * max_t + offset, dtype=torch.int32)
        args[2] = buf[offset:].view(3, max_t)
        assert args[2].is_contiguous() and args[2].storage_offset() == 1
    assert tjc_ops.vector_ok(args, max_t) is want
    blocks, threads = tjc_ops.grid(3, max_t, want)
    per_block = threads * (tjc_ops.QUAD if want else 1)
    assert blocks * per_block >= 3 * max_t > (blocks - 1) * per_block


@pytest.fixture(scope="module")
def stream_world():
    """Both packages' dataset, a stacked (C, Rm) candidate set and stacked
    shape-bucketed targets, built from one numpy seed."""
    rng = np.random.default_rng(5)
    cap, C, Rm, T, D, M = 256, 3, 40, 24, 12, 6
    fields = rng.integers(0, 14, (cap, 10)).astype(np.int32)
    loc = (np.round(rng.normal(size=(cap, 2)) * 40) / 2).astype(np.float32)
    size = np.int32(300)
    jds = JRec.ActiveDataset(jnp.asarray(fields), jnp.asarray(loc),
                             jnp.asarray(size))
    tds = TRec.ActiveDataset(torch.as_tensor(fields), torch.as_tensor(loc),
                             torch.as_tensor(size))
    rows = rng.integers(44, 300, (C, Rm)).astype(np.int32)
    valid = rng.random((C, Rm)) < 0.45
    rows = np.where(valid, rows, -1).astype(np.int32)
    scanned = rng.integers(0, 90, C).astype(np.int32)
    by_param = rng.integers(-1, T, (C, D, M)).astype(np.int32)
    targets = (rng.integers(0, D, (C, T)).astype(np.int32),
               rng.integers(0, 3, (C, T)).astype(np.int32),
               rng.integers(0, 5, (C, T)).astype(np.int32), by_param,
               rng.integers(0, M + 1, (C, D)).astype(np.int32))
    scal = dict(param_field=rng.integers(0, 10, C).astype(np.int32),
                payload=rng.integers(100, 4000, C).astype(np.int32),
                up=rng.random((C, D)) < 0.7,
                domain=np.asarray([D, D - 3, 7], np.int32),
                ulocs=(np.round(rng.normal(size=(C, 16, 2)) * 40) / 2
                       ).astype(np.float32),
                ubrokers=rng.integers(0, 3, (C, 16)).astype(np.int32),
                radius=np.asarray([8.0, 12.5, 20.0], np.float32))
    jc = JPl.CandidateSet(*map(jnp.asarray, (rows, valid, scanned)))
    tc = TPl.CandidateSet(*map(torch.as_tensor, (rows, valid, scanned)))
    jt = JPl.TargetArrays(*map(jnp.asarray, targets))
    tt = TPl.TargetArrays(*map(torch.as_tensor, targets))
    return dict(jds=jds, tds=tds, jc=jc, tc=tc, jt=jt, tt=tt,
                j={k: jnp.asarray(v) for k, v in scal.items()},
                t={k: torch.as_tensor(v) for k, v in scal.items()})


@pytest.mark.parametrize("cap", [128, 32])
def test_stream_functions_match_reference(stream_world, cap):
    """compact_candidates, join_param_stream (plain and the kernel hook),
    join_spatial_stream and stream_to_stacked equal the reference on the
    same inputs. At cap 32 the stream overflows (total > S): the totals
    agree and so does everything computed from the truncated stream."""
    w = stream_world
    js = compact_candidates(w["jc"], cap)
    ts = TPl.compact_candidates(w["tc"], cap)
    assert_same_tuple(js, ts, "stream")
    assert (int(ts.total) > cap) == (cap == 32)
    width = min(cap, w["jc"].rows.shape[1])
    for agg in (False, True):
        for up in (False, True):
            jsj = join_param_stream(
                w["jds"], js, w["jt"], w["j"]["param_field"],
                w["j"]["payload"], 3, w["j"]["up"] if up else None, agg,
                w["j"]["domain"], jjc_ref.join_pairs)
            for join_fn in (None, tjc_ops.join_pairs):
                tsj = TPl.join_param_stream(
                    w["tds"], ts, w["tt"], w["t"]["param_field"],
                    w["t"]["payload"], 3, w["t"]["up"] if up else None, agg,
                    w["t"]["domain"], join_fn)
                assert_same_tuple(jsj, tsj, f"param agg={agg} up={up}")
            assert_same_tuple(
                stream_to_stacked(jsj, js, w["jc"].scanned, width),
                TPl.stream_to_stacked(tsj, ts, w["tc"].scanned, width),
                f"stacked agg={agg} up={up}")
    jsj = join_spatial_stream(w["jds"], js, w["j"]["ulocs"],
                              w["j"]["ubrokers"], w["j"]["radius"],
                              w["j"]["payload"], 3)
    tsj = TPl.join_spatial_stream(w["tds"], ts, w["t"]["ulocs"],
                                  w["t"]["ubrokers"], w["t"]["radius"],
                                  w["t"]["payload"], 3)
    assert_same_tuple(jsj, tsj, "spatial")
    assert int(tsj.num_results.sum()) > 0
    assert_same_tuple(stream_to_stacked(jsj, js, w["jc"].scanned, width),
                      TPl.stream_to_stacked(tsj, ts, w["tc"].scanned, width),
                      "spatial stacked")


def test_stacked_joins_and_flatten_builders_match_reference(stream_world):
    """The padded stacked joins over the channel axis and the flatten_*
    compaction builders equal the reference on the same inputs."""
    w = stream_world
    for agg in (False, True):
        for up in (False, True):
            assert_same_tuple(
                join_param_targets_all(
                    w["jds"], w["jc"], w["jt"], w["j"]["param_field"],
                    w["j"]["payload"], 3, w["j"]["up"] if up else None, agg,
                    w["j"]["domain"]),
                TPl.join_param_targets_all(
                    w["tds"], w["tc"], w["tt"], w["t"]["param_field"],
                    w["t"]["payload"], 3, w["t"]["up"] if up else None, agg,
                    w["t"]["domain"]), f"padded agg={agg} up={up}")
    jres = join_spatial_all(w["jds"], w["jc"], w["j"]["ulocs"],
                            w["j"]["ubrokers"], w["j"]["radius"],
                            w["j"]["payload"], 3)
    tres = TPl.join_spatial_all(w["tds"], w["tc"], w["t"]["ulocs"],
                                w["t"]["ubrokers"], w["t"]["radius"],
                                w["t"]["payload"], 3)
    assert_same_tuple(jres, tres, "spatial padded")
    for max_total in (7, 64):
        assert_same_tuple(flatten_result_pairs(jres, max_total),
                          TPl.flatten_result_pairs(tres, max_total),
                          f"flatten pairs {max_total}")
        assert_same_tuple(
            flatten_values_all(jres.pair_rows, jres.pair_valid, max_total),
            TPl.flatten_values_all(tres.pair_rows, tres.pair_valid,
                                   max_total), f"flatten values {max_total}")
    assert JPl.compact_variant("pallas") == TPl.compact_variant("pallas")
    assert [p.to_dict() for p in JPl.enumerate_plans(("oracle", "compact"))] \
        == [p.to_dict() for p in TPl.enumerate_plans(("oracle", "compact"))]


def test_stream_buckets_grow_on_burst_and_shrink_after_idle():
    """The adaptive capacity protocol (the reference's
    test_compact_join.py): a burst grows the bucket straight to the live
    total's power of two, ``_STREAM_PATIENCE`` quiet ticks halve it; the
    port's buckets equal the reference's after every tick."""
    je, te, rng = _engines(40)
    plan = ("window", False, True, "compact")
    for eng, cls in ((je, JPlan), (te, TPlan)):
        for name in PARAM:
            eng.set_plan(name, cls(*plan))
    key = ("param", tuple(sorted(TPlan(*plan).to_dict().items())), PARAM)
    floor = 1 << _STREAM_FLOOR

    def tick(n, match, t0):
        _ingest(je, te, rng, n, t0, match)
        _assert_reports(je.execute_all(timed=False),
                        te.execute_all(timed=False), t0)
        assert _buckets(je) == _buckets(te), t0

    tick(30, 0.1, 1)
    assert _buckets(te)[key] == floor
    tick(500, 0.9, 100)
    grown = _buckets(te)[key]
    assert grown > floor
    for i in range(_STREAM_PATIENCE):
        assert _buckets(te)[key] == grown
        tick(5, 0.1, 2000 + 10 * i)
    assert _buckets(te)[key] == grown // 2


def test_execute_channel_backend_override():
    """``execute_channel(..., backend=...)`` on the compact backends equals
    the reference's, and the single-channel stream buckets agree."""
    je, te, rng = _engines(41)
    _ingest(je, te, rng, 400, 1)
    for name in ("TweetsAboutDrugs", "TweetsAboutCrime3"):
        for flags in (("window", False, False), ("bad_index", True, True)):
            for backend in ("compact", "compact_pallas"):
                a = je.execute_channel(name, JFlags(*flags), advance=False,
                                       deliver=True, backend=backend)
                b = te.execute_channel(name, TFlags(*flags), advance=False,
                                       deliver=True, backend=backend)
                tag = (name, flags, backend)
                assert_same_tuple(a.result, b.result, tag)
                assert_same(a.broker_bytes, b.broker_bytes, tag)
                assert stats_tuple(a.overflow) == stats_tuple(b.overflow)
        _assert_queues(je, te, name)
    assert _buckets(je) == _buckets(te)
