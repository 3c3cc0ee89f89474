"""Port parity: conditionsList evaluation and the predicate_filter kernel's
plain path, against the reference's oracle and its Pallas kernel (run in
interpret mode on the CPU, as tests/test_kernels.py runs it)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import predicates as JP  # noqa: E402
from repro.kernels.predicate_filter import ops as jpf  # noqa: E402
from repro.kernels.predicate_filter import ref as jpf_ref  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import predicates as TP  # noqa: E402
from repro_torch.kernels.predicate_filter import ops as tpf  # noqa: E402
from repro_torch.kernels.predicate_filter import ref as tpf_ref  # noqa: E402

from torch_parity import assert_same  # noqa: E402

OPS = ["==", "!=", "<", "<=", ">", ">="]


def _channels(rng, nchan, lib):
    """Random conjunctions, at most one != per (channel, field), built with
    ``lib``'s Predicate from the same draws."""
    chans = []
    for _ in range(nchan):
        preds = [(int(rng.integers(0, 10)), OPS[int(rng.integers(0, 6))],
                  int(rng.integers(-40, 40)))
                 for _ in range(int(rng.integers(1, 4)))]
        seen = {}
        preds = [p for p in preds
                 if not (p[1] == "!=" and seen.setdefault(p[0], p[2]) != p[2])]
        chans.append(preds)
    return chans


def _compile(chans, lib):
    return lib.compile_conditions([[lib.Predicate.parse(*p) for p in c]
                                   for c in chans])


@pytest.mark.parametrize("n", [1, 7, 256, 513])
@pytest.mark.parametrize("nchan", [1, 3, 9])
def test_predicate_filter_sweep(rng, n, nchan):
    fields = rng.integers(-50, 50, (n, 10)).astype(np.int32)
    chans = _channels(rng, nchan, JP)
    jc, tc = _compile(chans, JP), _compile(chans, TP)
    for a in ("field_idx", "op", "value", "npreds"):
        assert_same(getattr(jc, a), getattr(tc, a), a)
    tf = torch.as_tensor(fields)
    want = JP.evaluate_conditions(jnp.asarray(fields), jc)
    assert_same(want, TP.evaluate_conditions(tf, tc), "evaluate_conditions")
    assert_same(jpf.predicate_filter(jnp.asarray(fields), jc),
                tpf.predicate_filter(tf, tc), "predicate_filter")


def test_predicate_filter_interval_edges():
    fields = np.array([[-2**31, 2**31 - 1, 0, 5, 0, 0, 0, 0, 0, 0]],
                      dtype=np.int32)
    chans = [[(0, "<=", -2**31 + 1)], [(1, ">=", 2**31 - 1)],
             [(3, "==", 5), (3, "!=", 4)], [(2, "<", -2**31 + 1)],
             [(1, ">", 2**31 - 2), (0, "!=", 0)]]
    jc, tc = _compile(chans, JP), _compile(chans, TP)
    tf = torch.as_tensor(fields)
    want = JP.evaluate_conditions(jnp.asarray(fields), jc)
    assert_same(want, TP.evaluate_conditions(tf, tc), "evaluate_conditions")
    assert_same(jpf.predicate_filter(jnp.asarray(fields), jc),
                tpf.predicate_filter(tf, tc), "predicate_filter")


def test_canonicalize_matches_reference(rng):
    chans = _channels(rng, 6, JP)
    a = jpf_ref.canonicalize(_compile(chans, JP), 10)
    b = tpf_ref.canonicalize(_compile(chans, TP), 10)
    for k in ("lo", "hi", "neq"):
        assert_same(getattr(a, k), getattr(b, k), k)
    with pytest.raises(ValueError, match="at most one"):
        tpf_ref.canonicalize(_compile([[(0, "!=", 1), (0, "!=", 2)]], TP), 10)


def test_apply_op_every_comparator(rng):
    lhs = rng.integers(-3, 3, 50).astype(np.int32)
    for op in range(7):                     # 6 is unknown: compares true
        want = JP.apply_op(jnp.asarray(lhs), jnp.asarray(op), jnp.asarray(0))
        got = TP.apply_op(torch.as_tensor(lhs), op, 0)
        assert_same(want, got, f"op {op}")


def test_paper_channels_on_tweets(rng):
    from repro.core import channel as jch
    from repro.data.synthetic import drug_tweak, tweet_batch
    b = tweet_batch(rng, 700, t0=1)
    f = drug_tweak(np.asarray(b.fields).copy(), rng, 0.2)
    jspecs = [jch.tweets_about_drugs(), jch.most_threatening_tweets(),
              jch.tweets_about_crime(3), jch.tweets_about_crime(5)]
    tspecs = [tch.tweets_about_drugs(), tch.most_threatening_tweets(),
              tch.tweets_about_crime(3), tch.tweets_about_crime(5)]
    for js, ts in zip(jspecs, tspecs):
        assert (js.name, js.join, js.param_field, js.payload_bytes) == \
            (ts.name, ts.join, ts.param_field, ts.payload_bytes)
    jc = JP.compile_conditions([list(s.fixed_preds) for s in jspecs])
    tc = TP.compile_conditions([list(s.fixed_preds) for s in tspecs])
    assert_same(jpf.predicate_filter(jnp.asarray(f), jc),
                tpf.predicate_filter(torch.as_tensor(f), tc), "bitmap")


def _tables(c, f):
    return tuple(torch.zeros((c, f), dtype=torch.int32) for _ in range(3))


def test_kernel_check_takes_aligned_records():
    """``ops._check`` holds what the vectorized kernel takes; it reads no
    device, so it runs here on CPU tensors."""
    x = torch.zeros((257, 10), dtype=torch.int32)
    assert x.data_ptr() % tpf.ALIGN == 0
    tpf._check("predicate_filter", x, (x, *_tables(3, 10)),
               ((257, 10), (3, 10), (3, 10), (3, 10)))
    xr = torch.zeros((6, 257, 10), dtype=torch.int32)
    tpf._check("predicate_filter_rows", xr, (xr, *_tables(6, 10)),
               ((6, 257, 10), (6, 10), (6, 10), (6, 10)))


@pytest.mark.parametrize("offset_words", [1, 2, 3])
def test_kernel_check_refuses_a_misaligned_view(offset_words):
    """The kernel reads the records with 16-byte loads: a contiguous view
    4, 8 or 12 bytes into a buffer is refused."""
    flat = torch.zeros(257 * 10 + 4, dtype=torch.int32)
    x = flat[offset_words:offset_words + 2570].view(257, 10)
    assert x.is_contiguous() and x.data_ptr() % tpf.ALIGN
    with pytest.raises(ValueError, match="16-byte"):
        tpf._check("predicate_filter", x, (x, *_tables(3, 10)),
                   ((257, 10), (3, 10), (3, 10), (3, 10)))


@pytest.mark.parametrize("case", ["int64", "strided", "table_shape",
                                  "table_dtype"])
def test_kernel_check_refuses_what_the_kernel_does_not_take(case):
    x = torch.zeros((257, 10), dtype=torch.int32)
    tables = list(_tables(3, 10))
    if case == "int64":
        x = x.long()
    elif case == "strided":
        x = torch.zeros((257, 20), dtype=torch.int32)[:, ::2]
    elif case == "table_shape":
        tables[0] = torch.zeros((3, 9), dtype=torch.int32)
    elif case == "table_dtype":
        tables[2] = tables[2].long()
    with pytest.raises(ValueError, match="int32"):
        tpf._check("predicate_filter", x, (x, *tables),
                   ((257, 10), (3, 10), (3, 10), (3, 10)))
