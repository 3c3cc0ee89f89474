"""Port parity for four functions the ported modules lacked:
``core/records.Dictionary``, ``core/predicates.evaluate_single`` and
``selectivity``, and ``kernels/predicate_filter/ops.predicate_filter_ref``,
against the reference's, on the inputs of ``tests/test_core_units.py``
(the exhaustive operator check and the multi-channel conditionsList),
``tests/test_system.py`` (TweetsAboutCrime3's fixed predicates on 512
tweets) and ``tests/test_substrate.py`` (the five selectivity conditions
over 20,000 tweets)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import channel as jch  # noqa: E402
from repro.core import predicates as JP  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.data.synthetic import tweet_batch  # noqa: E402
from repro.kernels.predicate_filter import ops as jpf  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import predicates as TP  # noqa: E402
from repro_torch.core import records as TR  # noqa: E402
from repro_torch.kernels.predicate_filter import ops as tpf  # noqa: E402

from conftest import make_tweets  # noqa: E402
from torch_parity import assert_same  # noqa: E402

OPS = ["==", "!=", "<", "<=", ">", ">="]
# tests/test_substrate.py::test_tweet_batch_selectivities, I-V
FIVE = [(JR.ABOUT_COUNTRY, "==", 0), (JR.RETWEET_COUNT, ">", 10000),
        (JR.HATE_SPEECH_RATE, ">", 5), (JR.THREATENING_RATE, ">", 5),
        (JR.WEAPON_MENTIONED, "==", 1)]


def test_dictionary_matches_reference():
    words = ["US", "pt", "US", "Manufacturing Drugs", "", "pt", "é", "US",
             "Selling Drugs", ""]
    jd, td = JR.Dictionary(), TR.Dictionary()
    assert [td.encode(w) for w in words] == [jd.encode(w) for w in words]
    assert len(td) == len(jd) == 6
    for code in range(len(jd)):
        assert td.decode(code) == jd.decode(code)
    for bad in (6, -1, 100):
        with pytest.raises(KeyError):
            jd.decode(bad)
        with pytest.raises(KeyError):
            td.decode(bad)
    assert len(TR.Dictionary()) == 0


@pytest.mark.parametrize("op", OPS)
def test_evaluate_single_operators_exhaustive(op):
    """tests/test_core_units.py::test_predicate_ops_exhaustive on both."""
    f = np.arange(10, dtype=np.int32)[:, None]
    want = JP.evaluate_single(jnp.asarray(f), [JP.Predicate.parse(0, op, 5)])
    got = TP.evaluate_single(torch.from_numpy(f),
                             [TP.Predicate.parse(0, op, 5)])
    assert_same(want, got, op)


def test_evaluate_single_on_the_system_test_input(rng):
    """tests/test_system.py::test_spatial_channel_matches_bruteforce's mask:
    TweetsAboutCrime3's fixed predicates over 512 tweets."""
    batch = make_tweets(rng, 512)
    fields = np.array(batch.fields)
    want = JP.evaluate_single(batch.fields,
                              jch.tweets_about_crime(3).fixed_preds)
    got = TP.evaluate_single(torch.from_numpy(fields),
                             tch.tweets_about_crime(3).fixed_preds)
    assert_same(want, got)
    assert 0 < int(got.sum()) < 512
    assert_same(JP.evaluate_single(batch.fields, []),
                TP.evaluate_single(torch.from_numpy(fields), []))


def test_selectivity_matches_reference(rng):
    f = np.array(tweet_batch(rng, 20000, t0=0).fields)
    for field, op, value in FIVE:
        want = JP.selectivity(f, [JP.Predicate.parse(field, op, value)])
        got = TP.selectivity(f, [TP.Predicate.parse(field, op, value)],
                             device="cpu")
        assert isinstance(got, float) and got == want, (field, op)
        assert TP.selectivity(torch.from_numpy(f),
                              [TP.Predicate.parse(field, op, value)]) == want
    all5 = [TP.Predicate.parse(*c) for c in FIVE]
    assert TP.selectivity(f, all5, device="cpu") == JP.selectivity(
        f, [JP.Predicate.parse(*c) for c in FIVE])
    assert TP.selectivity(f[:0], all5, device="cpu") == \
        JP.selectivity(f[:0], [JP.Predicate.parse(*c) for c in FIVE]) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TP.selectivity(f, all5)


def test_predicate_filter_ref_matches_reference(rng):
    """tests/test_core_units.py::test_conditions_list_multi_channel's
    conditionsList, and random multi-predicate channels, through both
    oracles; the port's also equals its wrapper on the CPU."""
    f = rng.integers(0, 10, (64, 10)).astype(np.int32)
    spec = [[(0, ">", 4)], [(1, "==", 3), (2, "<", 7)], [],
            [(3, "!=", 2), (3, ">=", 1), (4, "<=", 8)]]
    big = rng.integers(-50, 50, (1000, 10)).astype(np.int32)
    for fields in (f, big):
        jc = JP.compile_conditions([[JP.Predicate.parse(*p) for p in c]
                                    for c in spec])
        tc = TP.compile_conditions([[TP.Predicate.parse(*p) for p in c]
                                    for c in spec])
        got = tpf.predicate_filter_ref(torch.from_numpy(fields), tc)
        assert_same(jpf.predicate_filter_ref(jnp.asarray(fields), jc), got)
        assert_same(got, tpf.predicate_filter(torch.from_numpy(fields), tc))
        assert_same(got, TP.evaluate_conditions(torch.from_numpy(fields), tc))
