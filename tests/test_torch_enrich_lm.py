"""Port parity for ``LMScorer``: reduced qwen2-1.5b in float32 with the
reference's key-0 parameters carried across (``params_from_numpy``). The
scores agree within ``TOL``; in an over-budget fused tick the kept sets are
equal, and the test first asserts that every channel's boundary score gap
(the last funded slot against the first unfunded one) exceeds ``TOL``, so
that rounding could not have flipped the rank."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import enrich as jen  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import enrich as ten  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402

from torch_enrich_pairs import AGG, _both, _delivered, _pair  # noqa: E402

TOL = 1e-5      # float32 logits of the same model, products in another order
BUDGET = 12


def _scorers(budget=None):
    """(reference, port) reduced-LM scorers on the reference's key-0
    parameters."""
    js = jen.LMScorer(budget=budget)
    params = params_from_numpy(tconfigs.get_reduced("qwen2-1.5b"),
                               jax.tree.map(np.asarray, js.params),
                               device="cpu")
    return js, ten.LMScorer(budget=budget, device="cpu", params=params)


def test_scores_match_reference(rng):
    js, ts = _scorers()
    assert ts.identity == js.identity
    assert ts.cfg.name == js.cfg.name and ts.cfg.d_model == 64
    toks = rng.integers(-5, 400, (37, 10)).astype(np.int32)
    got = ts.score(torch.tensor(toks), None, None)
    want = js.score(jnp.asarray(toks), None, None)
    assert got.dtype == torch.float32 and got.shape == (37,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    own = ten.LMScorer(budget=3, device="cpu", seed=5)
    assert own.identity == ("lm", "qwen2-1.5b", 5, 64, 3)
    assert torch.isfinite(own.score(torch.tensor(toks), None, None)).all()


def _boundary_gap(rep, scorer, ds):
    """min over the channel's boundary of (score of the last slot that keeps
    a pair - score of the first slot that keeps none), ranking slots by
    (score desc, index asc) and funding them down to the budget."""
    res = rep.result
    vc = res.pair_valid.sum(-1).numpy()
    rows = res.matched_rows
    toks = ds.fields[torch.clamp(rows, min=0).long() % ds.capacity]
    s = scorer.score(toks, None, None).numpy()
    live = np.flatnonzero(vc > 0)
    order = live[np.lexsort((live, -s[live]))]
    funded = np.cumsum(vc[order]) - vc[order] < BUDGET
    last, first = order[funded][-1], order[~funded][0]
    return float(s[last] - s[first])


def test_lm_ranked_tick_keeps_the_reference_set():
    js, ts = _scorers(BUDGET)
    je, te, _ = _pair(seed=4)
    je.set_enrichment(js)
    te.set_enrichment(ts)
    a, b = _both(je, te, AGG[1])
    over = [n for n, r in b.items() if r.num_results > BUDGET]
    assert over, {n: r.num_results for n, r in b.items()}
    for name in over:
        gap = _boundary_gap(b[name], ts, te.dataset)
        assert gap > 4 * TOL, (name, gap)
        assert b[name].overflow.ranked_pairs == b[name].num_results - BUDGET
    assert _delivered(a) == _delivered(b)
