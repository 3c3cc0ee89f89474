"""Port parity for the MoE, SSM, hybrid, VLM and encoder-decoder families
through ``ModelApi`` and ``launch/serve.py``: for each of the six arch ids,
the reduced config (float32) with the reference's initialised parameters
carried across by ``interop.params_from_numpy``; prefill and three cached
decode steps against ``repro.models.model.ModelApi``, logits and every
state leaf (dtype and shape equal); greedy ``serve`` tokens equal to the
reference's; parameter counts equal at full size (the port on the meta
device) and reduced.

Tolerances: logits 5e-5 absolute (float32, magnitude about 3; the SSM
chunks are summed in another order, the largest error seen is 1.6e-5), each
state leaf 5e-5 times max(1, its largest magnitude) (the recurrent states
grow with the prompt)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import SHAPES  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

FAMILIES = ["phi3.5-moe-42b-a6.6b", "dbrx-132b", "xlstm-125m", "pixtral-12b",
            "zamba2-2.7b", "seamless-m4t-medium"]
LOGIT_TOL = 5e-5
STATE_TOL = 5e-5
B, S, FRAMES = 2, 16, 24


def _pair(arch, seed=1):
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = JApi(jcfg).init(jax.random.key(seed))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _batches(cfg, rng):
    """The prefill batch for both packages and the decode tokens."""
    toks = rng.integers(0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    if cfg.is_encdec:
        emb = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
        arrays = {"embeds": emb, "tokens": toks[:, :S]}
    elif cfg.frontend == "embed":
        arrays = {"embeds": rng.normal(size=(B, S, cfg.d_model))
                  .astype(np.float32)}
    else:
        arrays = {"tokens": toks[:, :S]}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v) for k, v in arrays.items()}, toks[:, S:])


def _state_leaves(cfg, jcache, tcache):
    """(name, port leaf stacked over depth, reference leaf) of every state
    leaf: the reference stacks each over the superlayers (decoder layers)."""
    if cfg.is_encdec:
        for name in jcache:
            yield name, torch.stack([c[name] for c in tcache]), jcache[name]
        return
    for blk, tree in jcache.items():
        for name in tree:
            yield (f"{blk}.{name}", torch.stack([c[blk][name] for c in tcache]),
                   tree[name])


def _same_states(cfg, jcache, tcache):
    assert len(tcache) == cfg.superlayer_repeat
    seen = 0
    for name, got, want in _state_leaves(cfg, jcache, tcache):
        want = np.asarray(want)
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=STATE_TOL * scale, rtol=0,
                                   err_msg=name)
        seen += 1
    return seen


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_the_reference(rng, arch):
    """Prefill (last-token logits, every state leaf) and three decode steps
    (logits and every state leaf after them) against the reference."""
    jcfg, tcfg, jp, tp = _pair(arch)
    japi, tapi = JApi(jcfg), TApi(tcfg)
    jb, tb, nxt = _batches(jcfg, rng)
    max_len = S + 4
    jl, jc, jpos = japi.prefill(jp, jb, max_len=max_len)
    tl, tc, tpos = tapi.prefill(tp, tb, max_len=max_len)
    assert tpos == int(jpos) == S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    leaves = _same_states(jcfg, jc, tc)
    assert leaves == len(jax.tree.leaves(jc))
    for i in range(3):
        jl, jc = japi.decode(jp, jc, jpos + i, {"token": jnp.asarray(nxt[:, i])})
        tl, tc = tapi.decode(tp, tc, tpos + i, {"token": torch.tensor(nxt[:, i])})
        assert tl.shape == (B, tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   rtol=0)
    _same_states(jcfg, jc, tc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_counts_and_specs_match_the_reference(arch):
    """param_count and active_param_count at full size (the port's tree on
    the meta device) and reduced; cache shapes and input specs of every
    supported shape cell; ``loss`` at the ``train_4k`` cell's input specs
    (cut to batch 2 and 8 positions) gives a finite float32 loss."""
    for get_j, get_t in ((jconfigs.get_config, tconfigs.get_config),
                         (jconfigs.get_reduced, tconfigs.get_reduced)):
        japi, tapi = JApi(get_j(arch)), TApi(get_t(arch))
        assert tapi.param_count() == japi.param_count()
        assert tapi.active_param_count() == japi.active_param_count()
    japi, tapi = JApi(jconfigs.get_config(arch)), TApi(tconfigs.get_config(arch))
    for name in SHAPES:
        assert tapi.supports(name) == japi.supports(name)
        for key, spec in tapi.input_specs(name).items():
            want = japi.input_specs(name)[key]
            assert spec.shape == want.shape, (name, key)
            assert str(spec.dtype).split(".")[-1] == np.dtype(want.dtype).name
        if name == "decode_32k":
            got = jax.tree.leaves(tapi.cache_shapes(name),
                                  is_leaf=lambda x: hasattr(x, "dtype"))
            want = jax.tree.leaves(japi.cache_shapes(name))
            assert [tuple(s.shape) for s in got] == [s.shape for s in want]
    tapi = TApi(tconfigs.get_reduced(arch))
    params = tapi.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {}
    for key, spec in tapi.input_specs("train_4k").items():
        shape = (2, 8) + tuple(spec.shape[2:])
        if spec.dtype == torch.int32:
            batch[key] = torch.tensor(rng.integers(
                0, tapi.cfg.vocab_size, shape).astype(np.int32))
        else:
            width = shape[:2] + (tapi.cfg.d_model,)
            batch[key] = torch.tensor(rng.normal(size=width)
                                      .astype(np.float32))
    total, metrics = tapi.loss(params, batch)
    assert total.dtype == torch.float32 and bool(torch.isfinite(total))
    assert float(metrics["ntokens"]) == 16


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_tokens_match_the_reference(arch):
    """Greedy ``serve`` on the reference's key-0 parameters: the same
    seeded inputs (prompts, embeddings or frames) and the same tokens."""
    jcfg, tcfg, _, tp = _pair(arch, seed=0)
    want, _, _ = jserve.serve(jcfg, 2, 8, 4)
    got, t_pre, t_dec = tserve.serve(tcfg, 2, 8, 4, device="cpu", params=tp)
    assert got.shape == (2, 4) and t_pre > 0 and t_dec > 0
    np.testing.assert_array_equal(got, want)
