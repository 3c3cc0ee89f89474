"""Port parity for the model substrate (``repro_torch/models``, ``configs``,
``launch/serve.py``) against the reference's, on reduced qwen2-1.5b in
float32 with the reference's initialised parameters carried across by
``interop.params_from_numpy`` (``jax.random`` cannot be reproduced in
torch). Tolerance 2e-5 on activations and logits (float32, products summed
in another order); the greedy tokens must be equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import (build_decode_step,  # noqa: E402
                                      build_prefill_step)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.kvcache import create_kv_cache, update_kv  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

TOL = 2e-5
ARCH = "qwen2-1.5b"


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _cfgs(**kw):
    return jconfigs.get_reduced(ARCH, **kw), tconfigs.get_reduced(ARCH, **kw)


def _params(jcfg, tcfg, seed=1):
    jp = JApi(jcfg).init(jax.random.key(seed))
    return jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a))


def test_configs_mirror_the_reference():
    """Every config equals the reference's field for field (dtypes by
    name), all ten ids; parameter counts agree."""
    assert tconfigs.ARCH_IDS == list(jconfigs.ARCH_IDS)
    for arch in tconfigs.ARCH_IDS:
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for f in dataclasses.fields(t):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if f.name.endswith("dtype"):
                a, b = np.dtype(a).name, str(b).split(".")[-1]
            assert a == b, (arch, f.name, a, b)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
    for arch in ("qwen2-1.5b", "tinyllama-1.1b"):
        assert TApi(tconfigs.get_config(arch)).param_count() == \
            JApi(jconfigs.get_config(arch)).param_count()
        assert TApi(tconfigs.get_reduced(arch)).param_count() == \
            JApi(jconfigs.get_reduced(arch)).param_count()


def test_layers(rng):
    """rms_norm (f32 inside, cast back), rope on split halves (with and
    without positions), the SwiGLU MLP."""
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(w)), jlayers.rms_norm(x, w))
    xb = torch.tensor(x).to(torch.bfloat16)
    got = tlayers.rms_norm(xb, _t(w))
    want = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)
    jc, js = jlayers.rope_frequencies(16, 40, 1e6)
    tc, ts = tlayers.rope_frequencies(16, 40, 1e6)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    q = rng.normal(size=(2, 4, 7, 16)).astype(np.float32)
    _close(tlayers.apply_rope(_t(q), tc, ts), jlayers.apply_rope(q, jc, js))
    pos = rng.integers(0, 40, (2, 4, 7))
    _close(tlayers.apply_rope(_t(q), tc, ts, _t(pos)),
           jlayers.apply_rope(q, jc, js, pos))
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
         (("gate", (64, 128)), ("up", (64, 128)), ("down", (128, 64)))}
    _close(tlayers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x),
                             torch.float32),
           jlayers.mlp_apply(p, x, jnp.float32))


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_attention_paths(rng, attn_impl):
    """attn_apply (causal and full), attn_prefill (output and K/V) and
    attn_decode (output and the in-place cache write) on the CPU, each
    branch as the reference takes it."""
    jcfg, tcfg = _cfgs(attn_impl=attn_impl)
    jp, tp = _params(jcfg, tcfg)
    ja, ta = jp["layers"]["b0"]["attn"], tp["layers"][0]["b0"]["attn"]
    ja = jax.tree.map(lambda a: a[0], ja)
    s = 12
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    jc, js = jlayers.rope_frequencies(16, s + 4, 1e6)
    tc, ts = tlayers.rope_frequencies(16, s + 4, 1e6)
    for causal in (True, False):
        _close(tattn.attn_apply(ta, _t(x), tcfg, tc, ts, causal=causal),
               jattn.attn_apply(ja, x, jcfg, jc, js, causal=causal))
    tout, tkv = tattn.attn_prefill(ta, _t(x), tcfg, tc, ts)
    jout, jkv = jattn.attn_prefill(ja, x, jcfg, jc, js)
    _close(tout, jout)
    _close(tkv["k"], jkv["k"])
    _close(tkv["v"], jkv["v"])
    cache_j = {n: jnp.pad(jkv[n], ((0, 0), (0, 0), (0, 4), (0, 0)))
               for n in ("k", "v")}
    cache_t = {n: torch.nn.functional.pad(tkv[n], (0, 0, 0, 4))
               for n in ("k", "v")}
    x1 = rng.normal(size=(2, 64)).astype(np.float32)
    kv_len = np.full((2,), s + 1, np.int32)
    jo, jcache = jattn.attn_decode(ja, x1, jcfg, jc, js, cache_j,
                                   jnp.asarray(s, jnp.int32), kv_len)
    k_before = cache_t["k"]
    to, tcache = tattn.attn_decode(ta, _t(x1), tcfg, tc, ts, cache_t, s,
                                   _t(kv_len))
    assert tcache["k"] is k_before            # written in place
    _close(to, jo)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


def test_chunked_sdpa_matches_reference(rng):
    """The long-prompt online-softmax path (S >= 8192 on the CPU), run
    directly at a small S over several chunks."""
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((1, 4, 2500, 16), (1, 2, 2500, 16),
                          (1, 2, 2500, 16)))
    for causal in (True, False):
        _close(tattn._chunked_sdpa(_t(q), _t(k), _t(v), causal),
               jattn._chunked_sdpa(q, k, v, causal))


def test_kvcache_update_in_place():
    cache = create_kv_cache(2, 1, 5, 16, torch.float32, device="cpu")
    k = torch.ones((2, 1, 1, 16))
    storage = cache["k"].data_ptr()
    out = update_kv(cache, k, 2 * k, 3)
    assert out is cache and cache["k"].data_ptr() == storage
    assert (cache["k"][:, :, 3] == 1).all() and (cache["v"][:, :, 3] == 2).all()
    assert cache["k"].sum() == 32


def test_forward_prefill_decode(rng):
    """lm.forward, prefill (logits and caches) and three decode steps
    against the reference, on the same parameters; then the port's decode
    equals its own teacher-forced forward (the reference's
    test_decode_matches_forward), through the step builders."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    B, S = 2, 16
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 3)).astype(np.int32)
    jfull, _ = jlm.forward(jp, jcfg, tokens=jnp.asarray(toks))
    tfull, aux = tlm.forward(tp, tcfg, tokens=_t(toks))
    assert tfull.shape == (B, S + 3, tcfg.padded_vocab) and float(aux) == 0
    _close(tfull, jfull)
    jlg, jc, jpos = jlm.prefill(jp, jcfg, tokens=jnp.asarray(toks[:, :S]),
                                max_len=S + 4)
    api = TApi(tcfg)
    tlg, tc, tpos = build_prefill_step(api)(tp, {"tokens": _t(toks[:, :S])})
    assert tpos == int(jpos) == S and tc[0]["b0"]["k"].shape[2] == S
    tlg, tc, tpos = api.prefill(tp, {"tokens": _t(toks[:, :S])},
                                max_len=S + 4)
    _close(tlg, jlg)
    for name in ("k", "v"):
        _close(torch.stack([c["b0"][name] for c in tc]), jc["b0"][name])
    shapes = tlm.cache_shapes(tcfg, B, S + 4)
    assert shapes["b0"]["k"].shape == jc["b0"]["k"].shape
    decode = build_decode_step(api)
    err = [float((tlg - tfull[:, S - 1, :tcfg.vocab_size]).abs().max())]
    for i in range(3):
        jlg, jc = jlm.decode_step(jp, jcfg, jc, jpos + i,
                                  token=jnp.asarray(toks[:, S + i]))
        tlg, tc = decode(tp, tc, tpos + i, {"token": _t(toks[:, S + i])})
        _close(tlg, jlg)
        err.append(float((tlg - tfull[:, S + i, :tcfg.vocab_size])
                         .abs().max()))
    assert max(err) < 5e-5, err
    zero = tlm.init_caches(tcfg, B, S + 4, device="cpu")
    assert len(zero) == tcfg.superlayer_repeat
    assert all(float(c["b0"]["k"].abs().sum()) == 0 for c in zero)


def test_serve_greedy_and_prefill_scores(rng):
    """Greedy serve on the reference's key-0 parameters gives the same
    tokens; prefill_scores (last position, first ``lanes`` columns) equals
    the reference's full-forward version."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg, seed=0)
    want, _, _ = jserve.serve(jcfg, 3, 8, 6)
    got, t_pre, t_dec = tserve.serve(tcfg, 3, 8, 6, device="cpu", params=tp)
    assert got.shape == (3, 6) and t_pre > 0 and t_dec > 0
    np.testing.assert_array_equal(got, want)
    jp, tp = _params(jcfg, tcfg, seed=3)
    toks = rng.integers(0, 256, (5, 10)).astype(np.int32)
    for lanes in (64, 7):
        s = tserve.prefill_scores(tp, tcfg, _t(toks), lanes=lanes)
        assert s.dtype == torch.float32 and s.shape == (5,)
        _close(s, jserve.prefill_scores(jp, jcfg, jnp.asarray(toks),
                                        lanes=lanes))
    own, _, _ = tserve.serve(tcfg, 2, 4, 3, device="cpu")
    assert own.shape == (2, 3)


def test_not_ported_families_raise():
    """Every family is ported, training included: each arch id builds its
    parameters (a reduced config, on the CPU) and its ModelApi, and
    ``loss`` gives a finite float32 loss on seeded inputs (its parity with
    the reference is test_torch_train_loss.py's); nothing raises any more,
    the partition specs included: one spec a parameter, no longer than its
    rank (test_torch_param_specs.py holds them to the reference)."""
    rng = np.random.default_rng(0)
    for arch in tconfigs.ARCH_IDS:
        api = TApi(tconfigs.get_reduced(arch))
        cfg = api.cfg
        params = api.init(torch.Generator().manual_seed(0))
        assert params["embed"].shape[0] == cfg.padded_vocab
        labels = _t(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
        batch = {"labels": labels}
        if cfg.frontend == "embed" or cfg.is_encdec:
            batch["embeds"] = _t(rng.normal(size=(2, 8, cfg.d_model))
                                 .astype(np.float32))
        if cfg.frontend == "token" or cfg.is_encdec:
            batch["tokens"] = labels
        total, metrics = api.loss(params, batch)
        assert total.dtype == torch.float32 and total.shape == ()
        assert bool(torch.isfinite(total))
        assert float(metrics["ntokens"]) == 16
        np.testing.assert_allclose(
            float(total), float(metrics["loss"]) + 0.01 * float(metrics["aux"]),
            rtol=1e-6)
        specs = tree.leaves(api.param_pspecs())
        leaves = tree.leaves(params)
        assert len(specs) == len(leaves)
        assert all(len(s) <= p.dim() for s, p in zip(specs, leaves))
