"""Port parity for the dry run's one-superlayer probes
(``repro_torch/launch/probes.py``) against the reference's
(``repro/launch/probes.py``), for all ten arch ids where each probe
applies, at ``get_reduced`` (float32), with the reference's initialised
parameters carried across by ``interop.params_from_numpy`` (a layer's tree
is the port's ``params["layers"][0]``, the reference's stacked leaves
sliced at 0) and the same seeded numpy activations.

Tolerances, as ``test_torch_train_loss.py``'s: every gradient leaf (the
port's ``torch.autograd.grad`` against ``jax.grad``) within 1e-4 relative
L2; every forward output and state leaf within 1e-5 relative L2 (float32
products summed in another order). The SSM families run 16 tokens, under
the 128 tokens a chunk at which the reference's ``chunked_gla``
overflows (ROADMAP Queue 3). The decode probes run on the states their
prefill probes left, at position 16 of a 24-entry cache."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import probes as jprobes  # noqa: E402
from repro.models.layers import rope_frequencies as jrope  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import probes as tprobes  # noqa: E402
from repro_torch.models.layers import rope_frequencies as trope  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

from torch_parity import one_thread  # noqa: E402,F401

GRAD_REL_L2 = 1e-4
OUT_REL_L2 = 1e-5
B, S, MAX_LEN, FRAMES = 2, 16, 24, 24
DECODERS = [a for a in tconfigs.ARCH_IDS if a != "seamless-m4t-medium"]
ENCDEC = "seamless-m4t-medium"


@pytest.fixture(autouse=True)
def _one_thread(one_thread):
    """Every test here on one intra-op thread (``torch_parity.one_thread``)."""


def pair(arch: str, seed: int = 1):
    """(reference api, port api, reference params, port params)."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jp = JApi(jcfg).init(jax.random.key(seed))
    return JApi(jcfg), TApi(tcfg), jp, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def first(jtree):
    """The reference's stacked layer tree at depth 0."""
    return jax.tree.map(lambda x: x[0], jtree)


def flat(node, path=()):
    """{path: numpy array} of a tree of dicts, lists and tuples whose
    leaves are JAX arrays or torch tensors."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(flat(v, path + (k,)))
        return out
    if isinstance(node, (list, tuple)):
        out = {}
        for i, v in enumerate(node):
            out.update(flat(v, path + (i,)))
        return out
    if node is None:
        return {}
    if hasattr(node, "detach"):
        return {path: node.detach().cpu().numpy()}
    return {path: np.asarray(node)}


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    diff = np.linalg.norm((np.asarray(got, np.float64)
                           - np.asarray(want, np.float64)).ravel())
    norm = np.linalg.norm(np.asarray(want, np.float64).ravel())
    return diff / norm if norm else diff


def close(port, ref, limit: float) -> int:
    """Every leaf of ``port`` within ``limit`` relative L2 of ``ref``'s, the
    same paths, shapes and dtypes; returns the number of leaves held."""
    got, want = flat(port), flat(ref)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape,
                                                          w.shape)
        assert rel_l2(g, w) <= limit, (path, rel_l2(g, w))
    return len(want)


def acts(rng, *shape) -> np.ndarray:
    return rng.normal(size=shape).astype(np.float32)


def tables(cfg, length: int):
    """(reference cos, sin), (port cos, sin) at ``length`` positions."""
    hd = cfg.resolved_head_dim
    return (jrope(hd, length, cfg.rope_theta),
            trope(hd, length, cfg.rope_theta, "cpu"))


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("arch", DECODERS)
def test_train_probe_matches_reference(arch):
    """grad through one superlayer (remat as configured, and on): the
    (layer, [shared,] x) gradients."""
    japi, tapi, jp, tp = pair(arch)
    rng = np.random.default_rng(3)
    x = acts(rng, B, S, japi.cfg.d_model)
    (jc, js), (tc, ts) = tables(japi.cfg, S)
    shared = jp.get("shared")
    want = jprobes.train_body_fn(japi)(first(jp["layers"]), shared,
                                       jnp.asarray(x), jc, js)
    got = tprobes.train_body_fn(tapi)(tp["layers"][0], tp.get("shared"),
                                      t(x), tc, ts)
    assert len(got) == (3 if shared is not None else 2)
    assert close(got, want, GRAD_REL_L2) == len(flat(want))
    # under remat (the published configs' setting) the recompute changes
    # no gradient
    remat = TApi(dataclasses.replace(tapi.cfg, remat=True))
    close(tprobes.train_body_fn(remat)(tp["layers"][0], tp.get("shared"),
                                       t(x), tc, ts), want, GRAD_REL_L2)


def test_encdec_train_probes_match_reference():
    japi, tapi, jp, tp = pair(ENCDEC)
    rng = np.random.default_rng(4)
    d = japi.cfg.d_model
    x_enc, x_dec, eo = acts(rng, B, FRAMES, d), acts(rng, B, S, d), \
        acts(rng, B, FRAMES, d)
    (jce, jse), (tce, tse) = tables(japi.cfg, FRAMES)
    (jcd, jsd), (tcd, tsd) = tables(japi.cfg, S)
    jenc, jdec = jprobes.encdec_train_bodies(japi)
    tenc, tdec = tprobes.encdec_train_bodies(tapi)
    close(tenc(tp["enc_layers"][0], t(x_enc), tce, tse),
          jenc(first(jp["enc_layers"]), jnp.asarray(x_enc), jce, jse),
          GRAD_REL_L2)
    close(tdec(tp["dec_layers"][0], t(x_dec), t(eo), tcd, tsd),
          jdec(first(jp["dec_layers"]), jnp.asarray(x_dec), jnp.asarray(eo),
               jcd, jsd), GRAD_REL_L2)


def prefill_pair(arch):
    japi, tapi, jp, tp = pair(arch)
    rng = np.random.default_rng(5)
    x = acts(rng, B, S, japi.cfg.d_model)
    (jc, js), (tc, ts) = tables(japi.cfg, S)
    want = jprobes.prefill_body_fn(japi, MAX_LEN)(
        first(jp["layers"]), jp.get("shared"), jnp.asarray(x), jc, js)
    got = tprobes.prefill_body_fn(tapi, MAX_LEN)(
        tp["layers"][0], tp.get("shared"), t(x), tc, ts)
    return (japi, tapi, jp, tp), want, got


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_probes_match_reference(arch):
    """The prefill probe's output and states; then the decode probe on
    those states (each package's own), its output and updated states."""
    (japi, tapi, jp, tp), want, got = prefill_pair(arch)
    close(got, want, OUT_REL_L2)
    rng = np.random.default_rng(6)
    x = acts(rng, B, japi.cfg.d_model)
    (jc, js), (tc, ts) = tables(japi.cfg, MAX_LEN)
    pos = S
    jout = jprobes.decode_body_fn(japi)(
        first(jp["layers"]), jp.get("shared"), jnp.asarray(x), want[1], jc,
        js, jnp.asarray(pos, jnp.int32), jnp.full((B,), pos + 1, jnp.int32))
    tout = tprobes.decode_body_fn(tapi)(
        tp["layers"][0], tp.get("shared"), t(x), got[1], tc, ts, pos,
        torch.full((B,), pos + 1, dtype=torch.int32))
    close(tout, jout, OUT_REL_L2)


def test_encdec_prefill_probes_match_reference():
    japi, tapi, jp, tp = pair(ENCDEC)
    rng = np.random.default_rng(7)
    d = japi.cfg.d_model
    x_enc, x_dec, eo = acts(rng, B, FRAMES, d), acts(rng, B, S, d), \
        acts(rng, B, FRAMES, d)
    (jce, jse), (tce, tse) = tables(japi.cfg, FRAMES)
    (jcd, jsd), (tcd, tsd) = tables(japi.cfg, S)
    jenc, jdec = jprobes.encdec_prefill_bodies(japi)
    tenc, tdec = tprobes.encdec_prefill_bodies(tapi)
    close(tenc(tp["enc_layers"][0], t(x_enc), tce, tse),
          jenc(first(jp["enc_layers"]), jnp.asarray(x_enc), jce, jse),
          OUT_REL_L2)
    close(tdec(tp["dec_layers"][0], t(x_dec), t(eo), tcd, tsd),
          jdec(first(jp["dec_layers"]), jnp.asarray(x_dec), jnp.asarray(eo),
               jcd, jsd), OUT_REL_L2)


def test_encdec_decode_probe_matches_reference():
    """One decoder layer's decode step on a seeded cache ({k, v} of
    ``MAX_LEN``, {ck, cv} of ``FRAMES``): the output and the new self K/V
    (the port writes the cache in place and returns it)."""
    japi, tapi, jp, tp = pair(ENCDEC)
    cfg = japi.cfg
    rng = np.random.default_rng(8)
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = {"k": acts(rng, B, kh, MAX_LEN, hd),
             "v": acts(rng, B, kh, MAX_LEN, hd),
             "ck": acts(rng, B, kh, FRAMES, hd),
             "cv": acts(rng, B, kh, FRAMES, hd)}
    x = acts(rng, B, cfg.d_model)
    (jc, js), (tc, ts) = tables(cfg, MAX_LEN)
    pos = S
    want = jprobes.encdec_dec_decode_body(japi)(
        first(jp["dec_layers"]), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(pos, jnp.int32), jnp.full((B,), pos + 1, jnp.int32),
        jnp.full((B,), FRAMES, jnp.int32), jc, js)
    got = tprobes.encdec_dec_decode_body(tapi)(
        tp["dec_layers"][0], t(x), {k: t(v) for k, v in cache.items()}, pos,
        torch.full((B,), pos + 1, dtype=torch.int32),
        torch.full((B,), FRAMES, dtype=torch.int32), tc, ts)
    close(got, want, OUT_REL_L2)


def test_train_probe_reads_no_caller_tensor_for_writing():
    """The gradient is taken over detached copies: the caller's layer
    tree and activations come back untouched and without a graph."""
    _, tapi, _, tp = pair("qwen2-1.5b")
    layer = tp["layers"][0]
    before = [p.clone() for p in tree.leaves(layer)]
    x = torch.randn(B, S, tapi.cfg.d_model)
    (_, _), (tc, ts) = tables(tapi.cfg, S)
    grads = tprobes.train_body_fn(tapi)(layer, None, x, tc, ts)
    assert all(torch.equal(a, b) for a, b in zip(before, tree.leaves(layer)))
    assert not x.requires_grad and all(
        not p.requires_grad for p in tree.leaves(layer))
    assert all(g.grad_fn is None for g in tree.leaves(grads))
