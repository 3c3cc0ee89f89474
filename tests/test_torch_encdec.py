"""Port parity for the encoder-decoder (``repro_torch/models/encdec.py``)
against the reference's ``repro/models/encdec.py``: reduced
seamless-m4t-medium in float32 with the reference's parameters carried
across by ``interop.params_from_numpy``. ``encode``, ``forward``,
``prefill`` (logits and the {k, v, ck, cv} caches) and three decode steps,
with an encoder of 24 frames under a decoder of 6 tokens (the cross
cache's ``enc_len`` differs from the decoder's length), then the cached
decode against the port's teacher-forced forward. Tolerance 2e-5 on
activations, logits and caches (float32, magnitude about 3, products
summed in another order); the cached decode within 5e-5 of the forward
(``tests/test_torch_models.py``'s bound: another path through the same
sums)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402

TOL = 2e-5
ARCH = "seamless-m4t-medium"
B, FRAMES, TGT = 2, 24, 6


def _close(got, want, atol=TOL):
    want = np.asarray(want)
    assert got.detach().numpy().dtype == want.dtype
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jp = JApi(jcfg).init(jax.random.key(4))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(B, FRAMES, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, TGT + 3)).astype(np.int32)
    return jcfg, tcfg, jp, tp, emb, toks


def test_params_carry_over(pair):
    jcfg, tcfg, jp, tp, _, _ = pair
    assert len(tp["enc_layers"]) == tcfg.n_enc_layers
    assert len(tp["dec_layers"]) == tcfg.superlayer_repeat
    np.testing.assert_array_equal(
        tp["dec_layers"][1]["cross_attn"]["wq"].numpy(),
        np.asarray(jp["dec_layers"]["cross_attn"]["wq"][1]))
    own = tencdec.init_params(tcfg, torch.Generator().manual_seed(0))
    assert own.keys() == tp.keys()
    assert own["dec_layers"][0].keys() == tp["dec_layers"][0].keys()


def test_encode_and_forward(pair):
    jcfg, tcfg, jp, tp, emb, toks = pair
    _close(tencdec.encode(tp, tcfg, torch.tensor(emb)),
           jencdec.encode(jp, jcfg, jnp.asarray(emb)))
    got = tencdec.forward(tp, tcfg, torch.tensor(emb), torch.tensor(toks))
    assert got.shape == (B, TGT + 3, tcfg.padded_vocab)
    _close(got, jencdec.forward(jp, jcfg, jnp.asarray(emb), jnp.asarray(toks)))


def test_prefill_decode_and_caches(pair):
    jcfg, tcfg, jp, tp, emb, toks = pair
    max_len = TGT + 4
    jl, jc, jpos = jencdec.prefill(jp, jcfg, jnp.asarray(emb),
                                   jnp.asarray(toks[:, :TGT]), max_len)
    tl, tc, tpos = tencdec.prefill(tp, tcfg, torch.tensor(emb),
                                   torch.tensor(toks[:, :TGT]), max_len)
    assert tpos == int(jpos) == TGT
    _close(tl, jl)

    def same_caches():
        for name in ("k", "v", "ck", "cv"):
            assert all(c[name].is_contiguous() for c in tc)
            _close(torch.stack([c[name] for c in tc]), jc[name])

    same_caches()
    assert tc[0]["ck"].shape[2] == FRAMES != tc[0]["k"].shape[2]
    shapes = tencdec.cache_shapes(tcfg, B, max_len, FRAMES)
    assert {n: tuple(s.shape) for n, s in shapes.items()} == \
        {n: tuple(jc[n].shape) for n in jc}
    full = tencdec.forward(tp, tcfg, torch.tensor(emb), torch.tensor(toks))
    ck_before = tc[0]["ck"].clone()
    for i in range(3):
        jl, jc = jencdec.decode_step(jp, jcfg, jc, jpos + i,
                                     jnp.asarray(toks[:, TGT + i]))
        tl, tc = tencdec.decode_step(tp, tcfg, tc, tpos + i,
                                     torch.tensor(toks[:, TGT + i]))
        _close(tl, jl)
        # the cached decode equals the teacher-forced forward
        np.testing.assert_allclose(tl.numpy(),
                                   full[:, TGT + i, :tcfg.vocab_size].numpy(),
                                   atol=5e-5, rtol=0)
    same_caches()
    assert torch.equal(tc[0]["ck"], ck_before)    # the encoder memory stays
