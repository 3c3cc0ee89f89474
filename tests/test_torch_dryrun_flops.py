"""The dry run's FLOP count against the reference's products: the port's
``FlopCounterMode`` count on ``meta`` tensors (``launch/dryrun.py``'s
counter) equals 2 M N K summed over every ``dot_general`` of
``jax.make_jaxpr`` of the reference's step (a ``scan`` body counted times
its length, every nested jaxpr followed), exactly, for the train step
(loss and gradient), the prefill and one decode step of all ten arch ids
at ``get_reduced`` (float32; B 2, S 32, 8 decoder tokens for the
enc-dec, decode on a 32-entry cache, 16 for the enc-dec's self cache).

What made the two differ, and what was done:

- zamba2-2.7b and xlstm-125m's training (9,437,184 and 9,764,864 FLOPs
  fewer in the port): the reference's ``chunked_gla`` forms its four
  products batched over every chunk, so its backward also forms the first
  chunk's product against the zero initial state and the last chunk's
  summary of a final state that nothing reads; the port's loop over chunks
  skipped both. A batched product cannot drop one chunk's part, so XLA
  computes them too: the port now batches as the reference does
  (``models/ssm.py chunked_gla``), and the difference is gone.
- xlstm-125m (32,768 more in the reference after that): the reference's
  sLSTM ``lax.scan`` differentiates its carry at every step, step 0's
  zero state included (one recurrent product a layer); autograd pruned
  the gradient of a constant. The port's zero state now enters autograd as
  a function of the input (``ssm._ZeroCarry``), and the products agree.
- seamless-m4t-medium's training (262,144 more in the port): the
  cross-attention projected the decoder stream to k and v and dropped
  them, two products a decoder layer that the reference's training jaxpr
  (its VJP drops what nothing reads) does not hold. The port no longer
  forms them (``attention.attn_apply``).
- seamless-m4t-medium's prefill: those two products a decoder layer are
  still in the reference's prefill jaxpr, and XLA removes them (its
  compiled prefill holds the port's products exactly:
  ``test_encdec_prefill_difference_is_what_xla_removes``). The difference
  is pinned at that size.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

B, S, S_DEC, POS = 2, 32, 8, 5
KINDS = ("train", "prefill", "decode")
ENCDEC = "seamless-m4t-medium"


def dot_flops(jaxpr) -> int:
    """2 M N K over every ``dot_general`` of ``jaxpr``; a ``scan`` body
    times its length, every other nested jaxpr once (a ``while`` or
    ``cond``, whose count is not known from the program, fails)."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name not in ("while", "cond"), name
        if name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(
                lhs[i] for i in contract)
            continue
        times = eqn.params["length"] if name == "scan" else 1
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (tuple, list))
                        else (value,)):
                if hasattr(sub, "eqns"):
                    total += times * dot_flops(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    total += times * dot_flops(sub.jaxpr)
    return total


_DEF = re.compile(r"^(?:ROOT )?%?([\w.\-]+) = \(?\w+\[([0-9,]*)\]")


def hlo_dot_flops(text: str) -> int:
    """2 M N K over every ``dot`` of optimized HLO text (operand shapes
    looked up by name; a while body would count once)."""
    shapes = {}
    for line in text.splitlines():
        m = _DEF.match(line.strip())
        if m:
            shapes[m[1]] = [int(d) for d in m[2].split(",") if d]
    total = 0
    for line in text.splitlines():
        line = line.strip()
        m = _DEF.match(line)
        if not m or " dot(" not in line:
            continue
        lhs = re.search(r" dot\(([^)]*)\)", line)[1].split(",")[0]
        lhs = shapes[lhs.strip().split(" ")[-1].lstrip("%")]
        contract = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line)[1]
        total += 2 * math.prod(shapes[m[1]]) * math.prod(
            lhs[int(i)] for i in contract.split(",") if i)
    return total


def batch(cfg, kind: str) -> dict:
    """Seeded numpy inputs of one step of ``kind``."""
    rng = np.random.default_rng(0)

    def toks(n):
        return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)

    if kind == "decode":
        return {"token": toks(1)[:, 0]}
    if cfg.is_encdec:
        out = {"embeds": rng.normal(size=(B, S, cfg.d_model))
               .astype(np.float32), "tokens": toks(S_DEC)}
        if kind == "train":
            out["labels"] = toks(S_DEC)
        return out
    out = ({"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)}
           if cfg.frontend == "embed" else {"tokens": toks(S)})
    if kind == "train":
        out["labels"] = toks(S)
    return out


def meta(arrays: dict, cfg) -> dict:
    return {k: torch.empty(v.shape, device="meta", dtype=torch.int32
                           if v.dtype == np.int32 else cfg.compute_dtype)
            for k, v in arrays.items()}


def counts(arch: str, kind: str, **overrides):
    """(the reference's jaxpr count, the port's count on meta)."""
    jcfg = jconfigs.get_reduced(arch, **overrides)
    tcfg = tconfigs.get_reduced(arch, **overrides)
    japi, tapi = JApi(jcfg), TApi(tcfg)
    jp, tp = japi.abstract_params(), tapi.abstract_params()
    arrays = batch(jcfg, kind)
    tb = meta(arrays, tcfg)
    if kind == "train":
        jfn, args = jax.value_and_grad(lambda p, b: japi.loss(p, b)[0]), \
            (jp, arrays)

        def port():
            value_and_grad(tapi, tp, tb)
    elif kind == "prefill":
        jfn, args = (lambda p, b: japi.prefill(p, b)), (jp, arrays)

        def port():
            tapi.prefill(tp, tb)
    else:
        if jcfg.is_encdec:
            jcache = jencdec.cache_shapes(jcfg, B, 2 * S_DEC, S)
            tcache = [{k: torch.empty(v.shape[1:], dtype=v.dtype,
                                      device="meta")
                       for k, v in tencdec.cache_shapes(
                           tcfg, B, 2 * S_DEC, S).items()}
                      for _ in range(tcfg.superlayer_repeat)]
        else:
            jcache = jlm.cache_shapes(jcfg, B, S)
            tcache = tlm.init_caches(tcfg, B, S, device="meta")
        jfn = lambda p, c, b: japi.decode(p, c, POS, b)  # noqa: E731
        args = (jp, jcache, arrays)

        def port():
            tapi.decode(tp, tcache, POS, tb)
    ref = dot_flops(jax.make_jaxpr(jfn)(*args).jaxpr)
    with FlopCounterMode(display=False) as counter:
        port()
    return ref, int(counter.get_total_flops())


def dropped_cross_kv(cfg, rows: int, s_dec: int) -> int:
    """The enc-dec prefill products that only the reference's jaxpr holds:
    the decoder stream's k and v projections in each decoder layer's
    cross-attention, dropped for the encoder's."""
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    return cfg.superlayer_repeat * 2 * (2 * rows * s_dec * cfg.d_model * kv)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_flops_equal_the_reference_products(arch, kind):
    ref, port = counts(arch, kind)
    assert ref > 0
    if arch == ENCDEC and kind == "prefill":
        pinned = dropped_cross_kv(tconfigs.get_reduced(arch), B, S_DEC)
        assert pinned == 262144
        assert port == ref - pinned, (port, ref, pinned)
    else:
        assert port == ref, (port, ref, port - ref)


def test_encdec_prefill_difference_is_what_xla_removes():
    """The pinned seamless prefill difference is in the reference's jaxpr
    only: XLA's compiled prefill (one encoder and one decoder layer, so
    each scan body runs once) holds the port's products exactly."""
    over = dict(superlayer_repeat=1, n_enc_layers=1)
    ref, port = counts(ENCDEC, "prefill", **over)
    jcfg = jconfigs.get_reduced(ENCDEC, **over)
    japi = JApi(jcfg)
    compiled = jax.jit(lambda p, b: japi.prefill(p, b)).lower(
        japi.abstract_params(), batch(jcfg, "prefill")).compile()
    assert hlo_dot_flops(compiled.as_text()) == port
    assert ref - port == dropped_cross_kv(jcfg, B, S_DEC) == 131072
