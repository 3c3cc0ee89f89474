"""Port parity for ``repro_torch/distributed/collectives.py`` against the
reference's ``repro/distributed/collectives.py``: the cross-shard notify
shuffle bit for bit (against the reference's ``shard_map`` shuffle on 4
forced host devices and its host reference), the sequence-parallel decode
within 1e-5 in float32 (against the reference's under
``make_host_mesh(model_parallel=4)``), and one decode step of the reduced
model under ``use_rules`` within ``test_torch_models.py``'s 2e-5. The port's
shards are all ``cpu``: one process, four slices on one device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed.partition import make_rules  # noqa: E402
from repro.distributed.partition import use_rules as j_use_rules  # noqa: E402
from repro.kernels.flash_decode import ref as jfd_ref  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.interop import params_from_numpy  # noqa: E402
from repro_torch.distributed import collectives as tcoll  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402
from repro_torch.kernels.flash_decode import ref as tfd_ref  # noqa: E402
from repro_torch.launch.steps import build_decode_step  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

from torch_parity import assert_same  # noqa: E402

CPU4 = ["cpu"] * 4


def _random_buffers(rng, s, cap, num_shards):
    sids = rng.integers(0, 1000, (s, cap)).astype(np.int32)
    sids[rng.random((s, cap)) < 0.4] = -1
    owners = np.where(sids >= 0, rng.integers(0, num_shards, (s, cap)),
                      -1).astype(np.int32)
    return sids, owners


@pytest.mark.multidevice
def test_shuffle_notify_matches_reference(multidevice):
    """Five trials, as ``test_sharded.py::test_shuffle_notify_matches_ref``:
    the port's shuffle equals the reference's ``shard_map`` shuffle and both
    host references, dtype included; every routed sID is on its owner."""
    rng = np.random.default_rng(21)
    mesh = jcoll.notify_mesh(4)
    assert mesh is not None
    for trial in range(5):
        sids, owners = _random_buffers(rng, 4, 24, 4)
        got = tcoll.shuffle_notify(CPU4, torch.from_numpy(sids),
                                   torch.from_numpy(owners))
        want = np.asarray(jcoll.shuffle_notify(mesh, sids, owners))
        assert_same(want, got, f"trial {trial}")
        assert_same(jcoll.shuffle_notify_ref(sids, owners, 4),
                    tcoll.shuffle_notify_ref(sids, owners, 4))
        for o in range(4):
            row = got[o][got[o] >= 0].numpy()
            assert sorted(row.tolist()) == sorted(
                sids[(owners == o) & (sids >= 0)].tolist())


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
@pytest.mark.parametrize("devices", [["cpu"], CPU4])
def test_shuffle_notify_any_device_count(num_shards, devices):
    """Whatever the number of devices (one for all shards here), the
    shuffle runs on the shards' devices and gives the host reference's
    bits; the reference's own fallback branch gives the same."""
    rng = np.random.default_rng(num_shards)
    for cap in (1, 7, 64):
        sids, owners = _random_buffers(rng, num_shards, cap, num_shards)
        got = tcoll.shuffle_notify(devices[:num_shards],
                                   torch.from_numpy(sids),
                                   torch.from_numpy(owners))
        assert got.device.type == "cpu"
        assert_same(jcoll.shuffle_notify_ref(sids, owners, num_shards), got,
                    f"S={num_shards} cap={cap}")


def test_shuffle_notify_drops_dead_and_padded_slots():
    """Dead slots are dropped whatever owner they carry (the reference
    scatters them into its drop slot)."""
    sids = np.asarray([[5, -1, 7], [-1, 9, 11]], np.int32)
    owners = np.asarray([[1, 0, 0], [1, 1, 0]], np.int32)
    got = tcoll.shuffle_notify(["cpu"], torch.from_numpy(sids),
                               torch.from_numpy(owners))
    assert got.tolist() == [[7, 11, -1, -1, -1, -1],
                            [5, 9, -1, -1, -1, -1]]


def _decode_inputs(rng, b, h, kh, s, d, lens):
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, kh, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kh, s, d)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


@pytest.mark.multidevice
@pytest.mark.parametrize("lens", [[50, 9], [64, 16, 15, 1, 0, 17]])
def test_sp_decode_attention_matches_reference(multidevice, lens):
    """Four sequence slices of 16 keys: rows whose live keys end inside
    the first slice (slices 1-3 empty), at a slice boundary, or nowhere,
    against the reference's ``shard_map`` decode within 1e-5."""
    rng = np.random.default_rng(len(lens))
    q, k, v, kv_len = _decode_inputs(rng, len(lens), 4, 2, 64, 16, lens)
    mesh = make_host_mesh(model_parallel=4)
    want = jcoll.sp_decode_attention(make_rules(mesh), q, k, v, kv_len)
    rules = tpart.Rules(CPU4)
    got = tcoll.sp_decode_attention(rules, *map(torch.from_numpy,
                                                (q, k, v, kv_len)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    single = jfd_ref.decode_attention(q, k, v, kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(single), atol=1e-5,
                               rtol=0)
    if 0 in lens:
        assert not got[lens.index(0)].any()


def test_sp_decode_attention_without_model_axis_is_one_call():
    rng = np.random.default_rng(3)
    q, k, v, kv_len = map(torch.from_numpy, _decode_inputs(
        rng, 2, 4, 2, 30, 16, [30, 4]))
    want = tfd_ref.decode_attention(q, k, v, kv_len)
    for rules in (None, tpart.Rules()):
        assert torch.equal(tcoll.sp_decode_attention(rules, q, k, v, kv_len),
                           want)
    with pytest.raises(ValueError, match="does not split"):
        tcoll.sp_decode_attention(tpart.Rules(CPU4), q, k, v, kv_len)


@pytest.mark.multidevice
def test_decode_step_under_rules_matches_reference(multidevice, monkeypatch):
    """One decode step of reduced qwen2-1.5b under ``use_rules`` with a
    4-slice model axis (cache of 20 keys) against the reference's under
    ``make_host_mesh(model_parallel=4)``: logits and caches within 2e-5;
    every layer's attention went through ``sp_decode_attention``."""
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    tcfg = tconfigs.get_reduced("qwen2-1.5b")
    jp = JApi(jcfg).init(jax.random.key(1))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    B, S = 2, 16
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    _, jc, jpos = jlm.prefill(jp, jcfg, tokens=jnp.asarray(toks[:, :S]),
                              max_len=S + 4)
    api = TApi(tcfg)
    _, tc, tpos = api.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                              max_len=S + 4)
    calls = []
    real = tcoll.sp_decode_attention

    def counted(*a, **kw):
        calls.append(a[2].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tcoll, "sp_decode_attention", counted)
    mesh = make_host_mesh(model_parallel=4)
    with j_use_rules(make_rules(mesh)):
        jlg, jc = jlm.decode_step(jp, jcfg, jc, jpos,
                                  token=jnp.asarray(toks[:, S]))
    with tpart.use_rules(tpart.Rules(CPU4)):
        tlg, tc = build_decode_step(api)(
            tp, tc, tpos, {"token": torch.from_numpy(toks[:, S])})
    assert len(calls) == tcfg.superlayer_repeat, calls
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=2e-5,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            torch.stack([c["b0"][name] for c in tc]).numpy(),
            np.asarray(jc["b0"][name]), atol=2e-5, rtol=0)
