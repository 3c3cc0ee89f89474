"""Port parity for the mesh and the spec half of the partition module
(``repro_torch/launch/mesh.py``, ``repro_torch/distributed/partition.py``)
against the reference's ``launch/mesh.py`` and ``distributed/partition.py``:
the cases of ``tests/test_distributed.py`` (``sanitize_spec`` with its
``FakeMesh``, ``make_rules``' ``seq_shard`` / ``ws_decode``, ``shard``) on
both packages; ``NamedSharding.devices_indices_map`` against JAX's on
conftest's 4 host devices, the reference's devices mapped to their mesh
positions; placement and gathering bit for bit; and the elastic restore of
``tests/test_substrate.py`` onto a mesh, on both packages."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.ckpt.manager import CheckpointManager as JCheckpointManager  # noqa
from repro.distributed import partition as jpart  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.steps import default_optimizer  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

P = tpart.P
CPU = torch.device("cpu")


class FakeMesh:
    shape = {"data": 4, "model": 2}


def _both(spec):
    return JP(*spec), P(*spec)


def test_sanitize_spec_divisibility_on_both():
    jm = jmesh.make_mesh((1, 1), ("data", "model"))
    tm = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    for spec, shape, want in (((("pod", "data"), "model"), (8, 8),
                               ("data", "model")),
                              (("data", None), (7, 3), ("data", None)),
                              (("data", None, "model"), (4, 4),
                               ("data", None))):
        js, ts = _both(spec)
        assert jpart.sanitize_spec(js, shape, jm) == JP(*want)
        assert tpart.sanitize_spec(ts, shape, tm) == P(*want)


def test_sanitize_spec_nondivisible_with_fake_mesh_on_both():
    for spec, shape, want in ((("data", "model"), (6, 6), (None, "model")),
                              ((("data", "model"), None), (8, 8),
                               (("data", "model"), None)),
                              ((("data", "model"),), (4,), ("data",)),
                              ((("model", "data"), "data"), (6, 4),
                               ("model", "data"))):
        js, ts = _both(spec)
        got = tpart.sanitize_spec(ts, shape, FakeMesh)
        assert tuple(jpart.sanitize_spec(js, shape, FakeMesh)) == \
            tuple(got) == want
        assert isinstance(got, tpart.PartitionSpec)


@pytest.mark.parametrize("axes", (("data", "model"), ("pod", "data", "model"),
                                  ("pod",), ("data",)))
@pytest.mark.parametrize("seq_shard,ws_decode",
                         list(itertools.product((False, True), repeat=2)))
def test_make_rules_tables_match_reference(axes, seq_shard, ws_decode):
    shape = (1,) * len(axes)
    jr = jpart.make_rules(jmesh.make_mesh(shape, axes), seq_shard=seq_shard,
                          ws_decode=ws_decode)
    tm = tmesh.make_mesh(shape, axes, "cpu")
    tr = tpart.make_rules(tm, seq_shard=seq_shard, ws_decode=ws_decode)
    assert tr.batch_axes == jr.batch_axes
    assert tr.model_axis == jr.model_axis
    assert list(tr.table) == list(jr.table)
    for name, spec in jr.table.items():
        assert tuple(tr.spec(name)) == tuple(spec), name
    if "model" in axes:
        assert (tr.table["act_btd"] == tr.table["act_btd_sp"]) == seq_shard
    # the decode's sequence shards: the mesh's model axis, if any
    assert tr.model_devices == ([CPU] if "model" in axes else [])
    assert tr.sharding("kv_cache").mesh is tm


def test_rules_seq_shard_alias_on_host_mesh():
    r = tpart.make_rules(tmesh.make_host_mesh(devices=[CPU]), seq_shard=True)
    assert r.table["act_btd"] == r.table["act_btd_sp"]
    r2 = tpart.make_rules(tmesh.make_host_mesh(devices=[CPU]))
    assert r2.table["act_btd"] != r2.table["act_btd_sp"]


def test_shard_checks_the_name_and_returns_x():
    x = torch.ones((4, 4))
    assert tpart.shard(x, "act_btd") is x
    with tpart.use_rules(tpart.make_rules(tmesh.make_host_mesh(
            devices=[CPU]))):
        assert tpart.shard(x, "kv_cache") is x
    with pytest.raises(KeyError):
        tpart.shard(x, "act_nonesuch")
    assert jpart.shard(jnp.ones((4, 4)), "act_btd") is not None


def test_mesh_grid_and_errors():
    m = tmesh.make_mesh((2, 3), ("data", "model"),
                        [torch.device("cpu")] * 6)
    assert m.shape == {"data": 2, "model": 3} and list(m.shape) == [
        "data", "model"]
    assert m.size == 6 and m.axis_names == ("data", "model")
    assert m.positions() == list(itertools.product(range(2), range(3)))
    assert m.axis_devices("model") == [CPU] * 3
    with pytest.raises(ValueError, match="needs 6 devices"):
        tmesh.make_mesh((2, 3), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="axis names"):
        tmesh.make_mesh((2, 3), ("data",), "cpu")
    with pytest.raises(ValueError, match="model_parallel"):
        tmesh.make_host_mesh(3, devices=["cpu"] * 4)
    host = tmesh.make_host_mesh(2, devices=["cpu"] * 4)
    assert host.shape == {"data": 2, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_host_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh((2,), ("pod",))


SPECS = [(), (None,), ("data",), ("model",), (None, "data"),
         ("data", "model"), ("model", "data"), (("data", "model"),),
         (("model", "data"), None), (None, ("data", "model"))]


@pytest.mark.multidevice
@pytest.mark.parametrize("grid", ((4, 1), (2, 2)))
def test_devices_indices_map_matches_jax(multidevice, grid):
    jm = jmesh.make_mesh(grid, ("data", "model"))
    tm = tmesh.make_mesh(grid, ("data", "model"), ["cpu"] * 4)
    position = {d: tuple(int(i) for i in idx)
                for idx, d in np.ndenumerate(jm.devices)}
    held = 0
    for spec, shape in itertools.product(SPECS, ((8, 12), (4, 4, 2))):
        got = tpart.NamedSharding(tm, spec).devices_indices_map(shape)
        want = JNamedSharding(jm, JP(*spec)).devices_indices_map(shape)
        assert {position[d]: idx for d, idx in want.items()} == got, spec
        assert tpart.NamedSharding(tm, spec).shard_shape(shape) == \
            JNamedSharding(jm, JP(*spec)).shard_shape(shape)
        held += 1
    assert held == 2 * len(SPECS)


def test_named_sharding_refuses_what_jax_refuses():
    tm = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="unevenly"):
        tpart.NamedSharding(tm, P("model", "data")).devices_indices_map(
            (5, 3))
    with pytest.raises(ValueError, match="twice"):
        tpart.NamedSharding(tm, P("data", "data"))
    with pytest.raises(ValueError, match="not in the mesh"):
        tpart.NamedSharding(tm, P("pod"))


def test_rules_without_a_mesh_refuse_a_sharding():
    rules = tpart.Rules([torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="no mesh"):
        rules.sharding("act_btd")
    tm = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    got = tpart.make_rules(tm).sharding("act_btd")
    assert got.mesh is tm and got.spec == tpart.make_rules(tm).spec("act_btd")


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.int32))
def test_device_put_and_gather_bit_for_bit(dtype):
    tm = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((8, 6), generator=gen) * 100).to(dtype)
    for spec in (P("data", "model"), P(("model", "data")), P(None, "model"),
                 P()):
        st = tpart.device_put(x, tpart.NamedSharding(tm, spec))
        index = st.sharding.devices_indices_map(x.shape)
        assert set(st.blocks) == set(index) == set(tm.positions())
        for pos, idx in index.items():
            assert torch.equal(st.blocks[pos], x[idx])
            assert st.blocks[pos].data_ptr() != x.data_ptr()
        # one tensor for the positions that hold the same block
        assert len({b.data_ptr() for b in st.blocks.values()}) == len(
            {tuple((s.start, s.stop) for s in i) for i in index.values()})
        got = st.gather()
        assert got.dtype == dtype
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else dtype),
                           x.view(torch.int16 if dtype == torch.bfloat16
                                  else dtype))


def test_elastic_restore_new_sharding_on_both(tmp_path):
    """tests/test_substrate.py::test_elastic_restore_new_sharding on both
    packages: a (4, 4) leaf restored onto P("data", None) of a one-device
    mesh, and on the port also onto a (2, 2) mesh of one device."""
    jmgr = JCheckpointManager(str(tmp_path / "ref"), async_save=False)
    jtree = {"w": jnp.arange(16, dtype=jnp.float32).reshape(4, 4)}
    jmgr.save(1, jtree)
    jsh = {"w": JNamedSharding(jmesh.make_mesh((1,), ("data",)),
                               JP("data", None))}
    jgot = jmgr.restore(1, jtree, shardings=jsh)
    assert jgot["w"].sharding == jsh["w"]

    mgr = CheckpointManager(str(tmp_path / "port"), async_save=False)
    ttree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    mgr.save(1, ttree)
    for grid, axes in (((1,), ("data",)), ((2, 2), ("data", "model"))):
        mesh = tmesh.make_mesh(grid, axes, "cpu")
        sh = {"w": tpart.NamedSharding(mesh, P("data", None))}
        got = mgr.restore(1, ttree, shardings=sh)
        assert got["w"].sharding is sh["w"]
        np.testing.assert_array_equal(got["w"].gather().numpy(),
                                      np.asarray(jgot["w"]))
    with pytest.raises(ValueError, match="not both"):
        mgr.restore(1, ttree, device="cpu", shardings=sh)


def test_restore_params_and_adamw_state_on_a_mesh(tmp_path):
    """A reduced qwen2-1.5b's bf16 parameters and AdamW state saved, then
    restored with ``param_pspecs`` / ``state_pspecs`` shardings over a
    (2, 2) ("data", "model") mesh of one device: every 2-d weight in four
    blocks, every gathered leaf the saved one bit for bit."""
    cfg = tconfigs.get_reduced("qwen2-1.5b", param_dtype=torch.bfloat16)
    api = TApi(cfg)
    params = api.init(torch.Generator().manual_seed(3))
    opt = default_optimizer(cfg)
    state = opt.init(params)
    for m in tree.leaves(state.m):
        m.normal_(generator=torch.Generator().manual_seed(4))
    saved = {"params": params, "opt": state}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, saved)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    specs = {"params": api.param_pspecs(),
             "opt": opt.state_pspecs(api.param_pspecs())}
    shardings = tree.tree_map(
        lambda spec, x: tpart.NamedSharding(
            mesh, tpart.sanitize_spec(spec, x.shape, mesh)), specs, saved)
    got = mgr.restore(2, saved, shardings=shardings)
    four = 0
    for st, want in zip(tree.leaves(got), tree.leaves(saved)):
        assert isinstance(st, tpart.ShardedTensor)
        if want.dim() == 2:
            assert len({b.data_ptr() for b in st.blocks.values()}) == 4
            four += 1
        g = st.gather()
        assert g.dtype == want.dtype and g.shape == want.shape
        bits = torch.int16 if g.dtype == torch.bfloat16 else g.dtype
        assert torch.equal(g.view(bits), want.view(bits))
    # each 2-d parameter, and its m and v
    assert four == 3 * sum(p.dim() == 2 for p in tree.leaves(params))
