"""Port parity for the partition-spec trees (``repro_torch/distributed/
param_specs.py``, ``ModelApi.param_pspecs`` / ``cache_pspecs``,
``AdamW`` / ``Adafactor.state_pspecs``) against the reference's, for all
ten arch ids at their published configs, sanitized over the production
mesh shapes (16, 16) and (2, 16, 16) (the reference test's ``FakeMesh``:
``sanitize_spec`` reads only ``mesh.shape``), entry by entry.

The reference stacks each parameter of ``layers`` (``enc_layers``,
``dec_layers``) over the depth, and its caches too; the port keeps one leaf
a layer. A port leaf at ``(..., "layers", i, ...)`` is held against the
reference's leaf at the same path without ``i``: the reference's shape and
spec without their leading (scan) entry. The one leaf whose reference has
no depth entry is Adafactor's column factor of a 1-d parameter of
``layers``, a copy of the stack's shared (D,) factor in every layer: it is
held against that factor as it is. Per-device bytes are held against the
reference's arithmetic on its own trees."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import partition as jpart  # noqa: E402
from repro.distributed import param_specs as jpsp  # noqa: E402
from repro.launch.steps import default_optimizer as jdefault_optimizer  # noqa
from repro.models.model import SHAPES  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.distributed import param_specs as tpsp  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.steps import default_optimizer  # noqa: E402
from repro_torch.models.kvcache import TensorSpec  # noqa: E402
from repro_torch.models.model import ModelApi as TApi  # noqa: E402

LISTS = ("layers", "enc_layers", "dec_layers")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    return k


def ref_leaves(specs, shapes):
    """{path: (spec, shape)} of the reference's trees (paths as tuples of
    dict keys, NamedTuple fields and list indices)."""
    is_p = lambda x: isinstance(x, JP)  # noqa: E731
    spec_flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_p)[0]
    shape_flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out = {tuple(map(_key, p)): [s] for p, s in spec_flat}
    for p, leaf in shape_flat:
        out[tuple(map(_key, p))].append(tuple(leaf.shape))
    return {k: tuple(v) for k, v in out.items()}


def port_leaves(specs, shapes):
    """[(path, spec, shape)] of the port's trees, in order."""
    flat = list(tree.leaves_with_path(specs))
    leaves = tree.leaves(shapes)
    assert len(flat) == len(leaves)
    return [(p, s, tuple(x.shape)) for (p, s), x in zip(flat, leaves)]


def stacked_path(path):
    """The reference's path of a port leaf: a layer index dropped."""
    out, layered = [], False
    for i, k in enumerate(path):
        if isinstance(k, int) and i and path[i - 1] in LISTS:
            layered = True
            continue
        out.append(k)
    return tuple(out), layered


def compare(ref, port, mesh, same_rank_ok=lambda path: False):
    """Every port leaf against its reference leaf, sanitized entry by
    entry on the port's shape; returns how many were held."""
    held = 0
    for path, spec, shape in port:
        rpath, layered = stacked_path(path)
        rspec, rshape = ref[rpath]
        rspec = tuple(rspec)
        if layered and len(rshape) == len(shape) + 1:
            assert rshape[1:] == shape, (path, rshape, shape)
            assert rspec[:1] in ((), (None,)), (path, rspec)
            rspec = rspec[1:]
        else:
            assert not layered or same_rank_ok(path), (path, rshape, shape)
            assert rshape == shape, (path, rshape, shape)
        assert tuple(spec) == rspec, (path, spec, rspec)
        got = tuple(tpart.sanitize_spec(spec, shape, mesh))
        want = tuple(jpart.sanitize_spec(JP(*rspec), shape, mesh))
        assert got == want, (path, got, want)
        held += 1
    return held


def ref_bytes(specs, shapes, mesh, skip=()) -> int:
    """Per-device bytes by the reference's arithmetic on its trees,
    leaving out the leaves at the paths in ``skip``."""
    total = 0
    for path, (spec, shape) in ref_leaves(specs, shapes).items():
        if path in skip:
            continue
        san = tuple(jpart.sanitize_spec(spec, shape, mesh))
        parts = [math.prod(mesh.shape[a] for a in
                           ((e,) if isinstance(e, str) else (e or ())))
                 for e in san] + [1] * (len(shape) - len(san))
        total += math.prod(d // n for d, n in zip(shape, parts)) * \
            _itemsize(shapes, path)
    return total


def _itemsize(shapes, path) -> int:
    node = shapes
    for k in path:
        node = getattr(node, k) if isinstance(k, str) and hasattr(
            node, "_fields") else node[k]
    return np.dtype(node.dtype).itemsize


def pair(arch):
    return JApi(jconfigs.get_config(arch)), TApi(tconfigs.get_config(arch))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    japi, tapi = pair(arch)
    m = MESHES[mesh]
    ref = ref_leaves(japi.param_pspecs(), japi.abstract_params())
    params = tapi.abstract_params()
    port = port_leaves(tapi.param_pspecs(), params)
    assert compare(ref, port, m) == len(port)
    # every reference leaf is some port leaf's
    assert {stacked_path(p)[0] for p, _, _ in port} == set(ref)
    assert tpart.device_bytes(tree.leaves(params),
                              tree.leaves(tapi.param_pspecs()), m) == \
        ref_bytes(japi.param_pspecs(), japi.abstract_params(), m)


def _adafactor_vcol_of_1d_layer(path):
    return path[0] == "v_col" and stacked_path(path)[1]


def _no_depth_in_reference(path):
    """Adafactor's per-layer leaves whose reference leaf has no depth
    entry: the column factor of a 1-d parameter, and the (1,) placeholder
    ``m`` of every parameter when ``b1 == 0``."""
    return _adafactor_vcol_of_1d_layer(path) or path[0] == "m"


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_optimizer_state_specs_match_reference(arch, mesh):
    japi, tapi = pair(arch)
    m = MESHES[mesh]
    jopt = jdefault_optimizer(japi.cfg)
    topt = default_optimizer(tapi.cfg)
    jstate = jax.eval_shape(jopt.init, japi.abstract_params())
    ref = ref_leaves(jopt.state_pspecs(japi.param_pspecs()), jstate)
    state = topt.init(tapi.abstract_params())
    specs = topt.state_pspecs(tapi.param_pspecs())
    port = port_leaves(specs, state)
    assert compare(ref, port, m, _no_depth_in_reference) == len(port)
    assert {stacked_path(p)[0] for p, _, _ in port} == set(ref)
    if tapi.cfg.optimizer == "adafactor":     # the trap is exercised
        assert any(_adafactor_vcol_of_1d_layer(p) and len(s) == 1
                   for p, s, _ in port)
        assert any(p[0] == "v_row" and s == () and stacked_path(p)[1]
                   for p, s, _ in port)
    # the same bytes, but for the per-layer leaves whose reference leaf
    # has no depth entry: those are copies here (a (1,) placeholder and the
    # shared column factor in every layer), held on their own
    copies = [i for i, (p, _, _) in enumerate(port)
              if stacked_path(p)[1] and _no_depth_in_reference(p)]
    flat = tree.leaves(state)
    flat_specs = tree.leaves(specs)
    rest = [i for i in range(len(flat)) if i not in set(copies)]
    assert tpart.device_bytes([flat[i] for i in rest],
                              [flat_specs[i] for i in rest], m) == \
        ref_bytes(jopt.state_pspecs(japi.param_pspecs()), jstate, m,
                  skip={stacked_path(port[i][0])[0] for i in copies})


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh):
    japi, tapi = pair(arch)
    m = MESHES[mesh]
    depth = tapi.cfg.superlayer_repeat
    for name in SHAPES:
        if not tapi.supports(name):
            continue
        jshapes = japi.cache_shapes(name)
        jspecs = japi.cache_pspecs(name)
        specs = tapi.cache_pspecs(name)
        shapes = tapi.layer_cache_shapes(name)
        assert len(specs) == depth
        # the port's list of layers against the reference's stacked leaves
        ref = ref_leaves(jspecs, jshapes)
        port = [(("layers",) + p, s, x) for p, s, x in
                port_leaves(specs, shapes)]
        ref = {("layers",) + k: v for k, v in ref.items()}
        assert compare(ref, port, m) == len(port) == depth * len(ref)
        assert tpart.device_bytes(tree.leaves(shapes), tree.leaves(specs),
                                  m) == ref_bytes(jspecs, jshapes, m)


def test_kv_cache_spec_decided_on_the_stacked_shape():
    """The trap of ``cache_specs.spec5``: the stacked (R, B, KH, S, hd)
    cache shards its sequence when S > KH, the stacked (R, B, H, dk, dv)
    GLA state its heads; decided per layer on (B, KH, S, hd) the indices
    would shift by one."""
    kv = TensorSpec((4, 8, 2, 64, 16), None)
    gla = TensorSpec((4, 8, 12, 8, 8), None)
    layer = {"kv": TensorSpec(kv.shape[1:], None),
             "gla": TensorSpec(gla.shape[1:], None)}
    specs = tpsp.cache_specs([dict(layer) for _ in range(4)])
    assert len(specs) == 4
    assert tuple(specs[3]["kv"]) == (tpsp.BATCH, None, "model", None)
    assert tuple(specs[3]["gla"]) == (tpsp.BATCH, "model", None, None)
    want = jpsp.cache_specs({"kv": jax.ShapeDtypeStruct(kv.shape, np.int8),
                             "gla": jax.ShapeDtypeStruct(gla.shape, np.int8)})
    assert tuple(want["kv"])[1:] == tuple(specs[0]["kv"])
    assert tuple(want["gla"])[1:] == tuple(specs[0]["gla"])


@pytest.mark.parametrize("arch", ("qwen2-1.5b", "pixtral-12b",
                                  "seamless-m4t-medium"))
def test_batch_specs_match_reference(arch):
    japi, tapi = pair(arch)
    for name in SHAPES:
        got = tpsp.batch_specs(tapi.input_specs(name))
        want = jpsp.batch_specs(japi.input_specs(name))
        assert list(got) == list(want)
        assert all(tuple(got[k]) == tuple(want[k]) for k in got)


def test_production_meshes_on_meta():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert {d.type for d in multi.devices.flat} == {"meta"}
    # the port's sanitize reads mesh.shape alone, like the fake one's
    for mesh, fake in ((single, MESHES["16x16"]), (multi, MESHES["2x16x16"])):
        for shape in ((6, 32), (64, 48), (2, 16)):
            got = tpart.sanitize_spec(tpart.P(tpsp.D, "model"), shape, mesh)
            want = jpart.sanitize_spec(JP(jpsp.D, "model"), shape, fake)
            assert tuple(got) == tuple(want)
    assert tuple(tpart.sanitize_spec(tpart.P(tpsp.D, "model"), (6, 32),
                                     multi)) == ("pod", "model")
