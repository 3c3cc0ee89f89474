"""The port's dry run (``repro_torch/launch/dryrun.py``, ``dryrun_all.py``,
``hillclimb.py``) against the reference's arithmetic, for all ten arch ids
x the four shapes x the two production meshes, on the ``meta`` device:

- the cell fields (counts, depth, the ``grad_accum`` clamp, the skip and
  its string) against the reference's ``ModelApi`` and ``run_cell``;
- ``memory.argument_bytes`` against the reference's sanitized-spec
  arithmetic on its own trees (``test_torch_param_specs.py``'s);
- the scaling identity: ``scale_totals`` of the cut step and the probes
  equals the count of the whole step at full depth over ``accum``
  microbatches, exactly, for every kind (train, prefill, decode under the
  production rules) on reduced configs of three superlayers. It holds for
  the MoE archs too because the whole step runs the same microbatches: a
  capacity rounds per microbatch, so one batch of ``global_batch`` rows
  would count other expert products;
- a ``meta`` tensor never builds or launches a kernel;
- the command lines in subprocesses, and ``parse_override`` against the
  reference's.

The FLOP count itself is held to the reference's products in
``test_torch_dryrun_flops.py``; one ``slow`` test runs the reference's own
dry-run subprocess (XLA on 512 host devices) beside the port's cell."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import param_specs as jpsp  # noqa: E402
from repro.launch.steps import default_optimizer as jdefault_optimizer  # noqa
from repro.models.model import SHAPES as JSHAPES  # noqa: E402
from repro.models.model import ModelApi as JApi  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.distributed.partition import (device_bytes, make_rules,  # noqa
                                               use_rules)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.launch.steps import default_optimizer  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

from test_torch_param_specs import (MESHES, _no_depth_in_reference,  # noqa
                                    ref_bytes, stacked_path)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE_NAMES = list(JSHAPES)
MESH_OF = {False: "16x16", True: "2x16x16"}


def reference_skip_reason() -> str:
    """The reference's skip string, read from its source (importing
    ``repro.launch.dryrun`` would set the 512-device XLA flag for this
    process's later subprocesses)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and ast.literal_eval(node.targets[0].slice) == "skip_reason"):
            return ast.literal_eval(node.value)
    raise AssertionError("no skip_reason in the reference's dryrun.py")


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cell_fields_match_reference(arch, multi_pod):
    """Every shape's cell fields against the reference's arithmetic: its
    ``ModelApi`` counts and depth, its mesh size, the ``accum`` clamp by
    the data-parallel width, and its skip."""
    japi = JApi(jconfigs.get_config(arch))
    cfg = japi.cfg
    size = 512 if multi_pod else 256
    reason = reference_skip_reason()
    assert dryrun.SKIP_REASON == reason
    for shape in SHAPE_NAMES:
        got, _ = dryrun.cell_fields(arch, shape, multi_pod)
        sh = JSHAPES[shape]
        accum = cfg.grad_accum if sh.kind == "train" else 1
        want = {"arch": arch, "shape": shape,
                "mesh": "pod2x16x16" if multi_pod else "pod16x16",
                "kind": sh.kind, "seq_len": sh.seq_len,
                "global_batch": sh.global_batch,
                "param_count": japi.param_count(),
                "active_param_count": japi.active_param_count(),
                "superlayer_repeat": cfg.superlayer_repeat,
                "blocks_per_superlayer": len(cfg.block_pattern),
                "grad_accum": accum, "n_enc_layers": cfg.n_enc_layers,
                "overrides": {}}
        if not japi.supports(shape):
            want.update(status="skipped", skip_reason=reason)
        else:
            if sh.kind == "train":
                want["grad_accum"] = max(1, min(
                    cfg.grad_accum, sh.global_batch // (size // 16)))
            want.update(
                seq_shard=bool(cfg.seq_shard_activations
                               and sh.kind in ("train", "prefill")),
                ws_decode=bool(cfg.weight_stationary_decode
                               and sh.kind == "decode"),
                decode_loop=cfg.decode_loop, devices=size)
        assert got == want, (shape, got, want)


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_argument_bytes_match_reference_arithmetic(arch, multi_pod):
    """Each supported shape's ``argument_bytes`` is its parts' sum, and
    each part the reference's sanitized-spec arithmetic on its own trees:
    parameters, the batch, the caches and the int32 ``pos``; the optimizer
    state too, but for Adafactor's per-layer copies (the shared column
    factor of a 1-d parameter, the (1,) ``m`` placeholder), counted on the
    port's tree as ``test_torch_param_specs.py`` holds them."""
    japi = JApi(jconfigs.get_config(arch))
    tapi = tmodel.ModelApi(tconfigs.get_config(arch))
    m = MESHES[MESH_OF[multi_pod]]
    jparams = japi.abstract_params()
    want_params = ref_bytes(japi.param_pspecs(), jparams, m)
    jopt = jdefault_optimizer(japi.cfg)
    jstate = jax.eval_shape(jopt.init, jparams)
    topt = default_optimizer(tapi.cfg)
    state = topt.init(tapi.abstract_params())
    specs = topt.state_pspecs(tapi.param_pspecs())
    paths = [p for p, _ in tree.leaves_with_path(state)]
    copies = [i for i, p in enumerate(paths)
              if stacked_path(p)[1] and _no_depth_in_reference(p)]
    want_state = ref_bytes(
        jopt.state_pspecs(japi.param_pspecs()), jstate, m,
        skip={stacked_path(paths[i])[0] for i in copies}) + device_bytes(
        [tree.leaves(state)[i] for i in copies],
        [tree.leaves(specs)[i] for i in copies], m)
    for shape in SHAPE_NAMES:
        if not japi.supports(shape):
            continue
        parts = dryrun.argument_parts(tapi, shape,
                                      make_production_mesh(multi_pod=multi_pod))
        batch = japi.input_specs(shape)
        want = {"params": want_params,
                "batch": ref_bytes(jpsp.batch_specs(batch), batch, m)}
        kind = JSHAPES[shape].kind
        if kind == "train":
            want["optimizer_state"] = want_state
        if kind == "decode":
            want["caches"] = ref_bytes(japi.cache_pspecs(shape),
                                       japi.cache_shapes(shape), m)
            want["pos"] = 4
        assert parts == want, (shape, parts, want)
    rec = dryrun.run_cell(arch, "decode_32k", multi_pod, skip_probes=True)
    assert rec["argument_parts"] == dryrun.argument_parts(
        tapi, "decode_32k", make_production_mesh(multi_pod=multi_pod))
    assert rec["full"]["memory"]["argument_bytes"] == sum(
        rec["argument_parts"].values())


SMALL = {"train_4k": tmodel.ShapeSpec("train_4k", "train", 32, 64),
         "prefill_32k": tmodel.ShapeSpec("prefill_32k", "prefill", 32, 4),
         "decode_32k": tmodel.ShapeSpec("decode_32k", "decode", 32, 4)}


@pytest.fixture
def small_cells(monkeypatch):
    """The dry run on reduced configs of three superlayers (three encoder
    layers) with ``grad_accum`` 4, at the small shapes of ``SMALL`` (train:
    64 rows, 4 microbatches of 16 over the 16 data positions), with a
    fresh memo of counts."""
    def small(arch):
        cfg = tconfigs.get_config(arch)
        return tconfigs.get_reduced(
            arch, superlayer_repeat=3, n_layers=3 * len(cfg.block_pattern),
            n_enc_layers=3 if cfg.is_encdec else 0, grad_accum=4)

    monkeypatch.setattr(dryrun, "get_config", small)
    monkeypatch.setattr(dryrun, "_FLOPS", {})
    for name, spec in SMALL.items():
        monkeypatch.setitem(tmodel.SHAPES, name, spec)
    return small


def whole_step_flops(api, shape: str, accum: int, rules) -> int:
    """The step at full depth, ``accum`` microbatches, on ``meta``."""
    sh = tmodel.SHAPES[shape]
    params = api.abstract_params()
    batch = {k: dryrun._meta(v) for k, v in api.input_specs(shape).items()}
    with FlopCounterMode(display=False) as counter, use_rules(rules):
        if sh.kind == "train":
            opt = default_optimizer(api.cfg)
            build_train_step(api, opt, accum=accum)(params, opt.init(params),
                                                    batch)
        elif sh.kind == "prefill":
            api.prefill(params, batch)
        else:
            caches = [tree.tree_map(dryrun._meta, c)
                      for c in api.layer_cache_shapes(shape)]
            pos = dryrun._decode_pos(api.cfg, caches[0])
            api.decode(params, caches, pos, batch)
    return int(counter.get_total_flops())


@pytest.mark.parametrize("shape", list(SMALL))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_scale_totals_equal_the_whole_step(small_cells, arch, shape):
    rec = dryrun.run_cell(arch, shape, False)
    api = tmodel.ModelApi(small_cells(arch))
    assert rec["superlayer_repeat"] == 3
    if rec["kind"] == "train":
        assert rec["grad_accum"] == 4
    rules = make_rules(make_production_mesh(),
                       seq_shard=rec["seq_shard"], ws_decode=rec["ws_decode"])
    want = whole_step_flops(api, shape, rec["grad_accum"], rules)
    assert rec["totals"]["flops_global"] == want
    assert rec["totals"]["flops"] == want / 256
    # the probes carry the depth: the cut step alone counts less
    assert rec["full"]["cost"]["flops_global"] < want


def test_meta_never_builds_or_launches(monkeypatch):
    """With the library's build and load made to raise, every wrapper entry
    on ``meta`` tensors returns its output's shape, and a whole cell of
    each kind completes; no launch is counted."""
    from repro_torch.core.predicates import Predicate, compile_conditions
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.join_compact import ops as jc
    from repro_torch.kernels.predicate_filter import ops as pf
    from repro_torch.kernels.spatial_match import ops as sm

    def refuse(*_, **__):
        raise AssertionError("a meta tensor reached the kernel library")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    modules = (fa, fd, jc, pf, sm)
    counters = ("LAUNCHES", "ROWS_LAUNCHES", "STACKED_LAUNCHES",
                "VECTOR_LAUNCHES")
    before = {(m.__name__, c): getattr(m, c) for m in modules
              for c in counters if hasattr(m, c)}

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, kv = meta(2, 4, 64, 16, dtype=torch.bfloat16), \
        meta(2, 2, 64, 16, dtype=torch.bfloat16)
    assert fa.flash_attention(q, kv, kv).shape == q.shape
    assert fa.flash_attention(q[:, :, :8], kv, kv, causal=False).shape == \
        (2, 4, 8, 16)
    q1, kv_len = q[:, :, 0], meta(2, dtype=torch.int32)
    assert fd.decode_attention(q1, kv, kv, kv_len).shape == q1.shape
    acc, mx, den = fd.decode_attention_partial(q1, kv, kv, kv_len)
    assert acc.shape == q1.shape and mx.shape == den.shape == (2, 4)
    conds = compile_conditions([[Predicate.parse(0, "==", 5)],
                                [Predicate.parse(1, ">", 2)]])
    fields = meta(100, 3, dtype=torch.int32)
    assert pf.predicate_filter(fields, conds).shape == (100, 2)
    assert pf.predicate_filter_rows(meta(2, 100, 3, dtype=torch.int32),
                                    conds).shape == (2, 100)
    assert sm.spatial_match(meta(10, 2), meta(7, 2), 1.5).shape == (10, 7)
    assert sm.spatial_match(meta(3, 10, 2), meta(3, 7, 2),
                            [1.0, 2.0, 3.0]).shape == (3, 10, 7)
    s, t = 6, 8
    i32 = torch.int32
    out = jc.join_pairs(meta(s, t, dtype=i32), meta(s, dtype=i32),
                        meta(s, t, dtype=i32), meta(s, t, dtype=i32),
                        meta(s, dtype=torch.bool), meta(s, dtype=i32), 4,
                        True)
    assert [o.shape for o in out] == [(s, t)] * 4
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert dryrun.run_cell("qwen2-1.5b", shape, False)["status"] == "ok"
    assert dryrun.run_cell("seamless-m4t-medium", "decode_32k",
                           True)["status"] == "ok"
    after = {(m.__name__, c): getattr(m, c) for m in modules
             for c in counters if hasattr(m, c)}
    assert after == before


def _run(*args, cwd=ROOT):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def test_dryrun_cli_writes_the_record(tmp_path):
    """The reference's subprocess cell (``tests/test_distributed.py``):
    xlstm-125m x decode_32k with ``--skip-probes``."""
    r = _run("repro_torch.launch.dryrun", "--arch", "xlstm-125m", "--shape",
             "decode_32k", "--skip-probes", "--out", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and "probe" not in rec
    assert rec["full"]["cost"]["flops_global"] > 0
    for key in ("output_bytes", "temp_bytes", "alias_bytes",
                "peak_estimate_bytes"):
        assert rec["full"]["memory"][key] is None
        assert f"memory.{key}" in rec["substitute"]
    assert rec["full"]["cost"]["bytes"] is None
    assert rec["full"]["collectives"] is None and \
        rec["full"]["compile_s"] is None
    assert rec["totals"]["collective_bytes"] is None
    assert {"cost.bytes", "collectives", "compile_s", "cost.flops",
            "memory.argument_bytes"} <= set(rec["substitute"])


def test_dryrun_all_resumes(tmp_path):
    args = ("repro_torch.launch.dryrun_all", "--out", str(tmp_path),
            "--archs", "xlstm-125m", "--shapes", "decode_32k", "--mesh",
            "pod")
    first = _run(*args)
    assert first.returncode == 0, first.stderr[-2000:]
    assert "OK" in first.stdout and "done; 0 failures" in first.stdout
    assert (tmp_path / "xlstm-125m__decode_32k__pod16x16.json").exists()
    again = _run(*args)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "skip (exists)" in again.stdout
    assert "done; 0 failures" in again.stdout


def test_hillclimb_cli(tmp_path):
    r = _run("repro_torch.launch.hillclimb", "--arch", "xlstm-125m",
             "--shape", "decode_32k", "--variant", "carry", "--set",
             "decode_loop=carry", "--out", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[carry]" in r.stdout and "null" not in r.stdout
    assert "peak" not in r.stdout and "coll/dev" not in r.stdout
    rec = json.loads((tmp_path / "xlstm-125m__decode_32k__pod16x16__carry"
                      ".json").read_text())
    assert rec["overrides"] == {"decode_loop": "carry"}
    assert "probe" in rec and rec["status"] == "ok"


def test_parse_override_matches_reference(monkeypatch):
    """Importing the reference's hillclimb sets its 512-device XLA flag in
    the environment; the flag is restored after the test."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import hillclimb as jhill
    from repro_torch.launch import hillclimb as thill
    for kv in ("decode_loop=carry", "remat=True", "remat=False",
               "grad_accum=8", "capacity_factor=1.5", "x=1e3", "name=a=b",
               "rope_theta=-2", "tag=", "flag=true"):
        got, want = thill.parse_override(kv), jhill.parse_override(kv)
        assert got == want and type(got[1]) is type(want[1]), (kv, got, want)


@pytest.mark.slow
def test_reference_subprocess_cell_beside_the_port(tmp_path):
    """The reference's own dry run (XLA, 512 host devices) of xlstm-125m x
    decode_32k beside the port's cell: the shared cell fields equal, and
    ``argument_bytes`` equal to XLA's but for ``pos``: jit drops an
    argument its program never reads (``keep_unused=False``), and xlstm's
    decode reads no position (no attention, no RoPE), so XLA's arguments
    leave out the 4 B the port counts."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "xlstm-125m",
         "--shape", "decode_32k", "--out", str(tmp_path), "--skip-probes"],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads((tmp_path / "xlstm-125m__decode_32k__pod16x16.json")
                     .read_text())
    port = dryrun.run_cell("xlstm-125m", "decode_32k", False,
                           skip_probes=True)
    shared = set(ref) & set(port) - {"full", "totals"}
    assert shared >= {"arch", "shape", "mesh", "kind", "param_count",
                      "grad_accum", "devices", "seq_shard", "status"}
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    xla = ref["full"]["memory"]["argument_bytes"]
    ours = port["full"]["memory"]["argument_bytes"]
    print(f"argument_bytes: port {ours:,.0f} B, XLA {xla:,.0f} B "
          f"(parts {port['argument_parts']})")
    assert ours - xla == port["argument_parts"]["pos"] == 4
