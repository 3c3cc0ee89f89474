"""The port stands alone: no module of ``src/repro_torch``, nor
``chip_smoke.py``, the torch examples or the profiling tools, imports JAX
or the reference package, and importing the engine leaves JAX unloaded."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "enriched_pipeline_torch.py",
    ROOT / "examples" / "crime_alerts_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "tools" / "profile_main_path.py",
    ROOT / "tools" / "trace_cell.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or module.startswith("flax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_itself():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.engine")
    assert not _forbidden("repro_torch.core.engine")
    assert not _forbidden("torch")


def test_engine_import_leaves_jax_unloaded():
    code = ("import sys; import repro_torch.core.engine, "
            "repro_torch.kernels.predicate_filter.ops, "
            "repro_torch.kernels.spatial_match.ops, repro_torch.core.interop, "
            "repro_torch.kernels.join_compact.ops, repro_torch.core.enrich, "
            "repro_torch.launch.serve, repro_torch.kernels.flash_decode.ops, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.core.runtime, repro_torch.core.churn, "
            "repro_torch.core.planner, repro_torch.launch.plan_search, "
            "repro_torch.configs.bad_default, repro_torch.core.sharded, "
            "repro_torch.distributed.collectives, "
            "repro_torch.distributed.partition, repro_torch.launch.train, "
            "repro_torch.launch.steps, repro_torch.optim, "
            "repro_torch.ckpt.manager, repro_torch.runtime.failure, "
            "repro_torch.data.synthetic, repro_torch.tree, "
            "repro_torch.launch.mesh, repro_torch.distributed.compression, "
            "repro_torch.distributed.pipeline, "
            "repro_torch.distributed.param_specs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
