"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is allowed, ``repro`` is not), and
the reference loads nothing of the program."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
FILES = sorted((ROOT / "bad_bench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add((node.module or "").split(".")[0])
    assert not tops & FORBIDDEN


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    pytest.importorskip("torch")
    mods = ("bad_bench.run", "bad_bench.system", "bad_bench.check",
            "bad_bench.profiling", "bad_bench.control",
            "bad_bench.reference.reference", "repro_torch.core.engine",
            "repro_torch.kernels.join_compact.ops",
            "repro_torch.kernels.predicate_filter.ops") + tuple(
        f"bad_bench.metrics.{p.stem}" for p in
        (ROOT / "bad_bench" / "metrics").glob("*.py")
        if p.stem != "__init__")
    got = _loaded("import importlib\nfor m in %r: importlib.import_module(m)"
                  % (mods,))
    assert not got & FORBIDDEN, got & FORBIDDEN
    assert "repro_torch" in got


def test_the_reference_loads_nothing_of_the_program():
    pytest.importorskip("torch")
    got = _loaded("import bad_bench.reference.reference, bad_bench.check, "
                  "bad_bench.traffic, bad_bench.control")
    assert "repro_torch" not in got and not got & FORBIDDEN


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from bad_bench import run
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert run.forbidden_modules() == ["jax"]


SCORERS = sorted(p for p in (ROOT / "bad_bench" / "reference" / "scorers")
                 .glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("path", SCORERS, ids=lambda p: p.stem)
def test_each_plain_scorer_loads_nothing_of_the_program(path):
    """A plain scorer imports neither the program nor JAX, at its top or
    inside a function, and loading it loads neither."""
    pytest.importorskip("torch")
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add((node.module or "").split(".")[0])
    assert not tops & (FORBIDDEN | {"repro_torch"}), tops
    got = _loaded(f"import bad_bench.reference.scorers.{path.stem}")
    assert "repro_torch" not in got and not got & FORBIDDEN
