"""The torch quickstart prints what the reference quickstart prints, on the
same seed, with both run in-process at the quickstart's own small size."""
import importlib.util
import pathlib

import pytest

pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_prints_the_same_counts(capsys):
    _load("quickstart").main()
    want = capsys.readouterr().out
    _load("quickstart_torch").main(device="cpu")
    got = capsys.readouterr().out
    assert "subscribers notified" in want
    assert got == want
