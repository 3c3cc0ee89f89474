"""Shared helpers for the port's parity tests (tests/test_torch_*.py): exact
comparison of reference (JAX) and port (PyTorch) outputs, dtype included,
and the fixture that decides at run time whether a CUDA card is present."""
import dataclasses

import numpy as np
import pytest


def to_np(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(ref, port, name="") -> None:
    """Exact equality of values, shape and dtype."""
    a, b = to_np(ref), to_np(port)
    assert a.dtype == b.dtype, f"{name}: dtype {a.dtype} (ref) != {b.dtype}"
    assert a.shape == b.shape, f"{name}: shape {a.shape} (ref) != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=str(name))


def assert_same_tuple(ref, port, name="") -> None:
    """Field-by-field ``assert_same`` over two NamedTuples of arrays."""
    assert ref._fields == port._fields, (ref._fields, port._fields)
    for field, a, b in zip(ref._fields, ref, port):
        assert_same(a, b, f"{name}.{field}")


def stats_tuple(stats) -> tuple:
    """A DeliveryStats of either package as a plain tuple."""
    return dataclasses.astuple(stats)


@pytest.fixture
def cuda_device():
    """The CUDA device for card-only tests; skips when there is none. The
    decision is taken here, at run time, so every worker collects the same
    tests."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is compared with its plain "
                    "version on the card)")
    return torch.device("cuda", 0)


@pytest.fixture
def one_thread():
    """One intra-op torch thread for the test: reduced models are many
    small ops, which run as fast on one thread and do not then contend
    with the suite's other workers. Test modules opt in with an autouse
    fixture that requests it."""
    torch = pytest.importorskip("torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
