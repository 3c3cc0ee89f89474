"""Port parity for the fused tick on a rebuild engine
(``incremental=False``: the stacked caches take the compacted ``build()``
layout): every scan mode x layout x backend, as tests/test_torch_fused.py
does for the incremental engine."""
import pytest

pytest.importorskip("torch")

from torch_engine_pairs import check_every_scan_layout_backend  # noqa: E402


def test_every_scan_layout_backend_rebuild_engine():
    check_every_scan_layout_backend(incremental=False)
