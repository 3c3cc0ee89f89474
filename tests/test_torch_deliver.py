"""The ``deliver`` kernel's dispatch on the CPU: ``broker.deliver_all`` runs the
plain version on ``cpu`` and ``meta`` tensors and counts no launch, and the launch
geometry (``vector_ok``, ``grid``) chooses the path the kernel expects. The
kernel itself is held to the plain version on the card
(``tests/test_torch_kernels_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import broker  # noqa: E402
from repro_torch.kernels.deliver import ops  # noqa: E402
from torch_delivery_cases import CASES, case  # noqa: E402

def _same(a, b, path=""):
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, tuple):
        for f, x, y in zip(getattr(a, "_fields", range(len(a))), a, b):
            _same(x, y, f"{path}.{f}")
    else:
        assert (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b)), path


@pytest.mark.parametrize("name", ["ringless-group", "ringless-identity",
                                  "caps-low", "ring-group", "ring-identity",
                                  "ring-past-the-spill"])
def test_deliver_all_runs_the_plain_version_on_the_cpu(name):
    """On CPU tensors ``broker.deliver_all`` returns what the plain version
    returns, and launches nothing; the launcher itself refuses them."""
    kw = dict(CASES)[name]
    before = (ops.LAUNCHES, ops.VECTOR_LAUNCHES, ops.SHAPE)
    want = broker.deliver_plain(**case(np.random.default_rng(1), **kw))
    _same(broker.deliver_all(**case(np.random.default_rng(1), **kw)), want,
          name)
    with pytest.raises(ValueError, match="CUDA"):
        ops.deliver(**case(np.random.default_rng(1), **kw))
    assert (ops.LAUNCHES, ops.VECTOR_LAUNCHES, ops.SHAPE) == before


@pytest.mark.parametrize("name", ["ringless-group", "ringless-identity",
                                  "ring-group", "wide-vector"])
def test_deliver_all_on_meta_gives_shapes_only(name):
    """On ``meta`` (the dry run's device) the plain version gives every
    output's shape and dtype, as on the CPU; nothing is built or counted."""
    kw = dict(CASES)[name]
    before = (ops.LAUNCHES, ops.SHAPE)
    got = broker.deliver_all(**case(np.random.default_rng(2), device="meta",
                                    **kw))
    want = broker.deliver_plain(**case(np.random.default_rng(2), **kw))
    flat_got, flat_want = _leaves(got), _leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.device.type == "meta"
        assert g.dtype == w.dtype and g.shape == w.shape
    assert (ops.LAUNCHES, ops.SHAPE) == before


def _leaves(t):
    if t is None:
        return []
    if isinstance(t, tuple):
        return [x for item in t for x in _leaves(item)]
    return [t]


@pytest.mark.parametrize("words,offset,want", [(10252, 0, True),
                                               (10252, 1, False),
                                               (13, 0, False),
                                               (2 ** 25, 0, True),
                                               (2 ** 25, 3, False),
                                               (4095, 0, False)])
def test_vector_ok_takes_aligned_rows_of_whole_quads(words, offset, want):
    """16-byte stores take a buffer whose rows are a whole number of int32
    quads and that starts on a 16-byte boundary: the param plan-group's
    10,252-word lines and notify's 2^25 words do; the spatial group's
    13-word lines and a view one element (4 B) into its storage do not."""
    buf = torch.zeros(2 * words + offset, dtype=torch.int32)
    t = buf[offset:].view(2, words)
    assert t.is_contiguous() and t.storage_offset() == offset
    assert ops.vector_ok([t], words) is want


@pytest.mark.parametrize("c,max_pairs,width,max_notify,vector", [
    (2, 131072, 10252, 2 ** 25, True),      # paper-1m, param plan-group
    (1, 131072, 13, 2 ** 25, False),        # paper-1m, spatial plan-group
    (2, 16384, 10252, 2 ** 23, True),       # trending-2lang
    (1, 16, 14, 64, False),
    (3, 7, 1024, 5, True),
    (1, 0, 9, 0, False),
])
def test_grid_covers_every_line_once(c, max_pairs, width, max_notify,
                                     vector):
    """The write kernel's grid: a line a block where the line has at least
    THREADS units (16-byte quads on the vector path, words off it), else
    THREADS // units lines a block, each on as many threads as it has
    units; the line blocks cover every line exactly; between 1 and
    FAN_BLOCKS fan blocks, one a 1,024 words of notify."""
    fan, line, threads, span, per_block = ops.grid(c, max_pairs, width,
                                                   max_notify, vector)
    units = width // ops.QUAD if vector else width
    assert threads == ops.THREADS
    assert span == min(units, ops.THREADS) and span * per_block <= threads
    assert per_block == (1 if units >= ops.THREADS else threads // units)
    lines = c * max_pairs
    assert line * per_block >= lines > (line - 1) * per_block
    assert 1 <= fan <= ops.FAN_BLOCKS
    assert fan == min(max(-(-c * max_notify // (4 * threads)), 1),
                      ops.FAN_BLOCKS)
    assert fan + line <= ops.MAX_BLOCKS


def test_the_engine_counts_no_launch_on_the_cpu():
    """A CPU engine's delivery (fused, every plan-group ring-aware, and the
    single-channel path, ring-less) runs the plain version: the kernel's
    count does not move."""
    from repro_torch.core.plans import ExecutionFlags
    from torch_delivery_cases import ingest, small_engine
    before = (ops.LAUNCHES, ops.SHAPE)
    eng, rng = small_engine("cpu", 3)
    for tick in range(2):
        ingest(eng, rng, 200, 1 + 300 * tick)
        reps = eng.execute_all(None, timed=False, deliver=True)
    assert sum(r.overflow.delivered_pairs for r in reps.values()) > 0
    ingest(eng, rng, 200, 700)
    rep = eng.execute_channel("TweetsAboutDrugs", ExecutionFlags(),
                              deliver=True)
    assert rep.overflow.delivered_pairs > 0
    assert (ops.LAUNCHES, ops.SHAPE) == before
