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
                                  "ring-past-the-spill", "every-line-live"])
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


def _walk(line, per_block, live):
    """The write kernel's line walk (csrc/deliver.cu ``line_blocks``) in
    Python: ``line`` blocks take ``per_block`` lines at a time from a
    counter (here in turn) over the live lines of every channel, flattened,
    until it passes them; the (channel, line) pairs written, in order."""
    total, seen, counter, blocks = sum(live), [], 0, line
    while blocks:
        for _ in range(blocks):
            first = counter * per_block
            counter += 1
            if first >= total:
                blocks -= 1
                continue
            for L in range(first, min(first + per_block, total)):
                c, base = 0, 0
                while L >= base + live[c]:
                    base += live[c]
                    c += 1
                seen.append((c, L - base))
    return seen


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
    units; LINE_BLOCKS_PER_SM line blocks an SM, fewer where the buffer
    holds fewer; between 1 and FAN_BLOCKS fan blocks, one a 1,024 words of
    notify. The walk over those blocks meets every live line of every
    channel exactly once and no other: none, some, every line live."""
    sms = 132
    fan, line, threads, span, per_block = ops.grid(c, max_pairs, width,
                                                   max_notify, vector, sms)
    units = width // ops.QUAD if vector else width
    assert threads == ops.THREADS
    assert span == min(units, ops.THREADS) and span * per_block <= threads
    assert per_block == (1 if units >= ops.THREADS else threads // units)
    lines = c * max_pairs
    assert line == min(-(-lines // per_block), sms * ops.LINE_BLOCKS_PER_SM)
    assert 1 <= fan <= ops.FAN_BLOCKS
    assert fan == min(max(-(-c * max_notify // (4 * threads)), 1),
                      ops.FAN_BLOCKS)
    assert fan + line <= ops.MAX_BLOCKS
    rng = np.random.default_rng(c * max_pairs + width)
    for live in ([0] * c, [max_pairs] * c,
                 list(rng.integers(0, min(max_pairs, 6000) + 1, c))):
        if not line:
            assert not any(live)
            continue
        seen = _walk(line, per_block, live)
        want = [(ch, q) for ch in range(c) for q in range(live[ch])]
        assert len(seen) == len(want) and set(seen) == set(want), live


@pytest.mark.parametrize("c,width,vector", [(2, 10252, True), (1, 13, False),
                                            (3, 52, True), (2, 14, False)])
def test_the_line_walk_does_not_grow_with_max_pairs(c, width, vector):
    """The write kernel's grid is sized to the card, not to the buffer:
    past the capacity at which its line blocks reach LINE_BLOCKS_PER_SM an
    SM, more wire lines add no block; a card of fewer SMs takes fewer."""
    shapes = [ops.grid(c, max_pairs, width, 2 ** 20, vector, 132)
              for max_pairs in (2 ** 17, 2 ** 20, 2 ** 22, 2 ** 24)]
    assert {s[1] for s in shapes} == {132 * ops.LINE_BLOCKS_PER_SM}
    assert len(set(shapes)) == 1
    assert ops.grid(c, 2 ** 24, width, 2 ** 20, vector, 66)[1] == \
        66 * ops.LINE_BLOCKS_PER_SM


@pytest.mark.parametrize("delivered", [(0, 0), (5, 0), (0, 7), (3, 8),
                                       (8, 8), (-1, 2)])
def test_clear_dead_lines_zeroes_only_the_lines_past_each_count(delivered):
    """The host copy of a card's wire buffer reads as the plain version's:
    each channel's lines past its delivered count become zeros (a negative
    count clears every line), the delivered lines keep every word."""
    rng = np.random.default_rng(sum(delivered) + 11)
    pay = rng.integers(1, 1 << 30, (2, 8, 6), dtype=np.int32)
    keep = pay.copy()
    got = broker.clear_dead_lines(pay, np.asarray(delivered, np.int32))
    assert got is pay
    for c, d in enumerate(delivered):
        d = max(d, 0)
        assert np.array_equal(pay[c, :d], keep[c, :d])
        assert not pay[c, d:].any()


def test_an_engine_reports_its_wire_lines_as_the_plain_version_does(
        monkeypatch):
    """With ``debug_delivery_buffers`` the engine's reports hold each
    channel's wire buffer: where delivery leaves the lines past a channel's
    count as they were (the card's kernel), the report still reads zeros
    there, equal to an engine whose delivery wrote them."""
    from repro_torch.core import engine as E
    from torch_delivery_cases import ingest, small_engine
    real = E.deliver_all

    def planted(*a, **k):
        got = real(*a, **k)
        pay = got.pack.payload
        for c, d in enumerate(got.pack.delivered.tolist()):
            pay[c, d:] = -0x5A5A5A5B
        return got

    reports = []
    for deliver in (real, planted):
        monkeypatch.setattr(E, "deliver_all", deliver)
        eng, rng = small_engine("cpu", 6)
        eng.debug_delivery_buffers = True
        for tick in range(2):
            ingest(eng, rng, 200, 1 + 300 * tick)
            reports.append(eng.execute_all(None, timed=False, deliver=True))
    live = 0
    for a, b in zip(reports[:2], reports[2:]):
        assert list(a) == list(b)
        for name in a:
            assert np.array_equal(a[name].payload, b[name].payload), name
            assert np.array_equal(a[name].notify, b[name].notify), name
            live += a[name].overflow.delivered_pairs
            assert not a[name].payload[a[name].overflow.delivered_pairs:].any()
    assert live > 0


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
