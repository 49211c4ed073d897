"""The quantized commit kernel's int8 tile table (``comms.WireGrid``
chunks, pieces, ``tile_segs`` and ``lseg``), on the CPU: every stored
element lies in exactly one run, every wire segment lies whole in exactly
one tile, the runs are disjoint and shorter than 8 values only where the
leaf forces it, the pieces cover the chunks in order, and each element's
``lseg`` names its own segment in its tile's list. Over the paper CNN's
layout, the kernel tests' layout and drawn layouts with 1×1, 3×3 and 7×7
conv leaves. Imports neither jax nor the reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hyp = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

from repro_torch.core import comms  # noqa: E402
from repro_torch.core.flat import FlatLayout  # noqa: E402

LAYOUT = FlatLayout([("b", (300,)), ("conv", (16, 8, 3, 3)), ("a", (6, 9)),
                     ("c", (3, 5, 2))], convs=["conv"])


def _paper_layout():
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.experiments import histo
    return FlatLayout.of_module(histo._model(PAPER_FULL))


def _slab_cuts(seg, shape):
    """Channel cuts of a conv leaf that no segment straddles: at c, no
    segment holds channels both below and from c."""
    o, i, h, w = shape
    per_ch = seg.reshape(o, i, h * w).transpose(1, 0, 2).reshape(i, -1)
    below = np.unique(per_ch[:1])
    cuts = [0]
    for c in range(1, i):
        if np.intersect1d(below, per_ch[c:]).size == 0:
            cuts.append(c)
        below = np.union1d(below, per_ch[c])
    return cuts + [i], per_ch


def _allows_runs_of_8(seg, shape):
    """Whether the leaf can be cut into slabs of whole segments, each of at
    most TILE_SEGS segments, whose runs (channels × H × W) are >= 8."""
    o, i, h, w = shape
    cuts, per_ch = _slab_cuts(seg, shape)
    a = 0
    slabs = []
    for b in cuts[1:]:
        if (b - a) * h * w >= 8 or b == i:
            slabs.append((a, b))
            a = b
    if len(slabs) > 1 and (slabs[-1][1] - slabs[-1][0]) * h * w < 8:
        slabs[-2:] = [(slabs[-2][0], i)]
    return all((b - a) * h * w >= 8 and len(np.unique(per_ch[a:b]))
               <= comms.TILE_SEGS for a, b in slabs)


def check_table(layout, block):
    grid = comms.wire_grid(layout, "int8", block)
    p = grid.size
    pieces, chunks = grid.pieces.numpy(), grid.chunks.numpy()
    tile_segs, lseg = grid.tile_segs.numpy(), grid.lseg.numpy()
    seg = grid.seg_id.numpy()
    assert np.array_equal(grid.seg32.numpy(), seg)
    assert chunks[-1, 1] == p
    lens = np.diff(chunks[:, 1])
    assert lens.min() >= 1 and lens.max() <= comms.TILE_CHUNK
    # the pieces cover the chunks once, each within its cap, in the order of
    # their first stored position
    assert (np.diff(chunks[pieces[:, 0], 0]) > 0).all()
    pieces = pieces[np.argsort(pieces[:, 0])]
    assert pieces[0, 0] == 0 and pieces[-1, 1] == len(lens)
    assert (pieces[1:, 0] == pieces[:-1, 1]).all()
    per = pieces[:, 1] - pieces[:, 0]
    assert per.min() >= 1 and per.max() <= comms.PIECE_CHUNKS
    # every stored index in exactly one chunk
    starts = chunks[:-1, 0]
    pos = np.repeat(starts - chunks[:-1, 1], lens) + np.arange(p)
    assert np.array_equal(np.sort(pos), np.arange(p))
    # tiles: the pieces that share a segment list; every segment whole in
    # exactly one tile, and each element's lseg names its segment in its
    # tile's list
    tile_of_piece = np.unique(pieces[:, 2], return_inverse=True)[1]
    tile_of_chunk = np.repeat(tile_of_piece, per)
    tile_of = np.empty(p, np.int64)
    tile_of[pos] = np.repeat(tile_of_chunk, lens)
    base = np.empty(p, np.int64)
    base[pos] = np.repeat(np.repeat(pieces[:, 2], per), lens)
    assert np.array_equal(tile_segs[base + lseg], seg)
    assert np.array_equal(np.sort(tile_segs), np.arange(seg.max() + 1))
    lo = np.full(seg.max() + 1, len(pieces))
    hi = np.full(seg.max() + 1, -1)
    np.minimum.at(lo, seg, tile_of)
    np.maximum.at(hi, seg, tile_of)
    assert (lo == hi).all()
    counts = np.bincount(lo)
    assert counts.max() == grid.max_segs <= comms.TILE_SEGS
    first = np.unique(pieces[:, 2], return_index=True)[1]
    assert np.array_equal(pieces[first, 3], counts)
    for t in range(len(counts)):      # each tile's list ascending
        lst = tile_segs[pieces[first[t], 2]:pieces[first[t], 2] + counts[t]]
        assert (np.diff(lst) > 0).all()
    # runs: chunks of one tile that touch, merged; disjoint by the above;
    # shorter than 8 values only where the leaf forces it
    same = (tile_of_chunk[1:] == tile_of_chunk[:-1]) & (
        starts[1:] == starts[:-1] + lens[:-1])
    run_id = np.concatenate([[0], np.cumsum(~same)])
    run_start = starts[np.concatenate([[True], ~same])]
    run_len = np.bincount(run_id, weights=lens).astype(np.int64)
    leaves = (sorted(layout.leaves, key=lambda lf: lf.offset)
              if isinstance(layout, FlatLayout) else [])
    forced = {}
    for s0, ln in zip(run_start[run_len < 8], run_len[run_len < 8]):
        if len(leaves) == 0 or ln == p:
            continue
        hit = [lf for lf in leaves if lf.offset < s0 + ln
               and s0 < lf.offset + lf.size]
        if any(lf.size < 8 for lf in hit):
            continue
        assert len(hit) == 1 and len(hit[0].shape) == 4, \
            f"short run {s0}+{ln} in {[lf.path for lf in hit]}"
        lf = hit[0]
        if lf.path not in forced:
            forced[lf.path] = not _allows_runs_of_8(
                seg[lf.offset:lf.offset + lf.size], lf.shape)
        assert forced[lf.path], \
            f"short run {s0}+{ln} in {lf.path} {lf.shape}, which allows 8"
    return grid, run_len


def test_tile_table_of_the_paper_cnn():
    grid, run_len = check_table(_paper_layout(), 512)
    # 1,639,705 values in long runs: the four 3x3 convs whose segments
    # straddle every channel cut are one run each, the 1x1 convs' slabs
    # merge into runs of at least 32
    assert run_len.min() >= 8
    assert (grid.lseg.numpy().max() < comms.TILE_SEGS)


@pytest.mark.parametrize("layout,block", [(LAYOUT, 128), (LAYOUT, 256),
                                          (1000, 128), (180, 512)],
                         ids=["layout-128", "layout-256", "1000", "zoo-180"])
def test_tile_table_of_small_layouts(layout, block):
    check_table(layout, block)


def test_bf16_and_f32_grids_carry_no_tile_table():
    for wire in ("bf16", "f32"):
        grid = comms.wire_grid(LAYOUT, wire, 128)
        assert grid.pieces is None and grid.lseg is None
        assert grid.seg32 is None and grid.max_segs == 0


@st.composite
def layouts(draw):
    leaves = []
    for i in range(draw(st.integers(1, 4))):
        if draw(st.booleans()):
            k = draw(st.sampled_from([1, 3, 7]))
            shape = (draw(st.integers(1, 40)), draw(st.integers(1, 40)), k, k)
        else:
            shape = (draw(st.integers(1, 700)),)
        leaves.append((f"l{i}", shape))
    return (FlatLayout(leaves, convs=[p for p, s in leaves if len(s) == 4]),
            draw(st.sampled_from([128, 256, 512])))


@hyp.settings(max_examples=25, deadline=None, database=None,
              derandomize=True)
@hyp.given(layouts())
def test_tile_table_of_drawn_layouts(case):
    layout, block = case
    check_table(layout, block)
