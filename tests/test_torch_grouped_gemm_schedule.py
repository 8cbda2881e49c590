"""The bf16 grouped expert GEMM's tile schedule and launch shape, on the
CPU: `kernel.tile_schedule` (the order in which the persistent kernel of
`csrc/moe_grouped_gemm.cu` walks its tiles, written in PyTorch) and
`kernel.launch_shape` (its tile and grid for (R, E, N)).

For every case: each routed (row, column) is covered by exactly one
tile, an expert with no rows gets no tile, the row tiles of one (expert,
n-tile) are numbered next to each other, no tile reaches past
offsets[E], and the grid never exceeds the SMs nor the tiles there can
be.  Cases: deepseek-v2's prefill (49,152 rows over 160 experts), every
row on one expert, empty experts, R no multiple of the 128-row tile, the
`tail` form (rows past offsets[E] belong to no expert), and a
`hypothesis` property over random group sizes.  The card tests
(`tests/test_torch_cuda_kernels.py`) hold `launch_shape` to the
library's own and the kernel to its plain version.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.moe import kernel as GK

SMS = 132  # an H100's SMs


def _offsets(counts):
    return [0] + np.cumsum(counts).tolist()


def _check(offsets, n, glu, rows=None, tail=False):
    """The schedule of `offsets` for both launches' tiles against the
    properties above; returns the tiles."""
    r = offsets[-1] if rows is None else rows
    bm, bn, grid = GK.launch_shape(r, len(offsets) - 1, n, glu, SMS)
    tiles = GK.tile_schedule(torch.tensor(offsets, dtype=torch.int32), bm,
                             bn, n, tail=tail, rows=rows)
    e, r0, live, c0 = tiles.unbind(1)
    lo = torch.tensor(offsets[:-1])[e]
    hi = torch.tensor(offsets[1:])[e]
    # each tile lies inside its expert's rows (never past offsets[E]) and
    # inside [0, N), and has a live row
    assert bool(((r0 >= lo) & (r0 + live <= hi) & (live >= 1)
                 & (live <= bm)).all())
    assert bool(((c0 >= 0) & (c0 < n) & (c0 % bn == 0)).all())
    assert bool((r0 + live <= offsets[-1]).all())
    # every routed (row, column) exactly once: per n-tile, the tiles' row
    # ranges partition [0, offsets[E]) (row ranges are checked without
    # building the [R, N] grid: sorted, they must chain end to start)
    nt = -(-n // bn)
    for j in range(nt):
        sel = c0 == j * bn
        starts, order = torch.sort(r0[sel])
        ends = (r0[sel] + live[sel])[order]
        if len(starts):
            assert int(starts[0]) == offsets[0]
            assert int(ends[-1]) == offsets[-1]
            assert torch.equal(starts[1:], ends[:-1])
        else:
            assert offsets[0] == offsets[-1]
    # an empty expert gets no tile; an expert with rows gets
    # ceil(rows / bm) x nt of them
    counts = np.diff(offsets)
    per_e = torch.bincount(e, minlength=len(counts)).numpy()
    assert (per_e == -(-counts // bm) * nt).all()
    # experts in order; the row tiles of one (expert, n-tile) consecutive,
    # rising
    key = e * nt + c0 // bn
    assert bool((key[1:] >= key[:-1]).all())
    same = key[1:] == key[:-1]
    assert bool((r0[1:][same] == r0[:-1][same] + bm).all())
    # the grid: no more blocks than SMs or than tiles there can be, and
    # enough for every tile to be walked
    assert 0 < grid <= SMS or (grid == 0 and r == 0)
    assert len(tiles) <= (r + min(len(counts), r) * (bm - 1)) // bm * nt
    return tiles


@pytest.mark.parametrize("glu,n", [(True, 1536), (False, 5120)])
def test_prefill_uniform(glu, n):
    """deepseek-v2's prefill: 49,152 rows over 160 experts, ~307 each
    (three row tiles), gate / up (N 1536) and down (N 5120)."""
    rng = np.random.default_rng(0)
    counts = np.bincount(rng.integers(0, 160, 49152), minlength=160)
    tiles = _check(_offsets(counts), n, glu)
    assert len(tiles) == (-(-counts // 128)).sum() * -(-n // (
        128 if glu else 256))


@pytest.mark.parametrize("glu,n", [(True, 1536), (False, 5120)])
def test_one_expert(glu, n):
    counts = np.zeros(160, dtype=np.int64)
    counts[3] = 49152
    tiles = _check(_offsets(counts), n, glu)
    assert bool((tiles[:, 0] == 3).all())
    assert len(tiles) == 384 * -(-n // (128 if glu else 256))


def test_empty_experts_and_ragged_rows():
    """Only the first and last experts have rows, R no multiple of 128,
    and groups of 1, 127, 128, 129 and 300 rows."""
    counts = np.zeros(160, dtype=np.int64)
    counts[0], counts[-1] = 24000, 25095
    tiles = _check(_offsets(counts), 1536, True)
    assert set(tiles[:, 0].tolist()) == {0, 159}
    _check(_offsets([1, 0, 127, 128, 0, 129, 300]), 264, False)
    _check(_offsets([0, 0, 0]), 64, True)  # no rows: no tile


def test_tail_form():
    """The expert-parallel launch: 40 local experts, offsets[E] < R; no
    tile reaches a tail row; without `tail` such offsets are refused, as
    the kernel traps on them."""
    rng = np.random.default_rng(1)
    counts = np.bincount(rng.integers(0, 40, 761), minlength=40)
    off = _offsets(counts)
    _check(off, 1536, True, rows=3120, tail=True)
    _check(off, 5120, False, rows=3120, tail=True)
    with pytest.raises(ValueError, match="offsets"):
        GK.tile_schedule(off, 128, 128, 1536, rows=3120)


def test_launch_shape_decode_and_chunk():
    """A decode step's 8 rows give at most 8 row tiles: a grid of 8 x
    n-tiles where that is under the SMs; a prefill fills every SM."""
    assert GK.launch_shape(8, 160, 1536, True, SMS) == (128, 128, 96)
    assert GK.launch_shape(8, 128, 5120, False, SMS) == (128, 256, 132)
    assert GK.launch_shape(49152, 160, 1536, True, SMS)[2] == SMS
    assert GK.launch_shape(0, 160, 1536, True, SMS)[2] == 0


@settings(max_examples=60, deadline=None, derandomize=True)
@given(counts=st.lists(st.integers(0, 700), min_size=1, max_size=48),
       n=st.sampled_from([8, 200, 264, 1536, 5120]), glu=st.booleans(),
       tail_rows=st.integers(0, 300))
def test_schedule_property(counts, n, glu, tail_rows):
    off = _offsets(counts)
    _check(off, n, glu)
    _check(off, n, glu, rows=off[-1] + tail_rows, tail=True)
