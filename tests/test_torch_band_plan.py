"""The tiling plan of the port's preprocess kernels, on the CPU.

Both CUDA kernels (csrc/band_resample.cuh) trust `fp.band_plan`: a block
stages `stage_rows` source rows for its `tile_rows` output rows, and keeps
at most `taps_y` / `taps_x` weights for each output row and column. These
tests hold the plan against the resample matrices it stands in for, for
every param row the wrappers are given (identity, augment with flips and
crops at both ends of the slack, upsampling, Make3D's depth grid): every
nonzero of the reference's triangle matrix (the JAX package's and the
port's) lies in the band `fp.band_bounds` gives, each band has no more taps
than the plan keeps, and the staged rows of every tile, the last and
ragged one included, cover its rows' bands and fit the plan.
"""

import numpy as np
import pytest
import torch

from ann3depth_tpu.ops.resize import triangle_matrix as jax_triangle_matrix
from ann3depth_tpu_torch.ops import fused_preprocess as fp
from ann3depth_tpu_torch.ops.resize import triangle_matrix

# (flip, crop, crop offset on both axes) of augment draws: the crop window
# at both ends of the slack, with and without a flip.
DRAWS = [(False, False, 0.5), (False, True, 0.0), (False, True, 1.0),
         (True, False, 0.5), (True, True, 0.0), (True, True, 1.0)]

SHAPES = {  # (in_hw, out_hw, channels)
    "train": ((480, 640), (240, 320), 3),
    "ragged": ((61, 83), (27, 32), 3),
    "upsample": ((24, 32), (40, 56), 3),
    "depth": ((305, 55), (120, 160), 1),
    "eval_depth": ((30, 22), (15, 11), 1),
}


def _params(kind, in_hw, out_hw):
    """[B, 8] rows: one identity row, or one augment row for each draw."""
    if kind == "identity":
        return fp.identity_params(1, in_hw, out_hw)
    b = len(DRAWS)
    full = lambda i: torch.tensor([d[i] for d in DRAWS])  # noqa: E731
    draw = dict(flip=full(0), crop=full(1), oy=full(2).float(),
                ox=full(2).float(), brightness=torch.zeros(b),
                contrast=torch.ones(b))
    return fp.params_from_draw(draw, in_hw, out_hw)


def _tile_stage(lo, hi, tile_rows):
    """The kernel's staged rows of each tile: (first row, row count) over
    the tile's nonempty bands, [..., tiles] each."""
    firsts, counts = [], []
    for o0 in range(0, lo.shape[-1], tile_rows):
        l, h = lo[..., o0:o0 + tile_rows], hi[..., o0:o0 + tile_rows]
        empty = h < l
        first = torch.where(empty, torch.iinfo(torch.int64).max, l).amin(-1)
        end = torch.where(empty, -1, h).amax(-1)
        firsts.append(first)
        counts.append(torch.clamp(end - first + 1, min=0))
    return torch.stack(firsts, -1), torch.stack(counts, -1)


@pytest.mark.parametrize("kind", ["identity", "augment"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bands_cover_every_nonzero_and_fit_the_plan(shape, kind):
    in_hw, out_hw, c = SHAPES[shape]
    params = _params(kind, in_hw, out_hw)
    g = fp.geometry_of(params)
    plan = fp.band_plan((params.shape[0], *in_hw, c), out_hw)
    for axis, (n_out, n_in, start, scale, taps) in enumerate((
            (out_hw[0], in_hw[0], g["y_start"], g["y_scale"], plan.taps_y),
            (out_hw[1], in_hw[1], g["x_start"], g["x_scale"], plan.taps_x))):
        lo, hi = fp.band_bounds(n_out, n_in, start, scale)
        assert int((hi - lo + 1).max()) <= taps, axis
        i = torch.arange(n_in)
        inside = (i >= lo[..., None]) & (i <= hi[..., None])
        port = triangle_matrix(n_out, n_in, start, scale)
        ref = np.stack([np.asarray(jax_triangle_matrix(
            n_out, n_in, float(s0), float(s1)))
            for s0, s1 in zip(start, scale)])
        for m in (port.numpy(), ref):
            assert not (m != 0)[~inside.numpy()].any(), axis


@pytest.mark.parametrize("tile_rows", [1, 4, 8, 16])
@pytest.mark.parametrize("kind", ["identity", "augment"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_staged_rows_cover_every_tile(shape, kind, tile_rows):
    in_hw, out_hw, c = SHAPES[shape]
    params = _params(kind, in_hw, out_hw)
    g = fp.geometry_of(params)
    plan = fp.band_plan((params.shape[0], *in_hw, c), out_hw,
                        tile_rows=tile_rows)
    assert plan.tiles * plan.tile_rows >= out_hw[0]
    assert (plan.tiles - 1) * plan.tile_rows < out_hw[0]
    lo, hi = fp.band_bounds(out_hw[0], in_hw[0], g["y_start"], g["y_scale"])
    first, count = _tile_stage(lo, hi, plan.tile_rows)
    assert first.shape[-1] == plan.tiles
    assert int(count.max()) <= plan.stage_rows
    # Every row's band lies in its tile's staged rows, the last tile too.
    tile_of = torch.arange(out_hw[0]) // plan.tile_rows
    f, n = first[:, tile_of], count[:, tile_of]
    nonempty = hi >= lo
    assert bool((lo >= f)[nonempty].all())
    assert bool((hi < f + n)[nonempty].all())


def test_plan_at_the_main_path_shapes():
    """The plans the train step launches: u8 frames 480x640 -> 240x320 and
    the f32 laser grid 305x55 -> 120x160."""
    image = fp.band_plan((16, 480, 640, 3), (240, 320))
    assert (image.tile_rows, image.stage_rows, image.taps_y,
            image.taps_x, image.tiles) == (8, 19, 5, 5, 30)
    assert image.smem_bytes == 107_120 <= fp.SMEM_LIMIT
    depth = fp.band_plan((16, 305, 55, 1), (120, 160), itemsize=4,
                         depth_mode=True)
    assert (depth.tile_rows, depth.stage_rows, depth.taps_y,
            depth.taps_x, depth.tiles) == (8, 23, 6, 3, 15)
    assert depth.smem_bytes < 48 * 1024


def test_plan_shared_memory_mirrors_the_layout():
    """band_layout of band_resample.cuh: row weights and bands, column
    weights and bands, R (and Rv in depth mode), then the larger of the
    staged rows and the output tile, each rounded up to 16 bytes, 16 bytes
    of alignment room on the last."""
    plan = fp.band_plan((2, 61, 83, 3), (27, 32), tile_rows=4)
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    n = 83 * 3
    want = (a16(4 * plan.taps_y * 4) + 2 * a16(4 * 4)
            + a16(32 * plan.taps_x * 4) + 2 * a16(32 * 4) + a16(4 * n * 4)
            + a16(max(plan.stage_rows * n + 16, 4 * 32 * 3 * 4 + 16)))
    assert plan.smem_bytes == want
    depth = fp.band_plan((2, 61, 83, 1), (27, 32), tile_rows=4, itemsize=4,
                         depth_mode=True)
    assert depth.smem_bytes > fp.band_plan(
        (2, 61, 83, 1), (27, 32), tile_rows=4, itemsize=4).smem_bytes


def test_launch_plan_halves_the_tile_until_it_fits():
    plan = fp.launch_plan((16, 480, 640, 3), (240, 320), itemsize=4,
                          depth_mode=False, tile_rows=16)
    assert plan.tile_rows == 8 and plan.smem_bytes <= fp.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        fp.launch_plan((1, 8, 20000, 3), (4, 10000), itemsize=4,
                       depth_mode=False)


@pytest.mark.parametrize("n_in", [32, 64, 112, 128, 152, 256])
def test_taps_count_every_band_of_a_scale(n_in):
    """floor(2r + margin) + 1 taps hold every band of radius r (scale
    n_in / 64: 0.5 to 4), wherever src falls: a sweep of starts over one
    source pixel."""
    n_out = 64
    scale = n_in / n_out
    plan = fp.band_plan((1, n_in, n_in, 1), (n_out, n_out))
    starts = torch.linspace(0.0, 1.0, 257)
    lo, hi = fp.band_bounds(n_out, n_in, starts, torch.full((257,), scale))
    inner = (lo > 0) & (hi < n_in - 1)  # bands not clipped by the frame
    assert int((hi - lo + 1)[inner].max()) <= plan.taps_y
    assert int((hi - lo + 1)[inner].max()) == plan.taps_y or scale < 1
