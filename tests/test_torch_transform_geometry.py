"""B1's and B5's launch geometry
(``repro_torch.kernels.sfc_transform.TransformGeometry``): what it asks of
the card, and that its blocks cover every (tile, channel) of the
transform once.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
to their plain versions at the per-layer geometry and at another, and
bit for bit across the two); here the geometry is checked as numbers, at
VGG-16's and MobileNetV2's layers at batch 1 and 4 and at ragged shapes of
every registered SFC algorithm.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import registry  # noqa: E402
from repro_torch.core import conv2d as c2d  # noqa: E402
from repro_torch.kernels.sfc_transform import (  # noqa: E402
    TRANSFORM_CHANNEL_BLOCKS, TRANSFORM_MAX_THREADS, TRANSFORM_MIN_THREADS,
    TRANSFORM_STATIC_SMEM_BYTES, transform_geometry)

SMEM_PER_BLOCK = 232448     # bytes of shared memory one H100 block may use
SMS = 132                   # the H100's SMs
# VGG-16's 13 convs at 224x224 as (H = W, C_in), the distinct shapes
VGG_LAYERS = ((224, 3), (224, 64), (112, 64), (112, 128), (56, 128),
              (56, 256), (28, 256), (28, 512), (14, 512))
# the stride-1 depthwise convs of MobileNetV2 at 224x224 and the repo's
# dw3x3, (H = W, C), as chip_smoke.py's DW_LAYERS
DW_LAYERS = ((112, 32), (56, 144), (28, 192), (14, 384), (14, 576),
             (7, 960), (28, 256))
SHAPES = [("sfc6_6", b, hw, hw, c, "SAME") for b in (1, 4)
          for hw, c in VGG_LAYERS + DW_LAYERS]
# ragged images, channel counts no multiple of any block, VALID
SHAPES += [(name, b, h, w, c, pad) for name in ("sfc4_4", "sfc6_6", "sfc6_7")
           for b, h, w, c, pad in ((2, 13, 11, 40, "SAME"),
                                   (1, 19, 7, 5, "VALID"),
                                   (3, 9, 30, 70, "SAME"))]
KNOBS = {"auto": {}, "alt": {"channel_block": 18, "tiles": 3, "splits": 3},
         "block24": {"channel_block": 24}, "one": {"tiles": 1, "splits": 1}}


def _ids(shape):
    return "-".join(map(str, shape))


def _geometry(name, b, h, w, c, padding, **knobs):
    algo = registry.get_algorithm(name)
    grid = c2d.tile_grid(h, w, algo.M, algo.R, padding)
    return transform_geometry(algo, (b * grid.nH, grid.nW), c, **knobs)


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_blocks_cover_every_tile_channel_and_row_once(shape, knobs):
    g = _geometry(*shape, **KNOBS[knobs])
    C = shape[4]
    gx, gy = g.grid
    done = set()
    for bx in range(gx):
        tiles = g.block_tiles(bx)
        assert 0 < len(tiles) <= g.tiles
        for by in range(gy):
            chans = range(by * g.cb, min(C, (by + 1) * g.cb))
            assert len(chans) > 0
            for tile in tiles:
                for ch in chans:
                    assert (tile, ch) not in done
                    done.add((tile, ch))
    assert len(done) == g.tile_rows * g.tile_cols * C
    assert {t for t, _ in done} == {(r, c) for r in range(g.tile_rows)
                                    for c in range(g.tile_cols)}
    # the splits threads of a (tile, channel) take each row once
    rows = [u for s in range(g.splits) for u in g.rows_of(s)]
    assert sorted(rows) == list(range(g.t))
    assert all(len(g.rows_of(s)) > 0 for s in range(g.splits))


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_geometry_fits_the_card(shape, knobs):
    g = _geometry(*shape, **KNOBS[knobs])
    # the kernel's static part: the mbarrier (its scales stay in L1)
    assert g.smem_bytes + TRANSFORM_STATIC_SMEM_BYTES <= SMEM_PER_BLOCK
    assert g.threads % 32 == 0 and g.threads <= TRANSFORM_MAX_THREADS
    assert g.threads >= g.splits * g.tiles * g.cb > g.threads - 32
    assert 1 <= g.splits <= g.t
    # a TMA box spans at most 256 elements a dimension
    assert g.region_w == g.M * (g.tiles - 1) + g.L <= 256
    assert g.grid[1] <= 65535
    assert g.smem_bytes >= 128 + 4 * g.L * g.region_w * g.cb
    assert g.launch_args() == (g.tiles, g.cb, g.splits, g.threads,
                               g.smem_bytes, *g.grid)


@pytest.mark.parametrize("hw,c", VGG_LAYERS + DW_LAYERS,
                         ids=[f"{hw}x{c}" for hw, c in VGG_LAYERS + DW_LAYERS])
def test_batch_1_fills_a_wave_where_the_layer_has_the_work(hw, c):
    # where the layer has SMS (tile, 16-channel) pairs, the per-layer
    # geometry launches at least one block per SM
    g = _geometry("sfc6_6", 1, hw, hw, c, "SAME")
    if g.tile_rows * g.tile_cols * -(-c // 16) >= SMS:
        assert g.blocks >= SMS
    assert g.cb in TRANSFORM_CHANNEL_BLOCKS or g.cb == c < 16
    # one tile a block unless the block would be too small without more
    one = g.splits * g.cb >= TRANSFORM_MIN_THREADS
    assert g.tiles == 1 if one else g.splits * g.tiles * g.cb \
        >= TRANSFORM_MIN_THREADS


def test_small_layers_get_more_threads_per_tile_than_large_ones():
    # (tile, channel) pairs: 4608 at 14x14x512 batch 1, 25600 at
    # 56x56x256, 46208 at 112x112x128, 92416 at 224x224x64
    shapes = ((14, 512), (56, 256), (112, 128), (224, 64))
    assert [_geometry("sfc6_6", 1, hw, hw, c, "SAME").splits
            for hw, c in shapes] == [10, 5, 4, 2]
    # 16 channels a block where 32 would leave SMs idle
    assert _geometry("sfc6_6", 1, 14, 14, 512, "SAME").cb == 32
    assert _geometry("sfc6_6", 1, 14, 14, 384, "SAME").cb == 16
    # the first layer's three channels: runs of tiles fill a block
    first = _geometry("sfc6_6", 1, 224, 224, 3, "SAME")
    assert first.tiles > 1 and first.threads >= TRANSFORM_MIN_THREADS
    # sfc4_4 has 7 transform rows: never more threads than rows
    assert _geometry("sfc4_4", 1, 14, 14, 384, "SAME").splits <= 7


def test_explicit_knobs_are_honoured():
    g = _geometry("sfc6_6", 1, 56, 56, 144, "SAME", channel_block=24)
    assert g.cb == 24 and g.grid[1] == 6
    g = _geometry("sfc6_6", 1, 7, 7, 960, "SAME", channel_block=16,
                  tiles=4, splits=3)
    assert (g.cb, g.tiles, g.splits) == (16, 4, 3)
    # a run longer than the row: its idle tile slots are masked
    assert g.block_tiles(0) == [(0, 0), (0, 1)]
    # three threads share ten rows unevenly: 4, 3 and 3
    assert [len(g.rows_of(s)) for s in range(3)] == [4, 3, 3]
    # an explicit channel block that cannot take the auto splits takes
    # fewer threads per (tile, channel)
    g = _geometry("sfc6_6", 1, 14, 14, 512, "SAME", channel_block=128)
    assert g.cb == 128 and g.threads <= TRANSFORM_MAX_THREADS
    # the first layer of VGG-16: its three channels in one block
    assert _geometry("sfc6_6", 1, 224, 224, 3, "SAME").cb == 3


def test_geometry_rejects_what_cannot_run():
    for knob in ("channel_block", "tiles", "splits"):
        with pytest.raises(ValueError, match=f"{knob}=0"):
            _geometry("sfc6_6", 1, 14, 14, 384, "SAME", **{knob: 0})
    with pytest.raises(ValueError, match="splits must be at most t=10"):
        _geometry("sfc6_6", 1, 14, 14, 384, "SAME", splits=11)
    # too many threads a block, and too much shared memory
    with pytest.raises(ValueError, match="640 threads"):
        _geometry("sfc6_6", 1, 14, 14, 384, "SAME", channel_block=64,
                  splits=10)
    with pytest.raises(ValueError, match="shared memory"):
        _geometry("sfc6_7", 1, 56, 56, 1024, "SAME", channel_block=512,
                  tiles=8, splits=1)


def test_wrappers_refuse_bad_knobs_on_the_cpu_too():
    from repro_torch.kernels import (sfc_transform, sfc_transform_quantize,
                                     sfc_transform_quantize_pt)
    algo = registry.get_algorithm("sfc6_6")
    bt = c2d.transform_matrices(algo, device="cpu")[0]
    x = torch.zeros(1, 12, 12, 8)
    s = torch.ones(algo.t, algo.t)
    with pytest.raises(ValueError, match="splits must be at most"):
        sfc_transform(x, bt, algo.M, splits=11)
    for fn in (sfc_transform_quantize, sfc_transform_quantize_pt):
        with pytest.raises(ValueError, match="tiles=0"):
            fn(x, bt, s, algo.M, tiles=0)
