"""B7's launch geometry (``repro_torch.kernels.sfc_fused.DepthwiseGeometry``):
what it asks of the card, and that its blocks cover the depthwise conv.

The kernel itself runs only on the card (``chip_smoke.py`` holds it bit
for bit to the staged depthwise datapath at the per-layer geometry and at
two others); here the geometry is checked as numbers, at MobileNetV2's
stride-1 depthwise layers at batch 1 and 4 and at ragged shapes of every
registered SFC algorithm.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import registry  # noqa: E402
from repro_torch.core import conv2d as c2d  # noqa: E402
from repro_torch.kernels import sfc_fused  # noqa: E402
from repro_torch.kernels.sfc_fused import depthwise_geometry  # noqa: E402

SMEM_PER_BLOCK = 232448     # bytes of shared memory one H100 block may use
SMS = 132                   # the H100's SMs
# the stride-1 depthwise convs of MobileNetV2 at 224x224 and the repo's
# dw3x3, (H = W, C), as chip_smoke.py's DW_LAYERS
DW_LAYERS = ((112, 32), (56, 144), (28, 192), (14, 384), (14, 576),
             (7, 960), (28, 256))
SHAPES = [("sfc6_6", b, hw, hw, c, "SAME") for b in (1, 4)
          for hw, c in DW_LAYERS]
# ragged images, channel counts no multiple of any block, VALID
SHAPES += [(name, b, h, w, c, pad) for name in ("sfc4_4", "sfc6_6", "sfc6_7")
           for b, h, w, c, pad in ((2, 13, 11, 40, "SAME"),
                                   (1, 19, 7, 5, "VALID"),
                                   (3, 9, 30, 70, "SAME"))]
KNOBS = {"auto": {}, "alt": {"cout_block": 16, "tiles": 4, "splits": 3},
         "block24": {"cout_block": 24}, "one": {"tiles": 1, "splits": 1}}


def _ids(shape):
    return "-".join(map(str, shape))


def _geometry(name, b, h, w, c, padding, **knobs):
    algo = registry.get_algorithm(name)
    grid = c2d.tile_grid(h, w, algo.M, algo.R, padding)
    return depthwise_geometry(algo, (b * grid.nH, grid.nW), c, **knobs)


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_blocks_cover_every_tile_and_channel_once(shape, knobs):
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


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_geometry_fits_the_card(shape, knobs):
    g = _geometry(*shape, **KNOBS[knobs])
    # the kernel's static part: the mbarrier (its scales stay in L1)
    assert g.smem_bytes + sfc_fused.DW_STATIC_SMEM_BYTES <= SMEM_PER_BLOCK
    assert g.threads % 32 == 0 and g.threads <= sfc_fused.DW_MAX_THREADS
    assert g.threads >= g.splits * g.tiles * g.cb > g.threads - 32
    assert 1 <= g.splits <= max(sfc_fused.DW_SPLITS)
    # a TMA box spans at most 256 elements a dimension
    assert g.region_w == g.M * (g.tiles - 1) + g.L <= 256
    assert g.grid[1] <= 65535
    P = g.t * g.t
    assert g.smem_bytes >= 128 + 4 * g.L * g.region_w * g.cb \
        + 5 * P * g.cb + 4 * P * g.tiles * g.cb
    assert g.launch_args() == (g.tiles, g.cb, g.splits, g.threads,
                               g.smem_bytes, *g.grid)


@pytest.mark.parametrize("hw,c", DW_LAYERS,
                         ids=[f"{hw}x{c}" for hw, c in DW_LAYERS])
def test_batch_1_fills_a_wave_where_the_layer_has_the_work(hw, c):
    # every MobileNetV2 layer has at least SMS (tile, 16-channel) pairs, so
    # the per-layer geometry launches at least one block per SM
    g = _geometry("sfc6_6", 1, hw, hw, c, "SAME")
    if g.tile_rows * g.tile_cols * -(-c // 16) >= SMS:
        assert g.blocks >= SMS
    assert g.cb in sfc_fused.DW_COUT_BLOCKS
    # no tile slot of a run idles at a row's end
    assert g.tile_cols % g.tiles == 0


def test_small_layers_get_more_threads_per_tile_than_large_ones():
    # (tile, channel) pairs: 3456 at 14x14x384 batch 1, 46208 at
    # 112x112x32 batch 4, 230400 at 56x56x144 batch 16
    small = _geometry("sfc6_6", 1, 14, 14, 384, "SAME")
    mid = _geometry("sfc6_6", 4, 112, 112, 32, "SAME")
    large = _geometry("sfc6_6", 16, 56, 56, 144, "SAME")
    assert (small.splits, mid.splits, large.splits) == (10, 5, 3)
    # sfc4_4 has 7 transform rows: never more threads than rows
    assert _geometry("sfc4_4", 1, 14, 14, 384, "SAME").splits == 5


def test_explicit_knobs_are_honoured():
    g = _geometry("sfc6_6", 1, 56, 56, 144, "SAME", cout_block=24)
    assert g.cb == 24 and g.grid[1] == 6
    g = _geometry("sfc6_6", 1, 7, 7, 960, "SAME", cout_block=16, tiles=4,
                  splits=3)
    assert (g.cb, g.tiles, g.splits) == (16, 4, 3)
    # a run longer than the row: its idle tile slots are masked
    assert g.block_tiles(0) == [(0, 0), (0, 1)]
    # an explicit channel block that cannot take the auto splits takes
    # fewer threads per (tile, channel)
    g = _geometry("sfc6_6", 1, 14, 14, 384, "SAME", cout_block=64)
    assert g.cb == 64 and g.threads <= sfc_fused.DW_MAX_THREADS


def test_geometry_rejects_what_cannot_run():
    for knob in ("cout_block", "tiles", "splits"):
        with pytest.raises(ValueError, match=f"{knob}=0"):
            _geometry("sfc6_6", 1, 14, 14, 384, "SAME", **{knob: 0})
    with pytest.raises(ValueError, match="splits must be at most 10"):
        _geometry("sfc6_6", 1, 14, 14, 384, "SAME", splits=11)
    # too many threads a block, and too much shared memory
    with pytest.raises(ValueError, match="1280 threads"):
        _geometry("sfc6_6", 1, 14, 14, 384, "SAME", cout_block=128,
                  splits=10)
    with pytest.raises(ValueError, match="shared memory"):
        _geometry("sfc6_7", 1, 56, 56, 1024, "SAME", cout_block=256,
                  tiles=1, splits=1)
