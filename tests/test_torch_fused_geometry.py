"""B4's launch geometry (``repro_torch.kernels.sfc_fused.FusedGeometry``):
what it asks of the card, and that its blocks cover the convolution.

The kernel itself runs only on the card (``chip_smoke.py`` holds it bit
for bit to the staged datapath at the geometries these tests check); here
the geometry is checked as numbers, at VGG-16's 13 layers at batch 1 and
4 and at small shapes of every registered algorithm.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import registry  # noqa: E402
from repro_torch.core import conv2d as c2d  # noqa: E402
from repro_torch.kernels import sfc_fused  # noqa: E402
from repro_torch.kernels.sfc_fused import fused_geometry  # noqa: E402

SFC6_6 = registry.get_algorithm("sfc6_6")
SMEM_PER_BLOCK = 232448     # bytes of shared memory one H100 block may use
# VGG-16's conv layers at 224x224: (H = W, C_in, C_out)
VGG = ((224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
       (56, 128, 256), (56, 256, 256), (56, 256, 256), (28, 256, 512),
       (28, 512, 512), (28, 512, 512), (14, 512, 512), (14, 512, 512),
       (14, 512, 512))
SHAPES = [("sfc6_6", b, hw, cin, cout) for b in (1, 4)
          for hw, cin, cout in VGG]
SHAPES += [(name, b, hw, cin, cout) for name in ("sfc4_4", "sfc6_6", "sfc6_7")
           for b, hw, cin, cout in ((1, 28, 64, 128), (2, 13, 40, 24),
                                    (1, 7, 3, 7))]
KNOBS = {"auto": {}, "alt": {"cout_block": 8, "n_share": 4, "k_split": 2},
         "share8": {"cout_block": 8, "n_share": 8, "k_split": 2}}


def _geometry(name, b, hw, cin, cout, **knobs):
    algo = registry.get_algorithm(name)
    grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
    return algo, fused_geometry(algo, b * grid.nH * grid.nW, cin, cout,
                                **knobs)


def _static_smem(g):
    # csrc/sfc_fused.cu's static arrays: B^T, A^T and the activation scales
    # (3 x 144 f32), and each tile's image (8 bytes), row and column
    return 4 * 3 * 144 + g.tiles * (8 + 4 + 4)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_geometry_fits_the_card(shape):
    _, g = _geometry(*shape)
    assert g.smem_bytes + _static_smem(g) <= SMEM_PER_BLOCK
    assert _static_smem(g) <= sfc_fused.B4_STATIC_SMEM_BYTES
    # the epilogue's int32 partial sums and f32 Y fit where the ring, xq
    # and strip were
    assert g.epilogue_bytes + 4 * g.positions * g.cb + 128 <= g.smem_bytes
    assert all(n % c == 0 for n, c in zip(g.grid + (1,), g.cluster))
    assert math.prod(g.cluster) <= 16 and g.grid[1] <= 65535
    assert g.threads == 512 and g.tiles == 16 and 16 % g.n_share == 0
    assert g.pairs in sfc_fused.PAIRS and g.pairs % 2 == 0 \
        and g.threads // 32 * g.pairs >= g.positions * (g.cb // 8)
    assert g.cb in sfc_fused.COUT_BLOCKS and g.kb in (32, 64) \
        and g.stages == 2 and g.cb % g.k_split == 0 \
        and g.strip_bufs in (1, 2)
    assert g.launch_args() == (g.tiles, g.cb, g.kb, g.stages, g.strip_bufs,
                               g.n_share, g.k_split, g.k_slice, g.pairs,
                               g.threads, g.smem_bytes, *g.grid)


@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_blocks_cover_the_conv_exactly_once(shape, knobs):
    _, g = _geometry(*shape, **KNOBS[knobs])
    cout, cin = shape[-1], shape[-2]
    gx, gy = g.grid
    cluster = g.cluster[0]
    assert gx % cluster == 0
    # every (tile, output channel) finished by exactly one block
    done = set()
    for y in range(gy):
        tiles = range(y * g.tiles, min(g.n_tiles, (y + 1) * g.tiles))
        assert len(tiles) > 0
        for x in range(gx):
            rank = x % cluster
            n_rank, k_rank = rank % g.n_share, rank // g.n_share
            n0 = ((x // cluster) * g.n_share + n_rank) * g.cb
            for j in g.channels_finished(k_rank):
                if n0 + j >= cout:
                    continue
                for n in tiles:
                    assert (n, n0 + j) not in done
                    done.add((n, n0 + j))
    assert len(done) == g.n_tiles * cout
    # within a cluster: every tile transformed by one C_out rank, every
    # C_in channel in one stage of one C_in rank, every position in every
    # block (it holds all t^2)
    assert sorted(c for r in range(g.n_share) for c in g.tiles_of(r)) == \
        list(range(g.tiles))
    chans = [k for r in range(g.k_split)
             for k0, n in g.channel_stages(r) for k in range(k0, k0 + n)]
    assert chans == list(range(cin))
    assert all(0 <= n <= g.kb for r in range(g.k_split)
               for _, n in g.channel_stages(r))
    assert sorted(j for r in range(g.k_split)
                  for j in g.channels_finished(r)) == list(range(g.cb))


@pytest.mark.parametrize("hw", [14, 28])
def test_deep_vgg_layers_reach_the_block_floor_at_batch_1(hw):
    # 9 and 25 tiles: one and two groups of 16.  A block holds one SM (its
    # int32 fragments and shared memory); the geometry makes MIN_BLOCKS of
    # them, from C_in slices where the C_out blocks do not suffice, with
    # eight or sixteen C_out blocks sharing each transform
    _, g = _geometry("sfc6_6", 1, hw, 512, 512)
    assert g.blocks >= sfc_fused.MIN_BLOCKS
    assert g.n_share >= 8 and g.cluster[0] <= 16
    assert (g.k_split > 1) == (hw == 14)


def test_geometry_rejects_what_cannot_run():
    with pytest.raises(ValueError, match="k_block must be 32 or 64"):
        fused_geometry(SFC6_6, 9, 512, 512, k_block=48)
    with pytest.raises(ValueError, match="cout_block 8 or 16"):
        fused_geometry(SFC6_6, 9, 512, 512, cout_block=24)
    with pytest.raises(ValueError, match="n_share and k_split must be"):
        fused_geometry(SFC6_6, 9, 512, 512, n_share=3)
    with pytest.raises(ValueError, match="n_share and k_split must be"):
        fused_geometry(SFC6_6, 9, 512, 512, k_split=32)
    with pytest.raises(ValueError, match="cout_block 8 or 16"):
        fused_geometry(SFC6_6, 9, 512, 512, cout_block=64)
    # no geometry at any level: clusters of 32 blocks
    with pytest.raises(ValueError, match="shared memory"):
        fused_geometry(SFC6_6, 9, 512, 512, n_share=16, k_split=2)


# sfc6_7's 144 positions: two 16-channel weight stages of 16 tiles (or 64
# channels a stage) need more than a block's shared memory, so B4 takes one
# stage at cout_block 16, and one stage of 8 tiles at k_block 64
SFC6_7_REPAIRED = [({"cout_block": 16}, 16, 1, 16),
                   ({"k_block": 64}, 8, 1, 8),
                   ({"k_block": 64, "cout_block": 8}, 8, 1, 8)]


@pytest.mark.parametrize("knobs,tiles,stages,cb", SFC6_7_REPAIRED,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("shape", [(1, 28, 64, 128), (1, 14, 512, 512),
                                   (4, 56, 256, 256), (1, 7, 3, 7),
                                   (1, 224, 3, 64)],
                         ids=lambda s: "-".join(map(str, s)))
def test_sfc6_7_takes_k_block_64_and_cout_block_16(shape, knobs, tiles,
                                                   stages, cb):
    _, g = _geometry("sfc6_7", *shape, **knobs)
    assert (g.tiles, g.stages, g.cb) == (tiles, stages, cb)
    assert g.smem_bytes <= sfc_fused.B4_SMEM_LIMIT_BYTES
    assert g.smem_bytes + _static_smem(g) <= SMEM_PER_BLOCK
    assert g.epilogue_bytes <= g._reused_bytes
    assert g.n_share <= g.tiles and g.pairs in sfc_fused.PAIRS
    assert g.kb == knobs.get("k_block", 32)
    # its blocks cover the conv: 8-tile groups where the geometry has 8
    assert g.grid[1] == -(-g.n_tiles // tiles)
    assert sorted(c for r in range(g.n_share) for c in g.tiles_of(r)) == \
        list(range(tiles))


# sfc6_6's and sfc4_4's geometries, and sfc6_7's at its defaults, as they
# were before B4 took one stage or 8 tiles: (algo, tiles of the launch,
# C_in, C_out, knobs) -> (cb, n_share, k_split, strip_bufs, smem bytes)
PINNED = [
    ("sfc6_6", 1, 32, 8, {}, (16, 16, 1, 2, 176768)),
    ("sfc6_6", 9, 512, 512, {}, (16, 8, 2, 2, 193024)),
    ("sfc6_6", 1444, 64, 64, {}, (16, 4, 1, 2, 225792)),
    ("sfc6_6", 64, 64, 128, {"k_block": 64}, (8, 16, 1, 1, 224768)),
    ("sfc6_6", 1444, 64, 64, {"cout_block": 8}, (8, 8, 1, 2, 138624)),
    ("sfc4_4", 9, 512, 512, {}, (16, 8, 2, 2, 97152)),
    ("sfc4_4", 1444, 64, 64, {"k_block": 64}, (16, 4, 1, 2, 227712)),
    ("sfc4_4", 64, 64, 128, {"cout_block": 8}, (8, 16, 1, 2, 61440)),
    ("sfc6_7", 9, 512, 512, {}, (8, 16, 1, 2, 173184)),
    ("sfc6_7", 1444, 64, 64, {"cout_block": 8}, (8, 8, 1, 2, 193792)),
]


@pytest.mark.parametrize("name,n_tiles,cin,cout,knobs,want", PINNED,
                         ids=lambda v: str(v))
def test_two_stage_geometries_are_unchanged(name, n_tiles, cin, cout, knobs,
                                            want):
    g = fused_geometry(registry.get_algorithm(name), n_tiles, cin, cout,
                       **knobs)
    assert (g.tiles, g.stages) == (16, 2)
    assert (g.cb, g.n_share, g.k_split, g.strip_bufs, g.smem_bytes) == want
