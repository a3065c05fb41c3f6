"""B2's and B6's launch geometry (``repro_torch.kernels.sfc_tdmm``
``TdmmGeometry`` and ``DwProductGeometry``): what it asks of the card, and
that its blocks cover every (p, row, column) of the GEMM and every (p,
tile, channel) of the depthwise product once.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
bit for bit to their plain versions at the per-layer geometry and at
another); here the geometry is checked as numbers, at VGG-16's layers and
MobileNetV2's depthwise layers at batch 1 and 4 and at ragged shapes of
every registered SFC algorithm.
"""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import registry  # noqa: E402
from repro_torch.core import conv2d as c2d  # noqa: E402
from repro_torch.kernels import sfc_tdmm  # noqa: E402
from repro_torch.kernels.sfc_tdmm import (  # noqa: E402
    DW_MAX_THREADS, TDMM_KERNELS, TDMM_MAX_STAGES, TDMM_REGISTERS,
    dw_product_geometry, tdmm_geometry)

SMEM_PER_BLOCK = 232448     # bytes of shared memory one H100 block may use
SMS = 132                   # the H100's SMs
CSRC = pathlib.Path(sfc_tdmm.__file__).resolve().parents[1] / "csrc"
# VGG-16's 13 convs at 224x224 as (H = W, C_in, C_out), the distinct shapes
VGG_LAYERS = ((224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
              (56, 128, 256), (56, 256, 256), (28, 256, 512),
              (28, 512, 512), (14, 512, 512))
# the stride-1 depthwise convs of MobileNetV2 at 224x224 and the repo's
# dw3x3, (H = W, C), as chip_smoke.py's DW_LAYERS
DW_LAYERS = ((112, 32), (56, 144), (28, 192), (14, 384), (14, 576),
             (7, 960), (28, 256))
# ragged images (tiles T), channel counts no multiple of 16, VALID
RAGGED = ((2, 13, 11, 40, 24, "SAME"), (1, 19, 7, 3, 8, "VALID"),
          (3, 9, 30, 64, 520, "SAME"), (1, 5, 5, 16, 64, "VALID"))


def _tiles(name, b, h, w, padding):
    algo = registry.get_algorithm(name)
    grid = c2d.tile_grid(h, w, algo.M, algo.R, padding)
    return algo.t ** 2, b * grid.nH * grid.nW


def _gemm_shapes():
    """(label, P, T, K, N) of B2's calls."""
    out = []
    for b in (1, 4):
        for hw, cin, cout in VGG_LAYERS:
            P, T = _tiles("sfc6_6", b, hw, hw, "SAME")
            out.append((f"vgg-b{b}-{hw}x{cin}x{cout}", P, T, cin, cout))
    for name in ("sfc4_4", "sfc6_6", "sfc6_7"):
        for b, h, w, cin, cout, pad in RAGGED:
            P, T = _tiles(name, b, h, w, pad)
            out.append((f"{name}-{b}x{h}x{w}x{cin}x{cout}-{pad}", P, T, cin,
                        cout))
    # T 1, 9 and 17 tiles; K 3 and 40; N 8, 24 and 520 (chip_smoke.py)
    out += [(f"tdmm-{T}x{K}x{N}", 100, T, K, N)
            for T, K, N in ((1, 64, 64), (9, 40, 24), (17, 3, 8),
                            (9, 512, 520), (17, 128, 128))]
    return out


def _dw_shapes():
    """(label, P, T, C) of B6's calls."""
    out = []
    for b in (1, 4):
        for hw, c in DW_LAYERS:
            P, T = _tiles("sfc6_6", b, hw, hw, "SAME")
            out.append((f"dw-b{b}-{hw}x{c}", P, T, c))
    for name in ("sfc4_4", "sfc6_6", "sfc6_7"):
        for b, h, w, c, _, pad in RAGGED:
            P, T = _tiles(name, b, h, w, pad)
            out.append((f"{name}-{b}x{h}x{w}x{c}-{pad}", P, T, c))
    out += [(f"dw-C{c}", 100, 9, c) for c in (3, 20, 960)]
    return out


GEMM_SHAPES = _gemm_shapes()
DW_SHAPES = _dw_shapes()
# the per-layer geometry and a second one (chip_smoke.py's B2_ALT and
# B6_ALT), where the shape has a kernel for it
GEMM_KNOBS = {"auto": {}, "alt": {"block_m": 32, "block_n": 64,
                                  "stages": 3, "tiles": 3},
              "one": {"block_m": 128, "stages": 2, "tiles": 1}}
DW_KNOBS = {"auto": {}, "alt": {"groups": 3, "lanes": 5, "run": 2},
            "one": {"groups": 1, "lanes": 1, "run": 1}}


def _partitions(ranges, n):
    """Whether the ranges cover 0 .. n - 1 once each."""
    seen = [i for r in ranges for i in r]
    return sorted(seen) == list(range(n))


@pytest.mark.parametrize("knobs", sorted(GEMM_KNOBS))
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=[s[0] for s in GEMM_SHAPES])
def test_gemm_blocks_cover_every_output_once(shape, knobs):
    _, P, T, K, N = shape
    g = tdmm_geometry(P, T, K, N, **GEMM_KNOBS[knobs])
    gx, gy, gz = g.grid
    assert gz == P
    rows = [g.block_tile(0, by, 0)[1] for by in range(gy)]
    cols = [g.block_tile(bx, 0, 0)[2] for bx in range(gx)]
    assert all(len(r) > 0 for r in rows) and all(len(c) > 0 for c in cols)
    assert _partitions(rows, T) and _partitions(cols, N)
    # a block's tile is the product of its rows and columns: so every
    # (p, row, column) lies in exactly one block
    assert g.block_tile(gx - 1, gy - 1, gz - 1) == (
        P - 1, rows[-1], cols[-1])
    assert sum(len(r) for r in rows) * sum(len(c) for c in cols) * P \
        == P * T * N


@pytest.mark.parametrize("knobs", sorted(GEMM_KNOBS))
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=[s[0] for s in GEMM_SHAPES])
def test_gemm_geometry_fits_the_card(shape, knobs):
    _, P, T, K, N = shape
    g = tdmm_geometry(P, T, K, N, **GEMM_KNOBS[knobs])
    assert (g.bm, g.bn, g.bk, g.vec_a, g.vec_b) in TDMM_KERNELS
    assert g.vec_a == (K % 16 == 0) and g.vec_b == (N % 16 == 0)
    assert g.smem_bytes <= SMEM_PER_BLOCK
    assert g.smem_bytes == min(g.stages, g.tiles * g.ksteps) * (
        g.bm * g.bk + g.bk * g.bn)
    assert 1 <= g.tiles <= g.row_tiles
    assert 2 <= g.stages <= TDMM_MAX_STAGES
    # the kernel declares at most TDMM_REGISTERS registers a thread
    # (__launch_bounds__); a warp's int32 fragments take half of them
    wm, wn = g.warps
    assert g.threads == 32 * wm * wn and g.threads % 32 == 0
    assert g.bm % (16 * wm) == 0 and g.bn % (16 * wn) == 0
    fragments = (g.bm // wm // 16) * (g.bn // wn // 16) * 2 * 4
    assert fragments <= TDMM_REGISTERS // 2
    assert g.threads * TDMM_REGISTERS <= 65536 and g.resident >= 1
    assert g.grid[1] <= 65535 and g.grid[2] <= 65535
    assert g.launch_args() == (g.bm, g.bn, g.bk, g.stages, g.tiles,
                               g.smem_bytes)


def test_every_kernel_the_geometry_names_is_compiled():
    # csrc/sfc_tdmm.cu compiles one kernel per TDMM_CASE: the same set
    src = (CSRC / "sfc_tdmm.cu").read_text()
    cases = re.findall(r"^\s*TDMM_CASE\((\d+), (\d+), (\d+), (\w+), (\w+)\)",
                       src, re.M)
    compiled = {(int(a), int(b), int(c), d == "true", e == "true")
                for a, b, c, d, e in cases}
    assert len(cases) == len(compiled) == len(TDMM_KERNELS)
    assert compiled == TDMM_KERNELS
    assert f"kMaxStages = {TDMM_MAX_STAGES};" in src
    assert f"kRegisters = {TDMM_REGISTERS};" in src


@pytest.mark.parametrize("batch", (1, 4))
@pytest.mark.parametrize("layer", VGG_LAYERS,
                         ids=[f"{h}x{i}x{o}" for h, i, o in VGG_LAYERS])
def test_gemm_geometry_per_layer(layer, batch):
    hw, cin, cout = layer
    P, T = _tiles("sfc6_6", batch, hw, hw, "SAME")
    g = tdmm_geometry(P, T, cin, cout)
    # the deep layers (few tiles) fill a wave and pay for no more rows than
    # the next row tile up holds; every layer keeps enough blocks
    if hw <= 28:
        assert g.blocks >= SMS
    assert g.bm < 2 * T or g.bm == 16
    assert g.bm * g.row_tiles - T < g.bm
    assert g.bk == (64 if cin >= 64 else 32)
    assert g.vec_a == (cin != 3) and g.vec_b
    # deterministic: asked again (the cache cleared), the same geometry
    sfc_tdmm._tdmm_geometry.cache_clear()
    assert tdmm_geometry(P, T, cin, cout) == g


def test_gemm_geometry_rejects_what_has_no_kernel():
    with pytest.raises(ValueError, match="stages must lie"):
        tdmm_geometry(100, 9, 512, 512, stages=1)
    with pytest.raises(ValueError, match="stages must lie"):
        tdmm_geometry(100, 9, 512, 512, stages=TDMM_MAX_STAGES + 1)
    with pytest.raises(ValueError, match="no kernel for block_m=48"):
        tdmm_geometry(100, 9, 512, 512, block_m=48)
    with pytest.raises(ValueError, match="tiles=0"):
        tdmm_geometry(100, 9, 512, 512, tiles=0)
    # a run longer than the layer's row tiles is cut to them
    assert tdmm_geometry(100, 9, 512, 512, tiles=8).tiles == 1
    # the byte-wise variants: block_n 64 and block_k 32 only
    with pytest.raises(ValueError, match="no kernel"):
        tdmm_geometry(100, 9, 40, 512, block_k=64)
    with pytest.raises(ValueError, match="no kernel"):
        tdmm_geometry(100, 9, 512, 520, block_n=128)
    g = tdmm_geometry(100, 9, 40, 520)
    assert (g.bn, g.bk, g.vec_a, g.vec_b) == (64, 32, False, False)


def test_gemm_wrapper_refuses_bad_knobs_on_the_cpu_too():
    from repro_torch.kernels import tdmm_int8
    X = torch.zeros(4, 9, 32, dtype=torch.int8)
    W = torch.zeros(4, 32, 64, dtype=torch.int8)
    sx, sw = torch.ones(4), torch.ones(4, 64)
    with pytest.raises(ValueError, match="stages"):
        tdmm_int8(X, W, sx, sw, stages=9)
    Y = tdmm_int8(X, W, sx, sw, block_m=64, block_n=128, stages=2)
    assert Y.shape == (4, 9, 64) and not Y.any()


@pytest.mark.parametrize("knobs", sorted(DW_KNOBS))
@pytest.mark.parametrize("shape", DW_SHAPES, ids=[s[0] for s in DW_SHAPES])
def test_product_threads_cover_every_element_once(shape, knobs):
    _, P, T, C = shape
    g = dw_product_geometry(P, T, C, **DW_KNOBS[knobs])
    gx, gy, gz = g.grid
    assert gz == P
    # every position is alike: the threads of p = 0 cover (tile, channel)
    seen = set()
    count = 0
    for bx in range(gx):
        for by in range(gy):
            for x in range(g.groups):
                for y in range(g.lanes):
                    p, tiles, chans = g.thread_items(bx, by, 0, x, y)
                    assert p == 0 and len(tiles) <= g.run
                    assert len(chans) <= 16 and len(set(chans)) == len(chans)
                    # whole 4-channel chunks, masked past C
                    assert all(c % 4 == 0 for c in chans[::4])
                    for t in tiles:
                        seen.update((t, c) for c in chans[::4])
                        count += len(chans)
    assert count == T * C
    assert seen == {(t, c) for t in range(T) for c in range(0, C, 4)}


@pytest.mark.parametrize("knobs", sorted(DW_KNOBS))
@pytest.mark.parametrize("shape", DW_SHAPES, ids=[s[0] for s in DW_SHAPES])
def test_product_geometry_fits_the_card(shape, knobs):
    _, P, T, C = shape
    g = dw_product_geometry(P, T, C, **DW_KNOBS[knobs])
    # no shared memory; 16 weights and 16 scales a thread in registers
    assert 1 <= g.threads <= DW_MAX_THREADS
    assert g.grid[1] <= 65535 and g.grid[2] <= 65535
    assert P * T * C < 2 ** 31
    assert g.launch_args() == (g.groups, g.lanes, g.run)


@pytest.mark.parametrize("batch", (1, 4))
@pytest.mark.parametrize("layer", DW_LAYERS,
                         ids=[f"{h}x{c}" for h, c in DW_LAYERS])
def test_product_geometry_per_layer(layer, batch):
    hw, c = layer
    P, T = _tiles("sfc6_6", batch, hw, hw, "SAME")
    g = dw_product_geometry(P, T, c)
    # a wave of blocks at every layer, whole warps' worth of threads, and
    # no more lanes than tiles
    assert g.blocks >= SMS
    assert g.threads >= 32 and g.lanes <= T
    assert g.groups == min(2 * -(-c // 16), sfc_tdmm.DW_GROUPS)
    sfc_tdmm._dw_product_geometry.cache_clear()
    assert dw_product_geometry(P, T, c) == g


def test_product_geometry_rejects_what_cannot_run():
    for knob in ("groups", "lanes", "run"):
        with pytest.raises(ValueError, match=f"{knob}=0"):
            dw_product_geometry(100, 9, 384, **{knob: 0})
    with pytest.raises(ValueError, match="threads a block"):
        dw_product_geometry(100, 9, 384, groups=64, lanes=32)
