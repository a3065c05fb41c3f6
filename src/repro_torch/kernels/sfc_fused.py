"""B4 and B7: the int8 SFC convolution as ONE CUDA launch.

B4 (``csrc/sfc_fused.cu``) is the port of
``repro/kernels/sfc_fused.py::_fused_kernel``, the dense conv; B7
(``csrc/sfc_fused_dw.cu``) the port of ``::_fused_dw_kernel``, the
depthwise conv, which ``sfc_fused_conv2d(depthwise=True)`` runs.

B4's geometry is :class:`FusedGeometry`, the counterpart of the JAX
package's (whose TPU numbers, ``VMEM_LIMIT_BYTES`` and the strip grouping,
do not carry over), computed per layer by :func:`fused_geometry` and
passed to the kernel, which only checks it.  A block owns 16 tiles (one
mma M tile; 8 where 16 do not fit), ``cb`` (8 or 16) output channels, all
t^2 positions and a slice of C_in, which it walks in ``k_block``-wide
stages: TMA (cp.async where the shape rules TMA out) brings each stage's
input patches and weights into shared memory a stage ahead of use (the
weights while the stage transforms where one stage fits, not two), the
block transforms and quantizes its share of the tiles, the ``n_share``
C_out blocks of a thread block cluster copy their shares into each
other's shared memory (the counterpart of the TPU kernel's xq cache), and
each adds its products into int32 mma fragments in registers, its B
fragments from ldmatrix.trans at cb = 16.  ``k_split`` C_in slices of a cluster add
their partial sums over distributed shared memory before the epilogue.
The transform-domain tensor never goes to device memory.

The kernel calls the same device functions as the staged B1 (transform +
quantize), B2 (dequant) and B3 (inverse), and its int32 sums are exact,
so on the card the fused and the staged datapath are bit-identical at
every geometry; ``chip_smoke.py`` asserts it at every VGG-16 layer.

B7 has no channel contraction, so its blocks own a run of tiles along one
tile row and ``cout_block`` channels, with no C_in loop, no accumulator
and no cluster; its geometry is :class:`DepthwiseGeometry`, computed per
layer by :func:`depthwise_geometry`.  TMA brings the run's input region,
zero-padded, and the block's (P, cb) weights and scales into shared
memory once; the block transforms and quantizes, multiplies, dequantizes
and inverts from there, sharing B1's, B6's and B3's device functions, so
it is bit-identical to the staged depthwise datapath.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import conv2d as c2d
from repro_torch.core.generator import BilinearAlgorithm
from repro_torch.kernels import _build, ref
from repro_torch.kernels.sfc_tdmm import resident_blocks, waves

TILES = 16          # tiles per B4 block: the mma M dimension (kMaxTiles)
THREADS = 512       # threads per B4 block (kThreads in csrc/sfc_fused.cu)
K_BLOCK = 32        # C_in channels per pipeline stage (mma k = 32)
STAGES = 2          # B4's ring of weight stages
# (tiles, stages) in the order the geometry tries them: a two-stage ring
# of 16 tiles wherever some geometry fits; where none does (sfc6_7's 144
# positions at cout_block 16 or k_block 64), one weight stage, whose copy
# waits for the products of the stage before; then also 8 tiles a block
# (half the mma's M rows idle, half the xq)
LEVELS = ((TILES, STAGES), (TILES, 1), (TILES // 2, 1))
PAIRS = (4, 8, 12, 16, 20)   # the pairs per warp B4 is compiled for
# B4's output channels per block, in the order the auto geometry tries
# them: one or two mma n-tiles (the int32 fragments of all t^2 positions
# of 16 channels fill half a block's registers at t = 12).  Then it takes
# the fewest C_in ranks and the most C_out ranks per cluster (no more than
# the layer has C_out blocks) that make MIN_BLOCKS blocks, within
# MAX_CLUSTER blocks.  A block holds one SM (its int32 fragments and
# shared memory), and on an H100 fewer, longer blocks measured faster than
# a full wave of shorter ones (chip_smoke.py --sweep-b4; PERF.md)
COUT_BLOCKS = (16, 8)
MIN_BLOCKS = 64
MAX_CLUSTER = 16
# shared memory one block may use on an H100, less the kernel's static
# part: B4's (B^T, A^T, scales and its tiles' coordinates, under 4 KB) and
# B7's (an mbarrier, rounded up to 2 KB)
B4_STATIC_SMEM_BYTES = 4096
B4_SMEM_LIMIT_BYTES = 232448 - B4_STATIC_SMEM_BYTES
DW_STATIC_SMEM_BYTES = 2048
DW_SMEM_LIMIT_BYTES = 232448 - DW_STATIC_SMEM_BYTES
# B7's geometry, from chip_smoke.py --sweep-b7 on an H100 (PERF.md).  The
# threads per (tile, channel) ("splits", which share its transform rows
# and its output rows) by the layer's (tile, channel) pairs: 10 below
# 12288 pairs, 5 below 65536, else 3 (a small layer waits on each thread's
# chain of FMAs and divisions, a large one on throughput).  Then 32 f32
# channels a block (128 bytes a pixel: whole lines), else 16, and the
# longest run of tiles along a tile row (no tile slot idle at the row's
# end) that makes SMS blocks, a wave of the H100's SMs, else the most
# blocks; within DW_MAX_THREADS threads a block (kMaxThreads in
# csrc/sfc_fused_dw.cu), with fewer splits where needed.
DW_COUT_BLOCKS = (32, 16)
DW_TILE_RUNS = (4, 2, 1)
DW_SPLITS = (1, 2, 3, 5, 10)
DW_SPLIT_PAIRS = ((12288, 10), (65536, 5))
DW_MAX_THREADS = 384
SMS = 132


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """B4's launch geometry for one layer, the counterpart of the JAX
    package's ``FusedGeometry``: computed here once and passed to
    ``csrc/sfc_fused.cu``, which only checks it.

    A block owns ``tiles`` consecutive tiles (16, one mma M tile, or 8),
    ``cb`` output channels, all t^2 positions and a ``k_slice``-wide slice of
    C_in, which it walks in ``kb``-wide stages through a ring of
    ``stages`` weight stages in shared memory, with ``strip_bufs`` input
    strips in flight; each of its 16 warps holds
    ``pairs`` (position, 8-channel) int32 mma fragments in registers.  A
    thread block cluster joins ``n_share`` C_out blocks, which share the
    transform (each quantizes the tiles col = rank mod n_share and copies
    them into the others' shared memory), times ``k_split``
    C_in slices, whose partial sums it adds up before the epilogue (each
    slice finishes cb / k_split of the channels).  Grid: (C_out blocks
    rounded up to n_share, times k_split; tile groups).
    """

    t: int
    M: int
    L: int
    tiles: int
    cb: int
    kb: int
    stages: int
    strip_bufs: int
    n_share: int
    k_split: int
    k_slice: int
    pairs: int
    threads: int
    n_tiles: int
    cin: int
    cout: int

    @property
    def positions(self) -> int:
        return self.t * self.t

    @property
    def cout_blocks(self) -> int:
        """C_out blocks of a tile group, rounded up to whole clusters."""
        n = -(-self.cout // self.cb)
        return -(-n // self.n_share) * self.n_share

    @property
    def grid(self) -> tuple:
        return (self.cout_blocks * self.k_split,
                -(-self.n_tiles // self.tiles))

    @property
    def cluster(self) -> tuple:
        return (self.n_share * self.k_split, 1, 1)

    @property
    def blocks(self) -> int:
        x, y = self.grid
        return x * y

    @property
    def xq_region_bytes(self) -> int:
        """One C_out rank's quantized rows in a block's xq, padded so the
        A fragments of the 16 tiles meet no bank twice (xq_pad in
        csrc/sfc_fused.cu)."""
        pad = 0 if self.n_share == 1 else 32 if self.n_share == 4 else 16
        return self.positions * self.own_tiles * self.kb + pad

    @property
    def own_tiles(self) -> int:
        """Tiles each block of a cluster transforms."""
        return self.tiles // self.n_share

    @property
    def strip_px(self) -> int:
        """Pixels of a block's staged input: L x L per tile it transforms."""
        return self.own_tiles * self.L * self.L

    @property
    def _reused_bytes(self) -> int:
        P = self.positions
        return (self.stages * _align128(P * self.kb * self.cb)
                + _align128(self.n_share * self.xq_region_bytes)
                + self.strip_bufs * _align128(4 * self.strip_px * self.kb))

    @property
    def epilogue_bytes(self) -> int:
        """f32 Y of the block's channels (k_split == 1), or the int32
        partial sums and then the f32 Y of the channels a block finishes;
        they reuse the ring, xq and strip."""
        part = 4 * self.positions * self.tiles * self.cb
        return part + (part // self.k_split if self.k_split > 1 else 0)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: the weight scales, the weight ring, the
        xq of all 16 tiles and the block's input strip, each on 128 bytes
        (TMA destinations), and 128 to align the first (the same formula as
        the check in csrc/sfc_fused.cu)."""
        return 128 + _align128(4 * self.positions * self.cb) \
            + self._reused_bytes

    @property
    def waves(self) -> int:
        """Rounds of blocks over the SMS SMs: a B4 block holds an SM (its
        int32 fragments fill the registers)."""
        return waves(self.blocks, 1)

    def compute_ops(self) -> dict:
        """Operations of the launch: the int8 products of every block (a
        multiply-add is two, padded channels and tiles included), and in
        f32 each cluster's transform and quantization of its tiles (dense
        B^T), the dequantization and the inverse (dense A^T)."""
        t, L, M, P = self.t, self.L, self.M, self.positions
        tiles = self.grid[1] * self.tiles
        clusters = self.cout_blocks // self.n_share
        transform = tiles * clusters * self.cin \
            * (2 * t * L * L + 2 * t * t * L + 3 * t * t)
        epilogue = self.n_tiles * self.cout \
            * (2 * P + 2 * M * t * t + 2 * M * M * t)
        return {"int8": 2 * P * tiles * self.cin * self._cout_padded,
                "f32": transform + epilogue}

    @property
    def _cout_padded(self) -> int:
        """C_out rounded up to whole channel blocks: the blocks past it
        (a cluster's blocks with no channels) only share the transform."""
        return -(-self.cout // self.cb) * self.cb

    def hbm_bytes(self) -> dict:
        """Bytes the launch moves: each cluster's input patches (f32, L x L
        a tile, every C_out cluster of a tile group reading them), each
        block's weights (int8) and weight scales, the output (f32)."""
        groups = self.grid[1]
        clusters = self.cout_blocks // self.n_share
        L, P = self.L, self.positions
        x = 4 * groups * clusters * self.tiles * L * L * self.cin
        w = groups * self._cout_padded * P * self.cin
        scales = 4 * groups * self._cout_padded * self.k_split * P
        y = 4 * self.n_tiles * self.M * self.M * self.cout
        return {"x": x, "w": w, "scales": scales, "y": y,
                "total": x + w + scales + y}

    def tiles_of(self, n_rank: int) -> range:
        """The tiles of a group that C_out rank ``n_rank`` transforms."""
        return range(n_rank, self.tiles, self.n_share)

    def channel_stages(self, k_rank: int) -> list:
        """(first channel, channels) of each stage of C_in rank
        ``k_rank``; every rank runs k_slice / kb stages, those past C_in
        with no channels."""
        out = []
        for s in range(self.k_slice // self.kb):
            k0 = k_rank * self.k_slice + s * self.kb
            out.append((k0, max(0, min(self.kb, self.cin - k0))))
        return out

    def channels_finished(self, k_rank: int) -> range:
        """The channels of its C_out block that C_in rank ``k_rank`` sums,
        dequantizes and inverts."""
        n = self.cb // self.k_split
        return range(k_rank * n, (k_rank + 1) * n)

    def launch_args(self) -> tuple:
        """(tiles, cb, kb, stages, strip_bufs, n_share, k_split, k_slice,
        pairs, threads, smem, grid_x, grid_y) as the C entry point takes
        them."""
        return (self.tiles, self.cb, self.kb, self.stages, self.strip_bufs,
                self.n_share, self.k_split, self.k_slice, self.pairs,
                self.threads, self.smem_bytes, *self.grid)


_Tile = collections.namedtuple("_Tile", "t M L")


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _geometry(algo, n_tiles, cin, cout, kb, cb, n_share, k_split,
              tiles, stages, strip_bufs) -> FusedGeometry:
    P = algo.t * algo.t
    need = -(-P * (cb // 8) // (THREADS // 32))
    pairs = next((p for p in PAIRS if p >= need), -1)
    k_slice = -(-(-(-cin // kb)) // k_split) * kb
    return FusedGeometry(t=algo.t, M=algo.M, L=algo.L, tiles=tiles, cb=cb,
                         kb=kb, stages=stages, strip_bufs=strip_bufs,
                         n_share=n_share,
                         k_split=k_split, k_slice=k_slice, pairs=pairs,
                         threads=THREADS, n_tiles=n_tiles, cin=cin,
                         cout=cout)


def _fits(g: FusedGeometry) -> bool:
    return (g.pairs > 0 and g.n_share * g.k_split <= MAX_CLUSTER
            and g.cb >= g.k_split and g.n_share <= g.tiles
            and g.epilogue_bytes <= g._reused_bytes
            and g.smem_bytes <= B4_SMEM_LIMIT_BYTES
            and g.grid[0] <= 2 ** 31 - 1 and g.grid[1] <= 65535)


def _pow2(n: Optional[int], lo: int, hi: int) -> bool:
    return n is None or (lo <= n <= hi and n & (n - 1) == 0)


def fused_geometry(algo: BilinearAlgorithm, n_tiles: int, cin: int,
                   cout: int, *, k_block: Optional[int] = K_BLOCK,
                   cout_block: Optional[int] = None,
                   n_share: Optional[int] = None,
                   k_split: Optional[int] = None) -> FusedGeometry:
    """B4's geometry for ``n_tiles`` tiles of ``algo`` and ``cin`` ->
    ``cout`` channels, or ValueError if the knobs cannot run.

    ``k_block`` is the C_in width of one pipeline stage (32 or 64; None =
    32).  ``cout_block`` is the output channels per block (8 or 16: one
    or two mma n-tiles).  ``n_share`` (a power of two up to 16) C_out
    blocks share each transform and ``k_split`` (a power of two) C_in
    slices split the reduction, in clusters of at most ``MAX_CLUSTER``
    blocks.  What is None is picked: the first of ``COUT_BLOCKS`` that
    fits, then the fewest C_in slices and the most sharing C_out blocks
    that make ``MIN_BLOCKS`` blocks, else the geometry with the most
    blocks.  Cached: the wrapper asks once per layer shape.
    """
    return _fused_geometry((algo.t, algo.M, algo.L), n_tiles, cin, cout,
                           k_block, cout_block, n_share, k_split)


@functools.lru_cache(maxsize=1024)
def _fused_geometry(tml, n_tiles, cin, cout, k_block, cout_block, n_share,
                    k_split) -> FusedGeometry:
    algo = _Tile(*tml)
    kb = 32 if k_block is None else k_block
    if kb not in (32, 64) or cout_block not in (None,) + COUT_BLOCKS:
        raise ValueError(f"sfc_fused_conv2d: k_block must be 32 or 64 (a "
                         f"multiple of 32, the mma depth) and cout_block 8 "
                         f"or 16 (one or two mma n-tiles), got "
                         f"k_block={k_block}, cout_block={cout_block}")
    if not _pow2(n_share, 1, MAX_CLUSTER) \
            or not _pow2(k_split, 1, MAX_CLUSTER):
        raise ValueError(f"sfc_fused_conv2d: n_share and k_split must be "
                         f"powers of two up to {MAX_CLUSTER}, got "
                         f"n_share={n_share}, k_split={k_split}")
    cbs = (cout_block,) if cout_block is not None else COUT_BLOCKS
    k_max = -(-cin // kb)           # more C_in slices than stages is idle
    cands = []
    for tiles, stages in LEVELS:    # the next level only where none fits
        for cb in cbs:
            n_blocks = -(-cout // cb)
            for ks in ((k_split,) if k_split is not None
                       else [k for k in (1, 2, 4, 8, 16) if k <= k_max]
                       or [1]):
                # sharing C_out blocks up to the layer's count, then (where
                # nothing else fits) C_out blocks with no channels that
                # only share the transform
                for ns in ((n_share,) if n_share is not None
                           else [n for n in (16, 8, 4, 2, 1) if n <= n_blocks]
                           + [n for n in (2, 4, 8, 16) if n > n_blocks]):
                    # the input strip double-buffered where it fits (and
                    # the input is copied by TMA: C_in a multiple of 4)
                    for bufs in ((2, 1) if cin % 4 == 0 else (1,)):
                        g = _geometry(algo, n_tiles, cin, cout, kb, cb, ns,
                                      ks, tiles, stages, bufs)
                        if _fits(g):
                            cands.append(g)
                            break
        if cands:
            break
    if not cands:
        raise ValueError(
            f"sfc_fused_conv2d: k_block={kb}, cout_block={cout_block}, "
            f"n_share={n_share}, k_split={k_split} need "
            f"more than the {B4_SMEM_LIMIT_BYTES} bytes of shared memory "
            f"or the clusters of {MAX_CLUSTER} blocks of one launch for "
            f"t={algo.t}")
    for g in cands:          # ordered: channels, C_in slices, sharing
        if g.blocks >= MIN_BLOCKS:
            return g
    return max(cands, key=lambda g: g.blocks)


@dataclasses.dataclass(frozen=True)
class DepthwiseGeometry:
    """B7's launch geometry for one layer: computed here once and passed
    to ``csrc/sfc_fused_dw.cu``, which only checks it.

    A block owns a run of ``tiles`` tiles along one tile row (tile columns
    ``tiles * r`` on; the last run of a row may be short) and ``cb``
    channels; ``splits`` threads per (tile, channel) share its transform
    rows and its output rows.  It stages the run's input region, L x
    ``region_w`` pixels of ``cb`` channels, its weights and weight scales
    in shared memory.  Grid: ((image, tile row) x runs, channel blocks).
    """

    t: int
    M: int
    L: int
    tiles: int
    cb: int
    splits: int
    tile_rows: int      # B nH
    tile_cols: int      # nW
    channels: int

    @property
    def positions(self) -> int:
        return self.t * self.t

    @property
    def runs(self) -> int:
        """Runs of tiles per tile row."""
        return -(-self.tile_cols // self.tiles)

    @property
    def grid(self) -> tuple:
        return (self.tile_rows * self.runs, -(-self.channels // self.cb))

    @property
    def blocks(self) -> int:
        x, y = self.grid
        return x * y

    @property
    def threads(self) -> int:
        return -(-self.splits * self.tiles * self.cb // 32) * 32

    @property
    def region_w(self) -> int:
        """Input columns of a run: M per tile and the R - 1 of the halo."""
        return self.M * (self.tiles - 1) + self.L

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: the input region (f32), the weight
        scales (f32), the weights (int8) and the dequantized products
        (f32), each on 128 bytes, and 128 to align the first (the same
        formula as the check in csrc/sfc_fused_dw.cu)."""
        P = self.positions
        return 128 + _align128(4 * self.L * self.region_w * self.cb) \
            + _align128(4 * P * self.cb) + _align128(P * self.cb) \
            + _align128(4 * P * self.tiles * self.cb)

    @property
    def waves(self) -> int:
        return waves(self.blocks, resident_blocks(self.threads,
                                                  self.smem_bytes))

    def compute_ops(self) -> dict:
        """f32 operations for every (tile, channel): the transform and its
        quantization (dense B^T), the int32 product and its dequantization
        on CUDA cores, the inverse (dense A^T)."""
        t, L, M = self.t, self.L, self.M
        per = (2 * t * L * L + 2 * t * t * L + 3 * t * t + 2 * t * t
               + 2 * M * t * t + 2 * M * M * t)
        return {"int8": 0,
                "f32": self.tile_rows * self.tile_cols * self.channels * per}

    def hbm_bytes(self) -> dict:
        """Each block's input region (f32), weights (int8) and weight
        scales, the output (f32)."""
        P = self.positions
        x = 4 * self.blocks * self.L * self.region_w * self.cb
        w = self.grid[0] * P * self.channels
        scales = 4 * self.grid[0] * P * self.channels
        y = 4 * self.tile_rows * self.tile_cols * self.M * self.M \
            * self.channels
        return {"x": x, "w": w, "scales": scales, "y": y,
                "total": x + w + scales + y}

    def block_tiles(self, bx: int) -> list:
        """The (tile row, tile column) of each tile block ``bx`` owns."""
        row, run = divmod(bx, self.runs)
        return [(row, c) for c in range(run * self.tiles,
                                        min((run + 1) * self.tiles,
                                            self.tile_cols))]

    def launch_args(self) -> tuple:
        """(tiles, cb, splits, threads, smem, grid_x, grid_y) as the C
        entry point takes them."""
        return (self.tiles, self.cb, self.splits, self.threads,
                self.smem_bytes, *self.grid)


def _dw_fits(g: DepthwiseGeometry) -> bool:
    return (g.threads <= DW_MAX_THREADS and g.smem_bytes <= DW_SMEM_LIMIT_BYTES
            and g.region_w <= 256 and g.grid[1] <= 65535)


def depthwise_geometry(algo: BilinearAlgorithm, n_tiles: tuple, C: int,
                       cout_block: Optional[int] = None, *,
                       tiles: Optional[int] = None,
                       splits: Optional[int] = None) -> DepthwiseGeometry:
    """B7's geometry for the tiles ``n_tiles`` = (B nH, nW), the tile rows
    of the batch and the tiles in each, of ``algo`` over ``C`` channels,
    or ValueError if the knobs cannot run.

    ``cout_block`` (channels per block, any positive width that fits),
    ``tiles`` (tiles per block) and ``splits`` (threads per (tile,
    channel), at most 10) are picked where None: the splits by the
    layer's (tile, channel) pairs (``DW_SPLIT_PAIRS``), then the first of
    ``DW_COUT_BLOCKS`` x ``DW_TILE_RUNS`` that makes ``SMS`` blocks, else
    the one with the most blocks.  Cached: the wrapper asks once per layer
    shape.
    """
    return _depthwise_geometry((algo.t, algo.M, algo.L), tuple(n_tiles), C,
                               cout_block, tiles, splits)


@functools.lru_cache(maxsize=1024)
def _depthwise_geometry(tml, n_tiles, C, cout_block, tiles,
                        splits) -> DepthwiseGeometry:
    t, M, L = tml
    for knob, v in (("cout_block", cout_block), ("tiles", tiles),
                    ("splits", splits)):
        if v is not None and v < 1:
            raise ValueError(f"sfc_fused_conv2d: the depthwise {knob} must "
                             f"be positive, got {knob}={v}")
    if splits is not None and splits > max(DW_SPLITS):
        raise ValueError(f"sfc_fused_conv2d: the depthwise splits must be "
                         f"at most {max(DW_SPLITS)}, got splits={splits}")

    def geometry(cb, tc, s):
        return DepthwiseGeometry(t=t, M=M, L=L, tiles=tc, cb=cb, splits=s,
                                 tile_rows=n_tiles[0], tile_cols=n_tiles[1],
                                 channels=C)

    cbs = (cout_block,) if cout_block is not None else DW_COUT_BLOCKS
    tcs = (tiles,) if tiles is not None else tuple(
        tc for tc in DW_TILE_RUNS if tc == 1 or n_tiles[1] % tc == 0)
    if splits is not None:
        ss = (splits,)
    else:
        pairs = n_tiles[0] * n_tiles[1] * C
        want = next((s for limit, s in DW_SPLIT_PAIRS if pairs < limit), 3)
        ss = sorted((s for s in DW_SPLITS if s <= min(want, t)),
                    reverse=True)
    for s in ss:       # the most splits that fit a block
        cands = [g for g in (geometry(cb, tc, s) for cb in cbs for tc in tcs)
                 if _dw_fits(g)]
        if cands:
            return next((g for g in cands if g.blocks >= SMS),
                        max(cands, key=lambda g: g.blocks))
    g = geometry(cbs[-1], min(tcs), ss[-1])
    raise ValueError(
        f"sfc_fused_conv2d: depthwise cout_block={g.cb} needs "
        f"{g.smem_bytes} bytes of shared memory and {g.threads} threads a "
        f"block for t={t} at tiles={g.tiles}, splits={g.splits}; one block "
        f"has {DW_SMEM_LIMIT_BYTES} bytes and {DW_MAX_THREADS} threads")


def sfc_fused_conv2d(x: torch.Tensor, wq: torch.Tensor,
                     act_scale: torch.Tensor, w_scale: torch.Tensor,
                     algo: BilinearAlgorithm, *,
                     padding: str = "SAME", bits: int = 8,
                     k_block: Optional[int] = K_BLOCK,
                     cout_block: Optional[int] = None,
                     n_share: Optional[int] = None,
                     k_split: Optional[int] = None,
                     double_buffer: bool = False,
                     depthwise: bool = False) -> torch.Tensor:
    """int8 SFC convolution in one launch.

    x (B, H, W, Cin) f32; wq (t^2, Cin, Cout) int8; act_scale (t, t);
    w_scale (t, t, Cout) -> (B, H', W', Cout) f32, the same function as
    the staged ``ops.quantized_fastconv2d``.  ``k_block``, ``cout_block``,
    ``n_share`` and ``k_split`` set B4's geometry
    (:func:`fused_geometry`; None picks per layer); every geometry gives
    the same bits.

    ``depthwise`` (wq (t^2, 1, C), w_scale (t, t, C)) runs B7, the
    function of the staged ``ops.quantized_fastconv2d_depthwise``, with
    ``cout_block`` channels per block (:func:`depthwise_geometry`; None
    picks per layer); ``k_block`` has no effect there, as in the JAX
    package: there is no reduction to block.
    """
    name = "sfc_fused_conv2d"
    if double_buffer:
        raise NotImplementedError(
            f"{name}: double_buffer (the TPU's two-slot strip DMA) has no "
            "CUDA counterpart yet")
    if depthwise:
        return sfc_fused_conv2d_depthwise(x, wq, act_scale, w_scale, algo,
                                          padding=padding, bits=bits,
                                          cout_block=cout_block)
    B, H, W, C = x.shape
    t, M, L = algo.t, algo.M, algo.L
    P = t * t
    if wq.dim() != 3 or wq.shape[:2] != (P, C) \
            or act_scale.shape != (t, t) \
            or w_scale.shape != (t, t, wq.shape[2]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, act_scale "
                         f"{tuple(act_scale.shape)}, w_scale "
                         f"{tuple(w_scale.shape)} do not agree for t={t}")
    Cout = wq.shape[2]
    grid = c2d.tile_grid(H, W, M, algo.R, padding)
    geom = fused_geometry(algo, B * grid.nH * grid.nW, C, Cout,
                          k_block=k_block, cout_block=cout_block,
                          n_share=n_share, k_split=k_split)
    if _build.runs_plain(name, x, wq, act_scale, w_scale):
        return ref.sfc_fused_conv2d_ref(x, wq, act_scale, w_scale, algo,
                                        padding, bits)
    _build.require(name, x, "x", torch.float32, 4)
    _build.require(name, wq, "wq", torch.int8, 3)
    _build.require(name, act_scale, "act_scale", torch.float32, 2)
    _build.require(name, w_scale, "w_scale", torch.float32, 3)
    if t > _build.MAX_T or L > _build.MAX_L or M > _build.MAX_M:
        raise ValueError(f"{name}: unsupported tile (t={t}, L={L}, M={M})")
    bt, _, at = c2d.transform_matrices(algo, torch.float32, x.device)
    out = torch.empty((B, grid.out_h, grid.out_w, Cout), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sfc_fused_conv2d_launch(
            x.data_ptr(), wq.data_ptr(), act_scale.data_ptr(),
            w_scale.data_ptr(), bt.data_ptr(), at.data_ptr(), out.data_ptr(),
            B, H, W, C, Cout, M, L, t, grid.lo_h, grid.lo_w, grid.nH,
            grid.nW, grid.out_h, grid.out_w, *geom.launch_args(),
            float(2 ** (bits - 1) - 1), _build.stream_handle(x.device))
    _build.check(err, name)
    sfc_fused_conv2d.launches += 1
    return out


sfc_fused_conv2d.launches = 0


@functools.lru_cache(maxsize=None)
def _host_matrices(algo: BilinearAlgorithm) -> tuple:
    """B^T and A^T as float32 arrays in host memory, which B7 takes by
    value (the same values as ``c2d.transform_matrices``)."""
    return tuple(np.ascontiguousarray(m, dtype=np.float32)
                 for m in (algo.bt(), algo.at()))


def sfc_fused_conv2d_depthwise(x: torch.Tensor, wq: torch.Tensor,
                               act_scale: torch.Tensor,
                               w_scale: torch.Tensor,
                               algo: BilinearAlgorithm, *,
                               padding: str = "SAME", bits: int = 8,
                               cout_block: Optional[int] = None,
                               tiles: Optional[int] = None,
                               splits: Optional[int] = None) -> torch.Tensor:
    """B7: int8 depthwise SFC convolution in one launch.

    x (B, H, W, C) f32; wq (t^2, 1, C) int8; act_scale (t, t);
    w_scale (t, t, C) -> (B, H', W', C) f32.  ``cout_block``, ``tiles``
    and ``splits`` set the geometry (:func:`depthwise_geometry`; None
    picks per layer); every geometry gives the same bits.
    """
    name = "sfc_fused_conv2d_depthwise"
    B, H, W, C = x.shape
    t, M, L = algo.t, algo.M, algo.L
    if wq.shape != (t * t, 1, C) or act_scale.shape != (t, t) \
            or w_scale.shape != (t, t, C):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, act_scale "
                         f"{tuple(act_scale.shape)}, w_scale "
                         f"{tuple(w_scale.shape)} do not agree for t={t}")
    grid = c2d.tile_grid(H, W, M, algo.R, padding)
    geom = depthwise_geometry(algo, (B * grid.nH, grid.nW), C, cout_block,
                              tiles=tiles, splits=splits)
    if _build.runs_plain(name, x, wq, act_scale, w_scale):
        return ref.sfc_fused_conv2d_ref(x, wq, act_scale, w_scale, algo,
                                        padding, bits, depthwise=True)
    _build.require(name, x, "x", torch.float32, 4)
    _build.require(name, wq, "wq", torch.int8, 3)
    _build.require(name, act_scale, "act_scale", torch.float32, 2)
    _build.require(name, w_scale, "w_scale", torch.float32, 3)
    if t > _build.MAX_T or L > _build.MAX_L or M > _build.MAX_M:
        raise ValueError(f"{name}: unsupported tile (t={t}, L={L}, M={M})")
    bt, at = _host_matrices(algo)
    out = torch.empty((B, grid.out_h, grid.out_w, C), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sfc_fused_conv2d_depthwise_launch(
            x.data_ptr(), wq.data_ptr(), act_scale.data_ptr(),
            w_scale.data_ptr(), bt.ctypes.data, at.ctypes.data, out.data_ptr(),
            B, H, W, C, M, L, t, grid.lo_h, grid.lo_w, grid.nH, grid.nW,
            grid.out_h, grid.out_w, *geom.launch_args(),
            float(2 ** (bits - 1) - 1),
            _build.stream_handle(x.device))
    _build.check(err, name)
    sfc_fused_conv2d_depthwise.launches += 1
    return out


sfc_fused_conv2d_depthwise.launches = 0
