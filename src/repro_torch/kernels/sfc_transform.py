"""B1: SFC input transform + per-frequency int8 quantization, and B5: the
same transform in f32 without quantization (the fp path).

The ports of ``repro/kernels/sfc_transform.py::_transform_quant_kernel``
and ``::_transform_kernel``, as the CUDA kernels of
``csrc/sfc_transform.cu``.  Unlike the Pallas kernels they read the
overlapping tiles straight from the NHWC input (no tile tensor), with the
SAME/VALID zero padding filled in as each block stages its input region.

B1 has two entries, one kernel and one launch count
(``sfc_transform_quantize.launches``): ``sfc_transform_quantize`` keeps the
JAX kernel's contract, int8 (T, t, t, C); ``sfc_transform_quantize_pt``
writes the (P, T, C) layout the staged GEMM and the depthwise product read.

Each launch takes its geometry from :func:`transform_geometry`, computed
here per layer (cached) and only checked by the kernel.  The kernels take
B^T and B1's scales by value: each is read from the card once per tensor
(a synchronisation), then kept in host memory while the tensor lives and
is not written to.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.core import conv2d as c2d
from repro_torch.kernels import _build, ref

SMS = 132           # the H100's SMs: a wave of blocks
# shared memory one block may use on an H100, less the kernel's static
# part (an mbarrier, rounded up to 2 KB); kMaxSmem in csrc/sfc_transform.cu
TRANSFORM_STATIC_SMEM_BYTES = 2048
TRANSFORM_SMEM_LIMIT_BYTES = 232448 - TRANSFORM_STATIC_SMEM_BYTES
TRANSFORM_MAX_THREADS = 512     # kMaxThreads in csrc/sfc_transform.cu
# The auto geometry, from chip_smoke.py --sweep-b1 on an H100 (PERF.md).
# Rows per thread by the layer's (tile, channel) pairs: one (t threads per
# (tile, channel)) below 16384 pairs, two below 32768, three below 65536,
# else five: a small layer waits on each thread's chain of loads and
# arithmetic, a large one on throughput.  Then 32 channels a block (128
# bytes of f32 a pixel), or 16 where 32 makes fewer than SMS blocks (the
# layer's C where it is below 16), and the shortest run of tiles that
# gives a block TRANSFORM_MIN_THREADS threads; within
# TRANSFORM_MAX_THREADS threads a block, with fewer threads per (tile,
# channel) where needed.
TRANSFORM_ROWS = ((16384, 1), (32768, 2), (65536, 3))
TRANSFORM_MAX_ROWS = 5
TRANSFORM_CHANNEL_BLOCKS = (32, 16)
TRANSFORM_TILE_RUNS = (1, 2, 4, 8)
TRANSFORM_MIN_THREADS = 64


def _align128(n: int) -> int:
    return -(-n // 128) * 128


@dataclasses.dataclass(frozen=True)
class TransformGeometry:
    """B1's and B5's launch geometry for one layer: computed here once and
    passed to ``csrc/sfc_transform.cu``, which only checks it.

    A block owns a run of ``tiles`` tiles along one tile row (tile columns
    ``tiles * r`` on; the last run of a row may be short) and ``cb``
    channels; ``splits`` threads per (tile, channel) take its transform
    rows u = g, g + splits, ...  It stages the run's input region, L x
    ``region_w`` pixels of ``cb`` channels, in shared memory.  Grid:
    ((image, tile row) x runs, channel blocks).
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
        """Dynamic shared memory: the input region (f32) on 128 bytes, and
        128 to align it (the formula of the check in
        csrc/sfc_transform.cu)."""
        return 128 + _align128(4 * self.L * self.region_w * self.cb)

    def rows_of(self, g: int) -> range:
        """The transform rows thread ``g`` of a (tile, channel) takes."""
        return range(g, self.t, self.splits)

    def block_tiles(self, bx: int) -> list:
        """The (tile row, tile column) of each tile block ``bx`` owns."""
        row, run = divmod(bx, self.runs)
        return [(row, c) for c in range(run * self.tiles,
                                        min((run + 1) * self.tiles,
                                            self.tile_cols))]

    def launch_args(self) -> tuple:
        """(tiles, cb, splits, threads, smem, grid_x, grid_y) as the C
        entry points take them."""
        return (self.tiles, self.cb, self.splits, self.threads,
                self.smem_bytes, *self.grid)


def _fits(g: TransformGeometry) -> bool:
    return (g.threads <= TRANSFORM_MAX_THREADS
            and g.smem_bytes <= TRANSFORM_SMEM_LIMIT_BYTES
            and g.region_w <= 256 and g.grid[1] <= 65535)


def transform_geometry(algo, n_tiles: tuple, C: int, *,
                       channel_block: Optional[int] = None,
                       tiles: Optional[int] = None,
                       splits: Optional[int] = None) -> TransformGeometry:
    """B1's and B5's geometry for the tiles ``n_tiles`` = (B nH, nW), the
    tile rows of the batch and the tiles in each, of ``algo`` (anything
    with ``t``, ``M`` and ``L``) over ``C`` channels, or ValueError if the
    knobs cannot run.

    ``channel_block`` (channels per block, any positive width that fits),
    ``tiles`` (tiles per block) and ``splits`` (threads per (tile,
    channel), 1 to t) are picked where None (``TRANSFORM_ROWS``,
    ``TRANSFORM_CHANNEL_BLOCKS``, ``TRANSFORM_TILE_RUNS``,
    ``TRANSFORM_MIN_THREADS``).  Every geometry gives the same bits.
    Cached: the wrappers ask once per layer shape.
    """
    return _transform_geometry((algo.t, algo.M, algo.L), tuple(n_tiles), C,
                               channel_block, tiles, splits)


@functools.lru_cache(maxsize=1024)
def _transform_geometry(tml, n_tiles, C, channel_block, tiles,
                        splits) -> TransformGeometry:
    t, M, L = tml
    for knob, v in (("channel_block", channel_block), ("tiles", tiles),
                    ("splits", splits)):
        if v is not None and v < 1:
            raise ValueError(f"sfc_transform: the {knob} must be positive, "
                             f"got {knob}={v}")
    if splits is not None and splits > t:
        raise ValueError(f"sfc_transform: the splits must be at most t={t}, "
                         f"got splits={splits}")

    def geometry(cb, tc, s):
        return TransformGeometry(t=t, M=M, L=L, tiles=tc, cb=cb, splits=s,
                                 tile_rows=n_tiles[0], tile_cols=n_tiles[1],
                                 channels=C)

    tcs = (tiles,) if tiles is not None else TRANSFORM_TILE_RUNS
    if splits is not None:
        ss = (splits,)
    else:
        pairs = n_tiles[0] * n_tiles[1] * C
        rows = next((r for limit, r in TRANSFORM_ROWS if pairs < limit),
                    TRANSFORM_MAX_ROWS)
        # then fewer threads where a block cannot take them
        ss = tuple(dict.fromkeys(-(-t // r) for r in range(rows, t + 1)))
    if channel_block is not None:
        cbs = (channel_block,)
    else:
        cbs = (C,) if C < 16 else TRANSFORM_CHANNEL_BLOCKS
    for s in ss:
        cands = []
        for cb in cbs:      # the shortest run of tiles that fills a block
            fit = [g for g in (geometry(cb, tc, s) for tc in tcs)
                   if _fits(g)]
            full = [g for g in fit if g.splits * g.tiles * g.cb
                    >= TRANSFORM_MIN_THREADS]
            if full or fit:
                cands.append((full or fit[::-1])[0])
        if cands:
            return next((g for g in cands if g.blocks >= SMS),
                        max(cands, key=lambda g: g.blocks))
    g = geometry(cbs[-1], min(tcs), ss[-1])
    raise ValueError(
        f"sfc_transform: channel_block={g.cb} needs {g.smem_bytes} bytes of "
        f"shared memory and {g.threads} threads a block for t={t} at "
        f"tiles={g.tiles}, splits={g.splits}; one block has "
        f"{TRANSFORM_SMEM_LIMIT_BYTES} bytes and {TRANSFORM_MAX_THREADS} "
        f"threads")


# B^T and B1's scales in host memory, which the kernels take by value: read
# from the card once per tensor (``c2d.transform_matrices`` caches one B^T
# per algorithm and device; a prepared layer keeps its scales) and again
# only if it was written to since
_HOST: dict = {}
_HOST_LOCK = threading.Lock()


def _host_copy(t: torch.Tensor) -> np.ndarray:
    key = id(t)
    with _HOST_LOCK:
        hit = _HOST.get(key)
        if hit is not None and hit[0]() is t and hit[1] == t._version:
            return hit[2]
    host = np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float32)
    with _HOST_LOCK:
        _HOST[key] = (weakref.ref(t), t._version, host)
        weakref.finalize(t, _HOST.pop, key, None)
    return host


def _geometry_of(name, x, bt, M, padding, knobs):
    """(t, L, tile grid, launch geometry) of a call, or ValueError."""
    t, L = bt.shape
    if t > _build.MAX_T or L > _build.MAX_L or not 0 < M <= L:
        raise ValueError(f"{name}: unsupported tile (t={t}, L={L}, M={M})")
    B, H, W, C = x.shape
    grid = c2d.tile_grid(H, W, M, L - M + 1, padding)
    return t, L, grid, _transform_geometry((t, M, L), (B * grid.nH, grid.nW),
                                           C, *knobs)


def _launch(name, x, bt, M, padding, knobs, scale=None, bits=8, pt=False):
    """Check the operands, allocate the output, launch B1 (with ``scale``)
    or B5."""
    t, L, grid, geom = _geometry_of(name, x, bt, M, padding, knobs)
    _build.require(name, x, "x", torch.float32, 4)
    _build.require(name, bt, "bt", torch.float32, 2)
    B, H, W, C = x.shape
    T = B * grid.nH * grid.nW
    if scale is not None:
        _build.require(name, scale, "scale", torch.float32, 2)
        if scale.shape != (t, t):
            raise ValueError(f"{name}: scale {tuple(scale.shape)} is not "
                             f"({t}, {t})")
    out = torch.empty((t * t, T, C) if pt else (T, t, t, C),
                      dtype=torch.float32 if scale is None else torch.int8,
                      device=x.device)
    host_bt = _host_copy(bt)
    lib = _build.library()
    common = (B, H, W, C, M, L, t, grid.lo_h, grid.lo_w, grid.nH, grid.nW,
              *geom.launch_args())
    with torch.cuda.device(x.device):
        stream = _build.stream_handle(x.device)
        if scale is None:
            err = lib.sfc_transform_launch(
                x.data_ptr(), host_bt.ctypes.data, out.data_ptr(), *common,
                stream)
        else:
            err = lib.sfc_transform_quantize_launch(
                x.data_ptr(), host_bt.ctypes.data, scale.data_ptr(),
                _host_copy(scale).ctypes.data, out.data_ptr(), *common,
                float(2 ** (bits - 1) - 1), int(pt), stream)
    _build.check(err, name)
    return out


def sfc_transform(x: torch.Tensor, bt: torch.Tensor, M: int, *,
                  padding: str = "SAME", channel_block: Optional[int] = None,
                  tiles: Optional[int] = None,
                  splits: Optional[int] = None) -> torch.Tensor:
    """x (B,H,W,C) f32, bt (t,L) f32 -> f32 (B*nH*nW, t, t, C).

    The tiles are those of :func:`sfc_transform_quantize`, and each value
    is exactly the one that kernel quantizes on the card.  The knobs set
    the geometry (:func:`transform_geometry`; None picks per layer).
    """
    name = "sfc_transform"
    knobs = (channel_block, tiles, splits)
    if _build.runs_plain(name, x, bt):
        _geometry_of(name, x, bt, M, padding, knobs)
        return ref.sfc_transform_nhwc_ref(x, bt, M, padding)
    out = _launch(name, x, bt, M, padding, knobs)
    sfc_transform.launches += 1
    return out


sfc_transform.launches = 0



def sfc_transform_quantize(x: torch.Tensor, bt: torch.Tensor,
                           scale: torch.Tensor, M: int, *,
                           padding: str = "SAME", bits: int = 8,
                           channel_block: Optional[int] = None,
                           tiles: Optional[int] = None,
                           splits: Optional[int] = None) -> torch.Tensor:
    """x (B,H,W,C) f32, bt (t,L) f32, scale (t,t) f32 -> int8 (B*nH*nW,t,t,C).

    Tiles of L = M + R - 1 rows at stride M cover the SAME/VALID output
    grid (``c2d.tile_grid``), ordered (image, tile row, tile column).  The
    knobs set the geometry (:func:`transform_geometry`; None picks per
    layer); every geometry gives the same bits.
    """
    name = "sfc_transform_quantize"
    knobs = (channel_block, tiles, splits)
    if _build.runs_plain(name, x, bt, scale):
        _geometry_of(name, x, bt, M, padding, knobs)
        return ref.sfc_transform_quantize_nhwc_ref(x, bt, scale, M, padding,
                                                   bits)
    out = _launch(name, x, bt, M, padding, knobs, scale, bits)
    sfc_transform_quantize.launches += 1
    return out


sfc_transform_quantize.launches = 0


def sfc_transform_quantize_pt(x: torch.Tensor, bt: torch.Tensor,
                              scale: torch.Tensor, M: int, *,
                              padding: str = "SAME", bits: int = 8,
                              channel_block: Optional[int] = None,
                              tiles: Optional[int] = None,
                              splits: Optional[int] = None) -> torch.Tensor:
    """:func:`sfc_transform_quantize` written as int8 (t^2, B*nH*nW, C),
    position-major: the layout ``tdmm_int8`` and ``tdmm_int8_depthwise``
    read.  The same kernel and launch count
    (``sfc_transform_quantize.launches``)."""
    name = "sfc_transform_quantize"
    knobs = (channel_block, tiles, splits)
    if _build.runs_plain(name, x, bt, scale):
        _geometry_of(name, x, bt, M, padding, knobs)
        return ref.sfc_transform_quantize_pt_ref(x, bt, scale, M, padding,
                                                 bits)
    out = _launch(name, x, bt, M, padding, knobs, scale, bits, pt=True)
    sfc_transform_quantize.launches += 1
    return out
