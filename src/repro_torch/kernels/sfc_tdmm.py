"""B2: transform-domain int8 matmul with fused dequant, and B6: its
depthwise counterpart, the elementwise int8 product with the dequant.

B2 is the port of ``repro/kernels/sfc_tdmm.py::_tdmm_kernel`` and
``::_tdmm_kblock_kernel``, as one CUDA kernel (``csrc/sfc_tdmm.cu``): for
each of the P = t^2 positions an int8 tensor-core GEMM accumulated in
int32 over the whole K, dequantized in the epilogue.  B6 is the port of
``::_tdmm_dw_kernel`` (``csrc/sfc_tdmm_dw.cu``), CUDA-core work with no
contraction.

Each launch takes its geometry from :func:`tdmm_geometry` (B2) or
:func:`dw_product_geometry` (B6), computed here per layer (cached) and only
checked by the kernel.  Every geometry gives the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

SMS = 132                   # the H100's SMs: a wave of blocks
SMEM_PER_SM = 233472        # shared memory of an SM, bytes
REGISTERS_PER_SM = 65536
THREADS_PER_SM = 2048
# B2's kernels (csrc/sfc_tdmm.cu, one TDMM_CASE each) as (bm, bn, bk,
# vec_a, vec_b): vec_a where K, vec_b where N is a multiple of 16 (16-byte
# copies); the byte-wise variants exist at bk = 32 and bn = 64 only
TDMM_KERNELS = frozenset(
    [(bm, bn, bk, True, True) for bm in (16, 32, 64, 128)
     for bn in (64, 128) for bk in (32, 64)]
    + [(bm, 64, 32, va, vb) for va, vb in ((False, True), (True, False),
                                           (False, False))
       for bm in (16, 32, 64, 128)])
TDMM_MAX_STAGES = 6         # kMaxStages in csrc/sfc_tdmm.cu
TDMM_REGISTERS = 128        # a thread's register budget: kRegisters there
# The auto geometry, from chip_smoke.py --sweep-b2 on an H100 (PERF.md):
# rows a block, the least of 16 and 32 that hold the layer's tiles, else
# 128 up to 128 tiles and 256 columns (one block a column tile holds the
# layer), else 64; 128 columns where N is at least 256, or above 64 with
# at most 128 tiles, else 64; 64-deep K steps where K allows; TDMM_STAGES
# slots in the ring; runs of TDMM_TILE_RUN row tiles a block where the
# layer has at least TDMM_RUN_FROM of them.
TDMM_ROW_TILES = (16, 32, 64, 128)
TDMM_STAGES = 4
TDMM_TILE_RUN = 2
TDMM_RUN_FROM = 8


def resident_blocks(threads: int, smem_bytes: int = 0,
                    registers: int = 0) -> int:
    """Blocks of ``threads`` threads, ``smem_bytes`` of dynamic shared
    memory and ``registers`` registers a thread that one SM holds at once
    (1 KB of shared memory reserved a block, at most 32 blocks)."""
    n = min(THREADS_PER_SM // threads, SMEM_PER_SM // (smem_bytes + 1024),
            32)
    if registers:
        n = min(n, REGISTERS_PER_SM // (threads * registers))
    return n


def waves(blocks: int, resident: int) -> int:
    """Waves of ``blocks`` over the H100's SMS SMs, ``resident`` a SM (at
    least one): the cost model's count of a launch's sequential block
    rounds."""
    return -(-blocks // (SMS * max(1, resident)))


@dataclasses.dataclass(frozen=True)
class TdmmGeometry:
    """B2's launch geometry for one layer: computed here once and passed
    to ``csrc/sfc_tdmm.cu``, which only checks it.

    A block owns ``bn`` columns of Y[p] and ``tiles`` consecutive row tiles
    of ``bm`` rows (the layer's tiles), and walks each row tile's K in
    ``bk``-deep steps, one sequence of (row tile, K step) items through a
    ring of ``stages`` slots in shared memory.  Grid: (column tiles, runs
    of row tiles, P).
    """

    P: int
    T: int
    K: int
    N: int
    bm: int
    bn: int
    bk: int
    stages: int
    tiles: int

    @property
    def vec_a(self) -> bool:
        """X by 16-byte copies (K a multiple of 16), else by bytes."""
        return self.K % 16 == 0

    @property
    def vec_b(self) -> bool:
        """W by 16-byte copies and Y by 16-byte stores (N a multiple of
        16), else by bytes and floats."""
        return self.N % 16 == 0

    @property
    def warps(self) -> tuple:
        """(warps_m, warps_n): the block's warps over rows and columns."""
        return {16: (1, 4), 128: (4, 2)}.get(self.bm, (2, 2))

    @property
    def threads(self) -> int:
        return 32 * self.warps[0] * self.warps[1]

    @property
    def row_tiles(self) -> int:
        return -(-self.T // self.bm)

    @property
    def grid(self) -> tuple:
        return (-(-self.N // self.bn), -(-self.row_tiles // self.tiles),
                self.P)

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    @property
    def ksteps(self) -> int:
        return -(-self.K // self.bk)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory: min(stages, a block's items) slots of a
        bm x bk tile of X and a bk x bn tile of W (the check in
        csrc/sfc_tdmm.cu)."""
        return min(self.stages, self.tiles * self.ksteps) * (
            self.bm * self.bk + self.bk * self.bn)

    @property
    def resident(self) -> int:
        """Blocks an SM holds at once: by threads, by the declared
        register budget and by shared memory (1 KB a block reserved)."""
        return resident_blocks(self.threads, self.smem_bytes, TDMM_REGISTERS)

    @property
    def waves(self) -> int:
        return waves(self.blocks, self.resident)

    def compute_ops(self) -> dict:
        """Operations of the launch: the int8 products (a multiply-add is
        two) and the f32 dequantization (two a value)."""
        return {"int8": 2 * self.P * self.T * self.K * self.N,
                "f32": 2 * self.P * self.T * self.N}

    def hbm_bytes(self) -> dict:
        """Bytes the launch reads and writes: X once per column tile, W
        once per run of row tiles, the scales, Y (f32)."""
        gx, gy, _ = self.grid
        x = gx * self.P * self.T * self.K
        w = gy * self.P * self.K * self.N
        scales = 4 * self.P * (self.N + 1)
        y = 4 * self.P * self.T * self.N
        return {"x": x, "w": w, "scales": scales, "y": y,
                "total": x + w + scales + y}

    def block_tile(self, bx: int, by: int, bz: int) -> tuple:
        """(p, rows, columns) of Y that block (bx, by, bz) writes."""
        rows = self.tiles * self.bm
        return (bz, range(by * rows, min(self.T, (by + 1) * rows)),
                range(bx * self.bn, min(self.N, (bx + 1) * self.bn)))

    def launch_args(self) -> tuple:
        """(bm, bn, bk, stages, tiles, smem) as the C entry point takes
        them."""
        return (self.bm, self.bn, self.bk, self.stages, self.tiles,
                self.smem_bytes)


def tdmm_geometry(P: int, T: int, K: int, N: int, *,
                  block_m: Optional[int] = None,
                  block_n: Optional[int] = None,
                  block_k: Optional[int] = None,
                  stages: Optional[int] = None,
                  tiles: Optional[int] = None) -> TdmmGeometry:
    """B2's geometry for X (P, T, K) x W (P, K, N), or ValueError if the
    knobs name no compiled kernel.

    ``block_m`` (16, 32, 64, 128), ``block_n`` (64, 128), ``block_k`` (32,
    64), ``stages`` (2 to ``TDMM_MAX_STAGES``) and ``tiles`` (row tiles a
    block, at most the layer's) are picked where None (``TDMM_ROW_TILES``,
    ``TDMM_STAGES``, ``TDMM_TILE_RUN``, ``TDMM_RUN_FROM``).  Cached: the
    wrapper asks once per layer shape.
    """
    return _tdmm_geometry(P, T, K, N, block_m, block_n, block_k, stages,
                          tiles)


@functools.lru_cache(maxsize=1024)
def _tdmm_geometry(P, T, K, N, block_m, block_n, block_k, stages,
                   tiles) -> TdmmGeometry:
    vec = K % 16 == 0 and N % 16 == 0
    if stages is not None and not 2 <= stages <= TDMM_MAX_STAGES:
        raise ValueError(f"tdmm_int8: stages must lie in [2, "
                         f"{TDMM_MAX_STAGES}], got stages={stages}")
    if tiles is not None and tiles < 1:
        raise ValueError(f"tdmm_int8: tiles must be positive, got "
                         f"tiles={tiles}")
    if block_m is not None and block_m not in TDMM_ROW_TILES:
        raise ValueError(f"tdmm_int8: no kernel for block_m={block_m} "
                         f"(block_m is one of {TDMM_ROW_TILES})")
    bk = block_k or (64 if vec and K > 32 else 32)
    if block_m is not None:
        bm = block_m
    elif T <= 32:
        bm = 16 if T <= 16 else 32
    else:
        bm = 128 if T <= 128 and N <= 256 else 64
    bn = block_n or (128 if vec and (N >= 256 or N > 64 and T <= 128)
                     else 64)
    run = tiles or (TDMM_TILE_RUN if -(-T // bm) >= TDMM_RUN_FROM else 1)
    g = TdmmGeometry(P=P, T=T, K=K, N=N, bm=bm, bn=bn, bk=bk,
                     stages=stages or TDMM_STAGES,
                     tiles=max(1, min(run, -(-T // bm))))
    if (g.bm, g.bn, g.bk, g.vec_a, g.vec_b) not in TDMM_KERNELS:
        raise ValueError(
            f"tdmm_int8: no kernel for block_m={g.bm}, block_n={g.bn}, "
            f"block_k={g.bk} at K={K}, N={N} (K and N multiples of 16 "
            f"take block_m 16, 32, 64 or 128, block_n 64 or 128, block_k "
            f"32 or 64; others block_n=64, block_k=32)")
    return g


def tdmm_int8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
              sw: torch.Tensor, *, k_block: Optional[int] = None,
              block_m: Optional[int] = None, block_n: Optional[int] = None,
              block_k: Optional[int] = None, stages: Optional[int] = None,
              tiles: Optional[int] = None) -> torch.Tensor:
    """X (P, T, K) int8 x W (P, K, N) int8 -> (P, T, N) f32.

    Y[p] = float(X[p] @ W[p]) * (sx[p] * sw[p, :]).  ``k_block`` is kept
    for parity with the JAX wrapper, whose k-blocked Pallas kernel splits K
    to fit VMEM; it has no effect here: the CUDA kernel accumulates in int32
    registers across all of K, so every ``k_block`` gives the same result.
    ``block_m``, ``block_n``, ``block_k``, ``stages`` and ``tiles``
    override the launch geometry (:func:`tdmm_geometry`); every geometry
    gives the same bits.
    """
    name = "tdmm_int8"
    if k_block is not None and k_block < 1:
        raise ValueError(f"{name}: k_block must be positive or None, got "
                         f"{k_block}")
    P, T, K = xq.shape
    N = wq.shape[2]
    if wq.shape != (P, K, N) or sx.shape != (P,) or sw.shape != (P, N):
        raise ValueError(f"{name}: shapes X {tuple(xq.shape)}, W "
                         f"{tuple(wq.shape)}, sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)} do not agree")
    geom = tdmm_geometry(P, T, K, N, block_m=block_m, block_n=block_n,
                         block_k=block_k, stages=stages, tiles=tiles)
    if _build.runs_plain(name, xq, wq, sx, sw):
        return ref.tdmm_int8_ref(xq, wq, sx, sw)
    _build.require(name, xq, "xq", torch.int8, 3)
    _build.require(name, wq, "wq", torch.int8, 3)
    _build.require(name, sx, "sx", torch.float32, 1)
    _build.require(name, sw, "sw", torch.float32, 2)
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"{name}: X and W must start on 16-byte boundaries")
    out = torch.empty((P, T, N), dtype=torch.float32, device=xq.device)
    lib = _build.library()
    with torch.cuda.device(xq.device):
        err = lib.tdmm_int8_launch(
            xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            out.data_ptr(), P, T, K, N, *geom.launch_args(),
            _build.stream_handle(xq.device))
    _build.check(err, name)
    tdmm_int8.launches += 1
    return out


tdmm_int8.launches = 0

# B6's auto geometry, from chip_smoke.py --sweep-b2 on an H100 (PERF.md):
# small blocks, twice the layer's 16-channel groups up to DW_GROUPS (a
# thread then takes 8 of a small layer's channels) times lanes of tiles up
# to DW_THREADS threads (no more lanes than tiles), and the longest run of
# tiles a thread in DW_RUNS that still gives DW_MIN_BLOCKS blocks
DW_GROUPS = 16
DW_THREADS = 64
DW_RUNS = (4, 2, 1)
DW_MIN_BLOCKS = 8 * SMS
DW_MAX_THREADS = 512        # kMaxThreads in csrc/sfc_tdmm_dw.cu


@dataclasses.dataclass(frozen=True)
class DwProductGeometry:
    """B6's launch geometry for one layer: computed here once and passed
    to ``csrc/sfc_tdmm_dw.cu``, which only checks it.

    A thread owns 16 channels of one position and ``run`` tiles; a block is
    ``groups`` threads over a span of 16 ``groups`` channels (thread x
    takes the 4-channel chunks at 4 x + 4 groups q, q = 0 .. 3) x ``lanes``
    lanes of tiles, lane l taking tiles l, l + lanes, ... of the block's
    ``lanes * run``.  Grid: (runs of tiles, channel spans, P).
    """

    P: int
    T: int
    C: int
    groups: int
    lanes: int
    run: int

    @property
    def threads(self) -> int:
        return self.groups * self.lanes

    @property
    def grid(self) -> tuple:
        return (-(-self.T // (self.lanes * self.run)),
                -(-self.C // (16 * self.groups)), self.P)

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    @property
    def waves(self) -> int:
        return waves(self.blocks, resident_blocks(self.threads))

    def compute_ops(self) -> dict:
        """The int32 products and their dequantization, on CUDA cores
        (counted as f32 operations, two a value)."""
        return {"int8": 0, "f32": 2 * self.P * self.T * self.C}

    def hbm_bytes(self) -> dict:
        """X (int8) and W (int8) read, the scales, Y (f32) written."""
        x = self.P * self.T * self.C
        w = self.P * self.C
        scales = 4 * self.P * (self.C + 1)
        y = 4 * self.P * self.T * self.C
        return {"x": x, "w": w, "scales": scales, "y": y,
                "total": x + w + scales + y}

    def thread_items(self, bx: int, by: int, bz: int, x: int,
                     y: int) -> tuple:
        """(p, tiles, channels) thread (x, y) of block (bx, by, bz) takes."""
        span = 16 * self.groups * by
        chans = [c for q in range(4)
                 for c in range(span + 4 * self.groups * q + 4 * x,
                                span + 4 * self.groups * q + 4 * x + 4)
                 if c < self.C]
        t0 = bx * self.lanes * self.run + y
        return (bz, range(t0, min(self.T, t0 + self.run * self.lanes),
                          self.lanes), chans)

    def launch_args(self) -> tuple:
        """(groups, lanes, run) as the C entry point takes them."""
        return (self.groups, self.lanes, self.run)


def dw_product_geometry(P: int, T: int, C: int, *,
                        groups: Optional[int] = None,
                        lanes: Optional[int] = None,
                        run: Optional[int] = None) -> DwProductGeometry:
    """B6's geometry for X (P, T, C), or ValueError if the knobs cannot
    run.  ``groups`` (threads over a block's channels, 16 each), ``lanes``
    (tiles a block takes at once) and ``run`` (tiles a thread) are picked
    where None (``DW_GROUPS``, ``DW_THREADS``, ``DW_RUNS``,
    ``DW_MIN_BLOCKS``).  Cached: the wrapper asks once per layer shape."""
    return _dw_product_geometry(P, T, C, groups, lanes, run)


@functools.lru_cache(maxsize=1024)
def _dw_product_geometry(P, T, C, groups, lanes, run) -> DwProductGeometry:
    for knob, v in (("groups", groups), ("lanes", lanes), ("run", run)):
        if v is not None and v < 1:
            raise ValueError(f"tdmm_int8_depthwise: the {knob} must be "
                             f"positive, got {knob}={v}")
    gx = groups or min(2 * -(-C // 16), DW_GROUPS)
    ty = lanes or max(1, min(DW_THREADS // gx, T))
    if gx * ty > DW_MAX_THREADS:
        raise ValueError(f"tdmm_int8_depthwise: groups={gx} x lanes={ty} "
                         f"is more than {DW_MAX_THREADS} threads a block")

    def geometry(r):
        return DwProductGeometry(P=P, T=T, C=C, groups=gx, lanes=ty, run=r)

    if run is not None:
        return geometry(run)
    return next((g for g in map(geometry, DW_RUNS)
                 if g.blocks >= DW_MIN_BLOCKS), geometry(DW_RUNS[-1]))


def tdmm_int8_depthwise(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                        sw: torch.Tensor, *, groups: Optional[int] = None,
                        lanes: Optional[int] = None,
                        run: Optional[int] = None) -> torch.Tensor:
    """X (P, T, C) int8 x W (P, C) int8 -> (P, T, C) f32, elementwise.

    Y[p, t, c] = float(X[p, t, c] * W[p, c]) * (sx[p] * sw[p, c]): the
    int32 product is exact, and the dequant is the fused depthwise
    kernel's, so both depthwise datapaths give the same f32 values.
    ``groups``, ``lanes`` and ``run`` override the launch geometry
    (:func:`dw_product_geometry`); every geometry gives the same bits.
    """
    name = "tdmm_int8_depthwise"
    P, T, C = xq.shape
    if wq.shape != (P, C) or sx.shape != (P,) or sw.shape != (P, C):
        raise ValueError(f"{name}: shapes X {tuple(xq.shape)}, W "
                         f"{tuple(wq.shape)}, sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)} do not agree")
    geom = dw_product_geometry(P, T, C, groups=groups, lanes=lanes, run=run)
    if _build.runs_plain(name, xq, wq, sx, sw):
        return ref.tdmm_int8_depthwise_ref(xq, wq, sx, sw)
    _build.require(name, xq, "xq", torch.int8, 3)
    _build.require(name, wq, "wq", torch.int8, 2)
    _build.require(name, sx, "sx", torch.float32, 1)
    _build.require(name, sw, "sw", torch.float32, 2)
    out = torch.empty((P, T, C), dtype=torch.float32, device=xq.device)
    lib = _build.library()
    with torch.cuda.device(xq.device):
        err = lib.tdmm_int8_depthwise_launch(
            xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            out.data_ptr(), P, T, C, *geom.launch_args(),
            _build.stream_handle(xq.device))
    _build.check(err, name)
    tdmm_int8_depthwise.launches += 1
    return out


tdmm_int8_depthwise.launches = 0
