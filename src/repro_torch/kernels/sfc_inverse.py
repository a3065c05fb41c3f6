"""B3: SFC inverse transform A^T Y A.

The port of ``repro/kernels/sfc_inverse.py::_inverse_kernel``, as the CUDA
kernel ``csrc/sfc_inverse.cu``.  A^T carries the correction-term columns,
so the circular -> linear conversion of paper §4.2 happens inside the same
contraction.

Two entries, one kernel and one launch count (``sfc_inverse.launches``):
``sfc_inverse`` is the JAX kernel's contract, (nT, t, t, O) in and
(nT, M, M, O) out; ``sfc_inverse_nhwc`` reads Y where the product before it
left it, (P, nT, O) or (nT, t, t, O), and writes the cropped NHWC output
through the tile grid, so the staged and fp paths copy nothing around it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import conv2d as c2d
from repro_torch.kernels import _build, ref
from repro_torch.kernels.sfc_tdmm import waves

# B3's launch, fixed in csrc/sfc_inverse.cu: kThreads threads a block,
# kSplits threads a (tile, channel), __launch_bounds__(kThreads, 3)
INVERSE_THREADS = 128
INVERSE_SPLITS = 2
INVERSE_RESIDENT = 3


@dataclasses.dataclass(frozen=True)
class InverseGeometry:
    """B3's launch for ``n_tiles`` tiles of ``channels`` channels: the
    grid ``csrc/sfc_inverse.cu`` computes itself, as data for the cost
    model (B3 takes no geometry from the wrapper)."""

    t: int
    M: int
    n_tiles: int
    channels: int

    @property
    def blocks(self) -> int:
        splits = min(INVERSE_SPLITS, self.M)
        return -(-self.n_tiles * splits * self.channels // INVERSE_THREADS)

    @property
    def waves(self) -> int:
        return waves(self.blocks, INVERSE_RESIDENT)

    def compute_ops(self) -> dict:
        """f32 operations of A^T Y A for every (tile, channel), dense A^T
        (a multiply-add is two)."""
        t, M = self.t, self.M
        return {"int8": 0, "f32": self.n_tiles * self.channels
                * (2 * M * t * t + 2 * M * M * t)}

    def hbm_bytes(self) -> dict:
        """Y (f32) read once, the M x M outputs a tile (f32) written."""
        y = 4 * self.t * self.t * self.n_tiles * self.channels
        out = 4 * self.M * self.M * self.n_tiles * self.channels
        return {"y": y, "out": out, "total": y + out}


def _launch(name, y, at, out, n_tiles, O, t, M, tile_stride, pos_stride,
            grid=None):
    lib = _build.library()
    nH, nW, out_h, out_w = (grid.nH, grid.nW, grid.out_h, grid.out_w) \
        if grid is not None else (0, 0, 0, 0)
    with torch.cuda.device(y.device):
        err = lib.sfc_inverse_launch(
            y.data_ptr(), at.data_ptr(), out.data_ptr(), n_tiles, O, t, M,
            tile_stride, pos_stride, int(grid is not None), nH, nW, out_h,
            out_w, _build.stream_handle(y.device))
    _build.check(err, name)
    sfc_inverse.launches += 1
    return out


def _check_at(name, at, t):
    _build.require(name, at, "at", torch.float32, 2)
    M = at.shape[0]
    if at.shape[1] != t or t > _build.MAX_T or M > _build.MAX_M:
        raise ValueError(f"{name}: unsupported shapes t={t}, at "
                         f"{tuple(at.shape)}")
    return M


def sfc_inverse(ty: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """(nT, t, t, O) f32, at (M, t) f32 -> (nT, M, M, O) f32."""
    name = "sfc_inverse"
    if _build.runs_plain(name, ty, at):
        return ref.sfc_inverse_ref(ty, at)
    _build.require(name, ty, "ty", torch.float32, 4)
    nT, t, _, O = ty.shape
    M = _check_at(name, at, t)
    if ty.shape[2] != t:
        raise ValueError(f"{name}: unsupported shapes ty {tuple(ty.shape)}, "
                         f"at {tuple(at.shape)}")
    out = torch.empty((nT, M, M, O), dtype=torch.float32, device=ty.device)
    return _launch(name, ty, at, out, nT, O, t, M, t * t * O, O)


def sfc_inverse_nhwc(y: torch.Tensor, at: torch.Tensor,
                     grid: c2d.TileGrid) -> torch.Tensor:
    """Y (P, nT, O) or (nT, t, t, O) f32, at (M, t) f32 -> the cropped
    output (B, out_h, out_w, O) f32 of the tiles of ``grid``
    (nT = B nH nW, tiles over image, tile row, tile column): the function
    of ``sfc_inverse`` followed by ``ops.untile``, in one launch."""
    name = "sfc_inverse"
    if _build.runs_plain(name, y, at):
        return ref.sfc_inverse_nhwc_ref(y, at, grid)
    if y.dim() == 3:
        _build.require(name, y, "y", torch.float32, 3)
        P, nT, O = y.shape
        t = at.shape[-1]
        strides = (O, nT * O)
        ok = P == t * t
    else:
        _build.require(name, y, "y", torch.float32, 4)
        nT, t, t2, O = y.shape
        strides = (t * t * O, O)
        ok = t2 == t
    M = _check_at(name, at, t)
    per_image = grid.nH * grid.nW
    if not ok or per_image == 0 or nT % per_image:
        raise ValueError(f"{name}: y {tuple(y.shape)} is not the tiles of "
                         f"{grid} for at {tuple(at.shape)}")
    out = torch.empty((nT // per_image, grid.out_h, grid.out_w, O),
                      dtype=torch.float32, device=y.device)
    return _launch(name, y, at, out, nT, O, t, M, *strides, grid=grid)


sfc_inverse.launches = 0
