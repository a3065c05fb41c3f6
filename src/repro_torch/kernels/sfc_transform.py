"""B1: SFC input transform + per-frequency int8 quantization, and B5: the
same transform in f32 without quantization (the fp path).

The ports of ``repro/kernels/sfc_transform.py::_transform_quant_kernel``
and ``::_transform_kernel``, as the CUDA kernels of
``csrc/sfc_transform.cu``.  Unlike the Pallas kernels they read the
overlapping tiles straight from the NHWC input (no tile tensor), with the
SAME/VALID zero padding masked in the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import conv2d as c2d
from repro_torch.kernels import _build, ref


def _geometry(name, x, bt, M, padding):
    """(t, L, tile grid) of a launch over ``x``, or ValueError."""
    t, L = bt.shape
    if t > _build.MAX_T or L > _build.MAX_L or not 0 < M <= L:
        raise ValueError(f"{name}: unsupported tile (t={t}, L={L}, M={M})")
    return t, L, c2d.tile_grid(x.shape[1], x.shape[2], M, L - M + 1, padding)


def sfc_transform(x: torch.Tensor, bt: torch.Tensor, M: int, *,
                  padding: str = "SAME") -> torch.Tensor:
    """x (B,H,W,C) f32, bt (t,L) f32 -> f32 (B*nH*nW, t, t, C).

    The tiles are those of :func:`sfc_transform_quantize`, and each value
    is exactly the one that kernel quantizes on the card.
    """
    name = "sfc_transform"
    if _build.runs_plain(name, x, bt):
        return ref.sfc_transform_nhwc_ref(x, bt, M, padding)
    _build.require(name, x, "x", torch.float32, 4)
    _build.require(name, bt, "bt", torch.float32, 2)
    t, L, grid = _geometry(name, x, bt, M, padding)
    B, H, W, C = x.shape
    out = torch.empty((B * grid.nH * grid.nW, t, t, C), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sfc_transform_launch(
            x.data_ptr(), bt.data_ptr(), out.data_ptr(), B, H, W, C, M, L, t,
            grid.lo_h, grid.lo_w, grid.nH, grid.nW,
            _build.stream_handle(x.device))
    _build.check(err, name)
    sfc_transform.launches += 1
    return out


sfc_transform.launches = 0


def sfc_transform_quantize(x: torch.Tensor, bt: torch.Tensor,
                           scale: torch.Tensor, M: int, *,
                           padding: str = "SAME", bits: int = 8
                           ) -> torch.Tensor:
    """x (B,H,W,C) f32, bt (t,L) f32, scale (t,t) f32 -> int8 (B*nH*nW,t,t,C).

    Tiles of L = M + R - 1 rows at stride M cover the SAME/VALID output
    grid (``c2d.tile_grid``), ordered (image, tile row, tile column).
    """
    name = "sfc_transform_quantize"
    if _build.runs_plain(name, x, bt, scale):
        return ref.sfc_transform_quantize_nhwc_ref(x, bt, scale, M, padding,
                                                   bits)
    _build.require(name, x, "x", torch.float32, 4)
    _build.require(name, bt, "bt", torch.float32, 2)
    _build.require(name, scale, "scale", torch.float32, 2)
    t, L, grid = _geometry(name, x, bt, M, padding)
    if scale.shape != (t, t):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} is not "
                         f"({t}, {t})")
    B, H, W, C = x.shape
    out = torch.empty((B * grid.nH * grid.nW, t, t, C), dtype=torch.int8,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sfc_transform_quantize_launch(
            x.data_ptr(), bt.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, H, W, C, M, L, t, grid.lo_h, grid.lo_w, grid.nH, grid.nW,
            float(2 ** (bits - 1) - 1), _build.stream_handle(x.device))
    _build.check(err, name)
    sfc_transform_quantize.launches += 1
    return out


sfc_transform_quantize.launches = 0
