"""Plain PyTorch versions of the port's CUDA kernels (the ``ref.py`` contract).

Each kernel wrapper runs its plain version here for tensors on the CPU;
``chip_smoke.py`` holds each kernel against it on the card.  Shapes use
the *kernel* layout of the JAX package's ``repro/kernels/ref.py``:

  tiles     : (nT, L, L, C)      flattened spatial tiles, channels last
  transform : (nT, t, t, C); B1's (P, T, C) entry (t^2, nT, C)
  tdmm      : X (P, T, K) int8, W (P, K, N) int8 -> (P, T, N) f32
              with per-position activation scales sx (P,) and
              per-position-per-channel weight scales sw (P, N)
  tdmm_dw   : X (P, T, C) int8, W (P, C) int8 -> (P, T, C) f32, with
              sx (P,) and sw (P, C)
  inverse   : (nT, t, t, O) -> (nT, M, M, O); its NHWC entry
              (P, nT, O) or (nT, t, t, O) -> (B, H', W', O)
"""
from __future__ import annotations

import torch

from repro_torch.core import conv2d as c2d
from repro_torch.core.generator import BilinearAlgorithm


def sfc_transform_ref(tiles: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Forward transform B^T X B of every tile and channel, in f32."""
    return torch.einsum("ti,nijc,uj->ntuc", bt, tiles, bt)


def sfc_transform_nhwc_ref(x: torch.Tensor, bt: torch.Tensor, M: int,
                           padding: str = "SAME") -> torch.Tensor:
    """The B5 kernel's function: NHWC input -> f32 (B*nH*nW, t, t, C)."""
    L = bt.shape[1]
    tiles, _ = c2d.overlapping_tiles(x, M, L - M + 1, padding)
    return sfc_transform_ref(tiles.reshape(-1, L, L, x.shape[-1]), bt)


def sfc_transform_quantize_ref(tiles: torch.Tensor, bt: torch.Tensor,
                               scale: torch.Tensor, bits: int = 8
                               ) -> torch.Tensor:
    """Transform + static per-frequency quantization to intN."""
    tx = sfc_transform_ref(tiles, bt)
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(tx / scale[None, :, :, None]), -qmax, qmax)
    return q.to(torch.int8)


def sfc_transform_quantize_nhwc_ref(x: torch.Tensor, bt: torch.Tensor,
                                    scale: torch.Tensor, M: int,
                                    padding: str = "SAME", bits: int = 8
                                    ) -> torch.Tensor:
    """The B1 kernel's function: NHWC input -> int8 (B*nH*nW, t, t, C)."""
    L = bt.shape[1]
    tiles, _ = c2d.overlapping_tiles(x, M, L - M + 1, padding)
    return sfc_transform_quantize_ref(tiles.reshape(-1, L, L, x.shape[-1]),
                                      bt, scale, bits)


def sfc_transform_quantize_pt_ref(x: torch.Tensor, bt: torch.Tensor,
                                  scale: torch.Tensor, M: int,
                                  padding: str = "SAME", bits: int = 8
                                  ) -> torch.Tensor:
    """B1's (P, T, C) entry: the B1 function's int8 (T, t, t, C) output
    written position-major, int8 (t^2, B*nH*nW, C)."""
    xq = sfc_transform_quantize_nhwc_ref(x, bt, scale, M, padding, bits)
    T, t, _, C = xq.shape
    return xq.reshape(T, t * t, C).transpose(0, 1).contiguous()


def tdmm_int8_ref(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    """Transform-domain matmul: int8 x int8 -> exact integer sums -> f32.

    The products are summed in float64, where every partial sum of int8
    products below the int32 limit is an exact integer, so the result
    equals the int32 accumulation; the cast to f32 then rounds once, as
    the int32 -> f32 cast does.
    """
    acc = torch.einsum("ptk,pkn->ptn", xq.double(), wq.double())
    return acc.float() * (sx[:, None, None] * sw[:, None, :])


def tdmm_int8_depthwise_ref(xq: torch.Tensor, wq: torch.Tensor,
                            sx: torch.Tensor, sw: torch.Tensor
                            ) -> torch.Tensor:
    """Depthwise transform-domain stage: exact int32 products, dequantized
    as float(prod) * (sx[p] * sw[p, c])."""
    prod = xq.to(torch.int32) * wq.to(torch.int32)[:, None, :]
    return prod.float() * (sx[:, None, None] * sw[:, None, :])


def sfc_inverse_ref(ty: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    return torch.einsum("mt,ntuo,pu->nmpo", at, ty, at)


def sfc_inverse_nhwc_ref(y: torch.Tensor, at: torch.Tensor,
                         grid: c2d.TileGrid) -> torch.Tensor:
    """The B3 kernel's NHWC entry: Y (P, nT, O) or (nT, t, t, O) -> the
    inverse of every tile, untiled and cropped to (B, out_h, out_w, O)."""
    M, t = at.shape
    if y.dim() == 3:
        y = y.permute(1, 0, 2).reshape(y.shape[1], t, t, y.shape[2])
    tiles = sfc_inverse_ref(y, at)
    return c2d.untile_2d(tiles.reshape(-1, grid.nH, grid.nW, M, M,
                                       tiles.shape[-1]),
                         grid.out_h, grid.out_w)


def sfc_fused_conv2d_ref(x: torch.Tensor, wq: torch.Tensor,
                         act_scale: torch.Tensor, w_scale: torch.Tensor,
                         algo: BilinearAlgorithm, padding: str = "SAME",
                         bits: int = 8, depthwise: bool = False
                         ) -> torch.Tensor:
    """The B4 (and with ``depthwise``, the B7) kernel's function, as the
    three plain stages in sequence.

    x (B,H,W,Cin) f32; wq (t^2, Cin, Cout) int8; act_scale (t,t);
    w_scale (t,t,Cout) -> (B,H',W',Cout) f32.  Depthwise: wq (t^2, 1, C),
    w_scale (t,t,C), and the middle stage is the elementwise product.
    """
    B, _, _, C = x.shape
    t, M, L = algo.t, algo.M, algo.L
    bt, _, at = c2d.transform_matrices(algo, torch.float32, x.device)
    tiles, grid = c2d.overlapping_tiles(x, M, algo.R, padding)
    T = B * grid.nH * grid.nW
    xq = sfc_transform_quantize_ref(tiles.reshape(T, L, L, C), bt,
                                    act_scale, bits)
    X = xq.reshape(T, t * t, C).permute(1, 0, 2)
    if depthwise:
        Y = tdmm_int8_depthwise_ref(X, wq.reshape(t * t, C),
                                    act_scale.reshape(t * t),
                                    w_scale.reshape(t * t, C))
    else:
        Y = tdmm_int8_ref(X, wq, act_scale.reshape(t * t),
                          w_scale.reshape(t * t, -1))
    return sfc_inverse_nhwc_ref(Y, at, grid)


def quantized_fastconv2d_ref(x: torch.Tensor, w: torch.Tensor,
                             algo: BilinearAlgorithm,
                             act_scale: torch.Tensor,
                             w_scale: torch.Tensor,
                             padding: str = "SAME") -> torch.Tensor:
    """End-to-end oracle for the int8 SFC pipeline from raw HWIO weights.

    act_scale: (t, t) static calibrated scales; w_scale: (t, t, Cout).
    """
    tw = c2d.transform_weights_2d(w, algo)
    wq = torch.clamp(torch.round(tw / w_scale[:, :, None, :]), -127, 127)
    wq = wq.to(torch.int8).reshape(algo.t * algo.t, w.shape[2], w.shape[3])
    return sfc_fused_conv2d_ref(x, wq, act_scale, w_scale, algo, padding)
