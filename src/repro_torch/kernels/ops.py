"""Public wrappers assembling the SFC kernels into the staged int8 conv.

``quantized_fastconv2d`` is the staged deployment path of the paper's
pipeline:

  [B1: transform + per-frequency int8 quant, read from NHWC]  (additions)
       -> [B2: t^2-position int8 tensor-core GEMMs + dequant]
       -> [B3: inverse transform incl. correction terms]
       -> untile

Scales are static (PTQ-calibrated): act_scale (t, t), w_scale (t, t, Cout).
The same code runs the plain PyTorch versions on CPU tensors and the CUDA
kernels on CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import conv2d as c2d
from repro_torch.core.generator import BilinearAlgorithm
from repro_torch.kernels.sfc_inverse import sfc_inverse
from repro_torch.kernels.sfc_tdmm import tdmm_int8
from repro_torch.kernels.sfc_transform import sfc_transform_quantize


def extract_tiles(x: torch.Tensor, algo: BilinearAlgorithm,
                  padding: str = "SAME") -> Tuple[torch.Tensor, Tuple]:
    """(B,H,W,C) -> flat tiles (B*nH*nW, L, L, C) + geometry."""
    B, _, _, C = x.shape
    L = algo.L
    tiles, grid = c2d.overlapping_tiles(x, algo.M, algo.R, padding)
    return (tiles.reshape(-1, L, L, C),
            (B, grid.out_h, grid.out_w, grid.nH, grid.nW))


def untile(y_tiles: torch.Tensor, algo: BilinearAlgorithm,
           geom: Tuple) -> torch.Tensor:
    B, out_h, out_w, nH, nW = geom
    M = algo.M
    y = y_tiles.reshape(B, nH, nW, M, M, y_tiles.shape[-1])
    return c2d.untile_2d(y, out_h, out_w)


def quantize_weights(w: torch.Tensor, algo: BilinearAlgorithm,
                     w_scale: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """(R,R,Cin,Cout) f32 -> (t^2, Cin, Cout) int8 — offline, once."""
    from repro_torch.quant.fake_quant import quantize_transformed_weights
    tw = c2d.transform_weights_2d(w, algo)
    return quantize_transformed_weights(tw, w_scale, bits)


def quantized_fastconv2d(x: torch.Tensor, wq: torch.Tensor,
                         act_scale: torch.Tensor, w_scale: torch.Tensor,
                         algo: BilinearAlgorithm, *,
                         padding: str = "SAME", bits: int = 8,
                         k_block: Optional[int] = None) -> torch.Tensor:
    """int8 SFC convolution with pre-quantized weights (staged pipeline).

    x (B,H,W,Cin) f32; wq (t^2, Cin, Cout) int8; act_scale (t,t);
    w_scale (t,t,Cout) -> (B,H',W',Cout) f32.  ``bits`` sets the
    activation clipping grid (sub-int8 policies run on the int8 carrier);
    ``k_block`` goes to ``tdmm_int8``, which keeps it for parity only.
    """
    t, M = algo.t, algo.M
    P = t * t
    bt, _, at = c2d.transform_matrices(algo, torch.float32, x.device)
    B, H, W, C = x.shape
    grid = c2d.tile_grid(H, W, M, algo.R, padding)
    xq = sfc_transform_quantize(x, bt, act_scale, M, padding=padding,
                                bits=bits)
    T = xq.shape[0]
    X = xq.reshape(T, P, C).transpose(0, 1).contiguous()     # (P, T, C)
    Y = tdmm_int8(X, wq, act_scale.reshape(P),
                  w_scale.reshape(P, -1).contiguous(), k_block=k_block)
    ty = Y.transpose(0, 1).reshape(T, t, t, -1).contiguous()
    y_tiles = sfc_inverse(ty, at)
    return untile(y_tiles, algo, (B, grid.out_h, grid.out_w, grid.nH,
                                  grid.nW))
