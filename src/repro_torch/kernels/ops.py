"""Public wrappers assembling the SFC kernels into the staged convs.

``quantized_fastconv2d`` is the staged deployment path of the paper's
pipeline:

  [B1: transform + per-frequency int8 quant, read from NHWC]  (additions)
       -> [B2: t^2-position int8 tensor-core GEMMs + dequant]
       -> [B3: inverse transform incl. correction terms, NHWC out]

``quantized_fastconv2d_depthwise`` swaps B2 for B6, the elementwise int8
product (no channel contraction).  ``fastconv2d_fp`` is the unquantized
path: B5 (the f32 transform) -> a P-batched f32 product outside any kernel
(``torch.bmm``, as the JAX package leaves its ``jnp.einsum`` to XLA) ->
B3.  B1 writes its int8 output in the (P, nT, C) layout B2 and B6 read
(``sfc_transform_quantize_pt``), and B3 reads Y in the (P, nT, O) layout
the products leave and writes the cropped NHWC output itself
(``sfc_inverse_nhwc``): nothing is copied between the kernels.

Scales are static (PTQ-calibrated): act_scale (t, t), w_scale (t, t, Cout).
The same code runs the plain PyTorch versions on CPU tensors and the CUDA
kernels on CUDA tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import conv2d as c2d
from repro_torch.core.generator import BilinearAlgorithm
from repro_torch.core.precision import full_fp32_matmul
from repro_torch.kernels.sfc_inverse import sfc_inverse_nhwc
from repro_torch.kernels.sfc_tdmm import tdmm_int8, tdmm_int8_depthwise
from repro_torch.kernels.sfc_transform import (sfc_transform,
                                               sfc_transform_quantize_pt)


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
    _, H, W, _ = x.shape
    grid = c2d.tile_grid(H, W, M, algo.R, padding)
    X = sfc_transform_quantize_pt(x, bt, act_scale, M, padding=padding,
                                  bits=bits)                 # (P, T, C)
    Y = tdmm_int8(X, wq, act_scale.reshape(P),
                  w_scale.reshape(P, -1).contiguous(), k_block=k_block)
    return sfc_inverse_nhwc(Y, at, grid)


def quantized_fastconv2d_depthwise(x: torch.Tensor, wq: torch.Tensor,
                                   act_scale: torch.Tensor,
                                   w_scale: torch.Tensor,
                                   algo: BilinearAlgorithm, *,
                                   padding: str = "SAME", bits: int = 8
                                   ) -> torch.Tensor:
    """int8 depthwise SFC convolution (staged pipeline: B1 -> B6 -> B3).

    x (B,H,W,C) f32; wq (t^2, 1, C) int8; act_scale (t,t); w_scale
    (t,t,C) -> (B,H',W',C) f32.
    """
    t, M = algo.t, algo.M
    P = t * t
    bt, _, at = c2d.transform_matrices(algo, torch.float32, x.device)
    _, H, W, C = x.shape
    grid = c2d.tile_grid(H, W, M, algo.R, padding)
    X = sfc_transform_quantize_pt(x, bt, act_scale, M, padding=padding,
                                  bits=bits)                 # (P, T, C)
    Y = tdmm_int8_depthwise(X, wq.reshape(P, C), act_scale.reshape(P),
                            w_scale.reshape(P, C).contiguous())
    return sfc_inverse_nhwc(Y, at, grid)


def transform_domain_fp(tx: torch.Tensor, tw: torch.Tensor, *,
                        depthwise: bool = False) -> torch.Tensor:
    """tx (nT, t, t, C) f32 with tw (t, t, C, O) -> Y (P, nT, O) f32.

    Dense: for each of the P = t^2 positions an f32 product
    (nT, C) @ (C, O), as one ``torch.bmm`` over P, in full float32
    (:func:`full_fp32_matmul`), left in the bmm's (P, nT, O) layout; the
    bmm reads tx position-major by strides (no copy).  Depthwise (tw
    (t, t, 1, C)): the broadcast elementwise product, in tx's (nT, t, t, C)
    layout.  ``sfc_inverse_nhwc`` reads either.
    """
    nT, t, _, C = tx.shape
    if depthwise:
        return tx * tw[None, :, :, 0, :]
    P = t * t
    X = tx.reshape(nT, P, C).transpose(0, 1)                # (P, nT, C)
    with full_fp32_matmul():
        return torch.bmm(X, tw.reshape(P, C, -1))            # (P, nT, O)


def fastconv2d_fp_transformed(x: torch.Tensor, tw: torch.Tensor,
                              algo: BilinearAlgorithm, *,
                              padding: str = "SAME",
                              depthwise: bool = False) -> torch.Tensor:
    """Unquantized SFC conv from transformed weights tw (t, t, Cin, Cout)
    (depthwise: (t, t, 1, C)): B5 -> f32 product -> B3, NHWC out."""
    bt, _, at = c2d.transform_matrices(algo, torch.float32, x.device)
    _, H, W, _ = x.shape
    grid = c2d.tile_grid(H, W, algo.M, algo.R, padding)
    tx = sfc_transform(x, bt, algo.M, padding=padding)
    Y = transform_domain_fp(tx, tw.to(x.dtype), depthwise=depthwise)
    return sfc_inverse_nhwc(Y, at, grid)


def fastconv2d_fp(x: torch.Tensor, w: torch.Tensor, algo: BilinearAlgorithm,
                  *, padding: str = "SAME") -> torch.Tensor:
    """Unquantized kernel path from raw HWIO weights (R, R, Cin, Cout)."""
    return fastconv2d_fp_transformed(x, c2d.transform_weights_2d(w, algo),
                                     algo, padding=padding)
