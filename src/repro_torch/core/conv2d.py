"""Tiled fast convolution in torch: 2-D (NHWC activations, HWIO weights)
and the 1-D depthwise causal conv of the Mamba2 blocks ((B, T, C), (R, C)).

Implements the three-stage bilinear flow (paper Eq. 1) for any
``BilinearAlgorithm`` (SFC, Winograd, direct):

    Y = A^T [ (G W G^T) (.) (B^T X B) ] A

vectorized over batch x tiles x channels.  This module is the portable
path of the port and the oracle for its CUDA kernels; computation follows
the device of the input tensors.

Its float32 library calls (the transforms' and the transform-domain
products' einsums on cuBLAS, the direct convolution on cuDNN) run in IEEE
float32 in both directions, whatever TF32 the caller allowed: autograd
enqueues a backward after the forward's guard has closed, so each call is
an autograd ``Function`` whose backward takes the guard again
(``precision``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.generator import BilinearAlgorithm
from repro_torch.core.precision import (full_fp32_conv,
                                        full_fp32_matmul)


@functools.lru_cache(maxsize=None)
def _matrices(algo: BilinearAlgorithm, dtype: torch.dtype, device: str):
    return tuple(torch.tensor(m, dtype=dtype, device=device)
                 for m in (algo.bt(), algo.g(), algo.at()))


class _GuardedEinsum(torch.autograd.Function):
    """``torch.einsum(equation, *operands)`` inside ``full_fp32_matmul`` in
    both directions.  An operand's gradient is the einsum of the other
    operands with the output's gradient, which holds where no operand
    repeats an index and each of an operand's indices appears in another
    operand or in the output, as in every product of this module."""

    @staticmethod
    def forward(ctx, equation, *operands):
        needs = ctx.needs_input_grad[1:]
        ctx.equation = equation
        # an operand is kept only for the other operands' gradients
        ctx.save_for_backward(*(
            o if any(n for i, n in enumerate(needs) if i != j) else None
            for j, o in enumerate(operands)))
        with full_fp32_matmul():
            return torch.einsum(equation, *operands)

    @staticmethod
    def backward(ctx, gy):
        operands = ctx.saved_tensors
        inputs, out = ctx.equation.split("->")
        subs = inputs.split(",")
        grads = []
        for i, needed in enumerate(ctx.needs_input_grad[1:]):
            if not needed:
                grads.append(None)
                continue
            rest = [j for j in range(len(subs)) if j != i]
            eq = ",".join([subs[j] for j in rest] + [out]) + "->" + subs[i]
            with full_fp32_matmul():
                grads.append(torch.einsum(eq, *[operands[j] for j in rest],
                                          gy))
        return (None, *grads)


def guarded_einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` whose forward and backward products run in IEEE
    float32 on cuBLAS (``precision.full_fp32_matmul``)."""
    return _GuardedEinsum.apply(equation, *operands)


class _DirectConv(torch.autograd.Function):
    """``F.conv2d`` (NCHW, OIHW, no padding) inside ``full_fp32_conv`` in
    both directions: the backward's data and weight gradients come from
    one ``aten.convolution_backward`` (the op autograd itself calls for
    ``F.conv2d``) on cuDNN in IEEE float32, not the TF32 that PyTorch's
    default allows there.  On the CPU the operands go in as contiguous
    NCHW: PyTorch 2.13's CPU weight gradient of a channels-last 1x1
    stride-2 conv at batch 4 corrupts the heap (the NHWC input's permuted
    view is channels-last), which ``torch.nn.grad.conv2d_weight`` and
    autograd's own backward of ``F.conv2d`` both reach."""

    @staticmethod
    def forward(ctx, x, w, stride, groups):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.groups = stride, groups
        with full_fp32_conv():
            return F.conv2d(x, w, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        if gy.device.type == "cpu":
            x, w, gy = x.contiguous(), w.contiguous(), gy.contiguous()
        with full_fp32_conv():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, (ctx.stride, ctx.stride), (0, 0), (1, 1),
                False, (0, 0), ctx.groups,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return gx, gw, None, None


def transform_matrices(algo: BilinearAlgorithm,
                       dtype: torch.dtype = torch.float32,
                       device="cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(bt, g, at)`` for ``algo`` at ``dtype`` on ``device``, cached.

    Algorithms are frozen, hashable dataclasses and the registry memoizes
    instances, so one cache entry serves every plan/apply for a given
    (algorithm, dtype, device).  The tensors are shared: do not write to
    them.
    """
    return _matrices(algo, dtype, str(torch.device(device)))


def pad_amounts(size: int, M: int, R: int, padding: str) -> Tuple[int, int, int]:
    """(lo_pad, hi_pad, out_size) for one spatial dim."""
    if padding == "SAME":
        out = size
        lo = (R - 1) // 2
    elif padding == "VALID":
        out = size - R + 1
        lo = 0
    else:
        raise ValueError(f"padding must be SAME or VALID, got {padding}")
    n_tiles = -(-out // M)  # ceil
    padded_needed = n_tiles * M + R - 1
    hi = padded_needed - size - lo
    return lo, hi, out


class TileGrid(NamedTuple):
    """Where the overlapping L x L input tiles of one image sit."""

    lo_h: int       # rows of zero padding above the image
    lo_w: int       # columns of zero padding left of the image
    out_h: int      # output extents
    out_w: int
    nH: int         # tiles per column and per row
    nW: int


def tile_grid(H: int, W: int, M: int, R: int, padding: str) -> TileGrid:
    """The tile grid of an (H, W) image for M outputs per tile, R taps."""
    lo_h, _, out_h = pad_amounts(H, M, R, padding)
    lo_w, _, out_w = pad_amounts(W, M, R, padding)
    return TileGrid(lo_h, lo_w, out_h, out_w, -(-out_h // M), -(-out_w // M))


def overlapping_tiles(x: torch.Tensor, M: int, R: int, padding: str = "SAME"
                      ) -> Tuple[torch.Tensor, TileGrid]:
    """(B,H,W,C) -> zero-padded overlapping tiles (B, nH, nW, L, L, C)."""
    B, H, W, C = x.shape
    L = M + R - 1
    grid = tile_grid(H, W, M, R, padding)
    hi_h = (grid.nH - 1) * M + L - H - grid.lo_h
    hi_w = (grid.nW - 1) * M + L - W - grid.lo_w
    xp = F.pad(x, (0, 0, grid.lo_w, hi_w, grid.lo_h, hi_h))
    idx_h = (torch.arange(grid.nH, device=x.device)[:, None] * M
             + torch.arange(L, device=x.device)[None, :])
    idx_w = (torch.arange(grid.nW, device=x.device)[:, None] * M
             + torch.arange(L, device=x.device)[None, :])
    return xp[:, idx_h[:, None, :, None], idx_w[None, :, None, :], :], grid


def transform_input_2d(x: torch.Tensor, algo: BilinearAlgorithm,
                       padding: str = "SAME") -> Tuple[torch.Tensor, Tuple]:
    """(B,H,W,C) -> transform-domain tiles (B, nH, nW, t, t, C)."""
    tiles, grid = overlapping_tiles(x, algo.M, algo.R, padding)
    bt = transform_matrices(algo, x.dtype, x.device)[0]
    tx = guarded_einsum("ti,bnwijc,uj->bnwtuc", bt, tiles, bt)
    return tx, (grid.out_h, grid.out_w, grid.nH, grid.nW)


def transform_weights_2d(w: torch.Tensor, algo: BilinearAlgorithm) -> torch.Tensor:
    """(R,R,Cin,Cout) -> (t,t,Cin,Cout)."""
    g = transform_matrices(algo, w.dtype, w.device)[1]
    return guarded_einsum("ti,ijco,uj->tuco", g, w, g)


def transform_domain_matmul(tx: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """(B,nH,nW,t,t,Cin) x (t,t,Cin,Cout) -> (B,nH,nW,t,t,Cout).

    t^2 independent GEMMs of shape (B*nH*nW, Cin) x (Cin, Cout), one per
    transform-domain position, in full float32 whatever the caller allowed
    cuBLAS, its gradients too (``precision.full_fp32_matmul``).
    """
    return guarded_einsum("bnwtuc,tuco->bnwtuo", tx, tw)


def inverse_transform_2d(ty: torch.Tensor, algo: BilinearAlgorithm,
                         geom: Tuple) -> torch.Tensor:
    """(B,nH,nW,t,t,Cout) -> (B,H_out,W_out,Cout)."""
    out_h, out_w = geom[:2]
    at = transform_matrices(algo, ty.dtype, ty.device)[2]
    y = guarded_einsum("mt,bnwtuo,pu->bnwmpo", at, ty, at)  # (B,nH,nW,M,M,O)
    return untile_2d(y, out_h, out_w)


def untile_2d(y: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Output tiles (B, nH, nW, M, M, O) -> (B, out_h, out_w, O)."""
    B, nH, nW, M, _, O = y.shape
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, nH * M, nW * M, O)
    return y[:, :out_h, :out_w, :]


def fastconv2d(x: torch.Tensor, w: torch.Tensor, algo: BilinearAlgorithm,
               padding: str = "SAME",
               bias: Optional[torch.Tensor] = None,
               elementwise_hook: Optional[Callable] = None) -> torch.Tensor:
    """Fast 2-D convolution (cross-correlation, as in ML convention).

    ``elementwise_hook(tx, tw) -> (tx, tw)`` injects transform-domain
    processing (paper Eq. 17).
    """
    if not (w.shape[0] == w.shape[1] == algo.R):
        raise ValueError(f"kernel {tuple(w.shape)} does not match R={algo.R}")
    tx, geom = transform_input_2d(x, algo, padding)
    tw = transform_weights_2d(w, algo)
    if elementwise_hook is not None:
        tx, tw = elementwise_hook(tx, tw)
    ty = transform_domain_matmul(tx, tw)
    y = inverse_transform_2d(ty, algo, geom)
    if bias is not None:
        y = y + bias
    return y


def same_pads(size: int, R: int, stride: int) -> Tuple[int, int]:
    """(lo, hi) of XLA/TensorFlow SAME padding for one dim at ``stride``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + R - size, 0)
    return total // 2, total - total // 2


def conv2d_direct(x: torch.Tensor, w: torch.Tensor,
                  padding: str = "SAME",
                  bias: Optional[torch.Tensor] = None, *,
                  stride: int = 1, groups: int = 1) -> torch.Tensor:
    """Reference direct convolution via ``F.conv2d`` (NHWC, HWIO).

    On the card ``F.conv2d`` runs through cuDNN, in full float32 whatever
    the caller allowed cuDNN, its data and weight gradients too
    (``precision.full_fp32_conv``; PyTorch's default would let it use
    TF32).
    """
    if padding == "SAME":
        lo_h, hi_h = same_pads(x.shape[1], w.shape[0], stride)
        lo_w, hi_w = same_pads(x.shape[2], w.shape[1], stride)
        x = F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding}")
    y = _DirectConv.apply(x.permute(0, 3, 1, 2),
                          w.to(x.dtype).permute(3, 2, 0, 1), stride, groups)
    y = y.permute(0, 2, 3, 1).contiguous()
    if bias is not None:
        y = y + bias
    return y


# --------------------------------------------------------------------------
# 1-D depthwise causal convolution (Mamba2 / Zamba2 short conv)
# --------------------------------------------------------------------------
def _overlap_tiles_1d(n_tiles: int, M: int, L: int, device) -> torch.Tensor:
    """Row indices (n_tiles, L) of overlapping tiles with stride M."""
    return (torch.arange(n_tiles, device=device)[:, None] * M
            + torch.arange(L, device=device)[None, :])


def fastconv1d_depthwise_causal(x: torch.Tensor, w: torch.Tensor,
                                algo: BilinearAlgorithm) -> torch.Tensor:
    """Causal depthwise conv1d: x (B, T, C), w (R, C) -> (B, T, C).

    y[b, t, c] = sum_r x[b, t - (R-1) + r, c] * w[r, c]   (left-padded)

    Depthwise has no channel contraction, so the element-wise stage is a
    true element-wise product: t/M multiplications per output against R
    direct.
    """
    if tuple(w.shape) != (algo.R, x.shape[-1]):
        raise ValueError(f"weights {tuple(w.shape)} do not match R={algo.R} "
                         f"and input {tuple(x.shape)}")
    return fastconv1d_depthwise_causal_pretransformed(
        x, transform_weights_1d(w, algo), algo)


def transform_weights_1d(w: torch.Tensor, algo: BilinearAlgorithm
                         ) -> torch.Tensor:
    """(R, C) -> (t, C)."""
    g = transform_matrices(algo, w.dtype, w.device)[1]
    return guarded_einsum("tr,rc->tc", g, w)


def fastconv1d_depthwise_causal_pretransformed(
        x: torch.Tensor, tw: torch.Tensor, algo: BilinearAlgorithm
        ) -> torch.Tensor:
    """The same flow with offline-transformed weights tw (t, C), the form
    the prepared weights of ``repro_torch.api`` feed."""
    B, T, C = x.shape
    if tuple(tw.shape) != (algo.t, C):
        raise ValueError(f"transformed weights {tuple(tw.shape)} do not "
                         f"match t={algo.t} and input {tuple(x.shape)}")
    R, M, L = algo.R, algo.M, algo.L
    n_tiles = -(-T // M)
    xp = F.pad(x, (0, 0, R - 1, n_tiles * M - T))
    tiles = xp[:, _overlap_tiles_1d(n_tiles, M, L, x.device), :]  # (B,nT,L,C)
    bt, _, at = transform_matrices(algo, x.dtype, x.device)
    tx = guarded_einsum("ti,bnic->bntc", bt, tiles)
    ty = tx * tw[None, None, :, :]
    y = guarded_einsum("mt,bntc->bnmc", at, ty)              # (B,nT,M,C)
    return y.reshape(B, n_tiles * M, C)[:, :T, :]


def conv1d_depthwise_causal_direct(x: torch.Tensor, w: torch.Tensor
                                   ) -> torch.Tensor:
    """Oracle for the depthwise causal conv1d."""
    B, T, C = x.shape
    R = w.shape[0]
    xp = F.pad(x, (0, 0, R - 1, 0))
    out = torch.zeros((B, T, C), dtype=x.dtype, device=x.device)
    for r in range(R):
        out = out + xp[:, r:r + T, :] * w[r][None, None, :]
    return out
