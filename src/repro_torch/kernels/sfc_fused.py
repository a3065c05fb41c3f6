"""B4 and B7: the int8 SFC convolution as ONE CUDA launch.

B4 (``csrc/sfc_fused.cu``) is the port of
``repro/kernels/sfc_fused.py::_fused_kernel``, the dense conv; B7
(``csrc/sfc_fused_dw.cu``) the port of ``::_fused_dw_kernel``, the
depthwise conv, which ``sfc_fused_conv2d(depthwise=True)`` runs.
The Pallas kernel's TPU geometry (``FusedGeometry``, ``VMEM_LIMIT_BYTES``,
the strip grouping) does not carry over: each CUDA block owns 16 tiles and
``cout_block`` output channels and loops over ``k_block``-wide C_in blocks
itself, with the int32 accumulator and the quantized tiles in shared
memory; the C_out blocks of one tile group form a thread block cluster
that shares the transform, the counterpart of the TPU kernel's xq cache.
The transform-domain tensor never goes to device memory.

The kernel calls the same device functions as the staged B1 (transform +
quantize), B2 (dequant) and B3 (inverse), so on the card the fused and the
staged datapath compute the same int8 grid and the same fp32 epilogue.

B7 has no channel contraction, so its blocks own a group of tiles and
``cout_block`` channels, with no C_in loop, no accumulator and no cluster:
each block transforms and quantizes, multiplies by its (P, cb) int8
weights, dequantizes and inverts, sharing B1's, B6's and B3's device
functions, so it is bit-identical to the staged depthwise datapath.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import conv2d as c2d
from repro_torch.core.generator import BilinearAlgorithm
from repro_torch.kernels import _build, ref

K_BLOCK = 32        # C_in channels transformed per stage (mma k = 32)
COUT_BLOCK = 16     # output channels per block (two mma n-tiles)
# shared memory one block may use on an H100, less the kernel's static part
SMEM_LIMIT_BYTES = 232448 - 4 * 3 * _build.MAX_T * _build.MAX_L
DW_TILES = 4        # tiles per block of B7 (kCols in csrc/sfc_fused_dw.cu)


def smem_bytes(t: int, kb: int, cb: int) -> int:
    """Dynamic shared memory of one block: int32 acc + int8 xq tiles (the
    same formula as the launch in csrc/sfc_fused.cu)."""
    return t * t * 16 * (4 * cb + kb)


def resolve_blocks(C: int, t: int, k_block: Optional[int],
                   cout_block: int) -> tuple:
    """(kb, cb) the kernel runs at, or ValueError if they cannot run.

    ``k_block=None`` means the whole C_in in one stage (rounded up to the
    mma depth of 32).
    """
    kb = -(-C // 32) * 32 if k_block is None else k_block
    if kb < 32 or kb % 32 or cout_block < 8 or cout_block % 8:
        raise ValueError(f"sfc_fused_conv2d: k_block must be a positive "
                         f"multiple of 32 and cout_block of 8, got "
                         f"k_block={k_block}, cout_block={cout_block}")
    need = smem_bytes(t, kb, cout_block)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"sfc_fused_conv2d: k_block={kb}, cout_block={cout_block} need "
            f"{need} bytes of shared memory for t={t}; one block has "
            f"{SMEM_LIMIT_BYTES}")
    return kb, cout_block


def smem_bytes_depthwise(t: int, cb: int) -> int:
    """Dynamic shared memory of one B7 block: f32 weight scales, int8 xq
    tiles and int8 weights (the same formula as the launch in
    csrc/sfc_fused_dw.cu)."""
    return t * t * cb * (DW_TILES + 5)


def resolve_depthwise_block(t: int, cout_block: int) -> int:
    """The channel block B7 runs at, or ValueError if it cannot run."""
    if cout_block < 1:
        raise ValueError(f"sfc_fused_conv2d: the depthwise cout_block must "
                         f"be positive, got cout_block={cout_block}")
    need = smem_bytes_depthwise(t, cout_block)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"sfc_fused_conv2d: depthwise cout_block={cout_block} needs "
            f"{need} bytes of shared memory for t={t}; one block has "
            f"{SMEM_LIMIT_BYTES}")
    return cout_block


def sfc_fused_conv2d(x: torch.Tensor, wq: torch.Tensor,
                     act_scale: torch.Tensor, w_scale: torch.Tensor,
                     algo: BilinearAlgorithm, *,
                     padding: str = "SAME", bits: int = 8,
                     k_block: Optional[int] = K_BLOCK,
                     cout_block: int = COUT_BLOCK,
                     double_buffer: bool = False,
                     depthwise: bool = False) -> torch.Tensor:
    """int8 SFC convolution in one launch.

    x (B, H, W, Cin) f32; wq (t^2, Cin, Cout) int8; act_scale (t, t);
    w_scale (t, t, Cout) -> (B, H', W', Cout) f32, the same function as
    the staged ``ops.quantized_fastconv2d``.

    ``depthwise`` (wq (t^2, 1, C), w_scale (t, t, C)) runs B7, the
    function of the staged ``ops.quantized_fastconv2d_depthwise``, with
    ``cout_block`` channels per block; ``k_block`` has no effect there, as
    in the JAX package: there is no reduction to block.
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
    kb, cb = resolve_blocks(C, t, k_block, cout_block)
    if _build.runs_plain(name, x, wq, act_scale, w_scale):
        return ref.sfc_fused_conv2d_ref(x, wq, act_scale, w_scale, algo,
                                        padding, bits)
    _build.require(name, x, "x", torch.float32, 4)
    _build.require(name, wq, "wq", torch.int8, 3)
    _build.require(name, act_scale, "act_scale", torch.float32, 2)
    _build.require(name, w_scale, "w_scale", torch.float32, 3)
    if t > _build.MAX_T or L > _build.MAX_L or M > _build.MAX_M:
        raise ValueError(f"{name}: unsupported tile (t={t}, L={L}, M={M})")
    Cout = wq.shape[2]
    grid = c2d.tile_grid(H, W, M, algo.R, padding)
    bt, _, at = c2d.transform_matrices(algo, torch.float32, x.device)
    out = torch.empty((B, grid.out_h, grid.out_w, Cout), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sfc_fused_conv2d_launch(
            x.data_ptr(), wq.data_ptr(), act_scale.data_ptr(),
            w_scale.data_ptr(), bt.data_ptr(), at.data_ptr(), out.data_ptr(),
            B, H, W, C, Cout, M, L, t, grid.lo_h, grid.lo_w, grid.nH,
            grid.nW, grid.out_h, grid.out_w, kb, cb,
            float(2 ** (bits - 1) - 1), _build.stream_handle(x.device))
    _build.check(err, name)
    sfc_fused_conv2d.launches += 1
    return out


sfc_fused_conv2d.launches = 0


def sfc_fused_conv2d_depthwise(x: torch.Tensor, wq: torch.Tensor,
                               act_scale: torch.Tensor,
                               w_scale: torch.Tensor,
                               algo: BilinearAlgorithm, *,
                               padding: str = "SAME", bits: int = 8,
                               cout_block: int = COUT_BLOCK) -> torch.Tensor:
    """B7: int8 depthwise SFC convolution in one launch.

    x (B, H, W, C) f32; wq (t^2, 1, C) int8; act_scale (t, t);
    w_scale (t, t, C) -> (B, H', W', C) f32.
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
    cb = resolve_depthwise_block(t, cout_block)
    if _build.runs_plain(name, x, wq, act_scale, w_scale):
        return ref.sfc_fused_conv2d_ref(x, wq, act_scale, w_scale, algo,
                                        padding, bits, depthwise=True)
    _build.require(name, x, "x", torch.float32, 4)
    _build.require(name, wq, "wq", torch.int8, 3)
    _build.require(name, act_scale, "act_scale", torch.float32, 2)
    _build.require(name, w_scale, "w_scale", torch.float32, 3)
    if t > _build.MAX_T or L > _build.MAX_L or M > _build.MAX_M:
        raise ValueError(f"{name}: unsupported tile (t={t}, L={L}, M={M})")
    grid = c2d.tile_grid(H, W, M, algo.R, padding)
    bt, _, at = c2d.transform_matrices(algo, torch.float32, x.device)
    out = torch.empty((B, grid.out_h, grid.out_w, C), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sfc_fused_conv2d_depthwise_launch(
            x.data_ptr(), wq.data_ptr(), act_scale.data_ptr(),
            w_scale.data_ptr(), bt.data_ptr(), at.data_ptr(), out.data_ptr(),
            B, H, W, C, M, L, t, grid.lo_h, grid.lo_w, grid.nH, grid.nW,
            grid.out_h, grid.out_w, cb, float(2 ** (bits - 1) - 1),
            _build.stream_handle(x.device))
    _build.check(err, name)
    sfc_fused_conv2d_depthwise.launches += 1
    return out


sfc_fused_conv2d_depthwise.launches = 0
