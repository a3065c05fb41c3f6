"""B2: transform-domain int8 matmul with fused dequant, and B6: its
depthwise counterpart, the elementwise int8 product with the dequant.

B2 is the port of ``repro/kernels/sfc_tdmm.py::_tdmm_kernel`` and
``::_tdmm_kblock_kernel``, as one CUDA kernel (``csrc/sfc_tdmm.cu``): for
each of the P = t^2 positions an int8 tensor-core GEMM accumulated in
int32 over the whole K, dequantized in the epilogue.  B6 is the port of
``::_tdmm_dw_kernel`` (``csrc/sfc_tdmm_dw.cu``), CUDA-core work with no
contraction.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref


def tdmm_int8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
              sw: torch.Tensor, *, k_block: Optional[int] = None
              ) -> torch.Tensor:
    """X (P, T, K) int8 x W (P, K, N) int8 -> (P, T, N) f32.

    Y[p] = float(X[p] @ W[p]) * (sx[p] * sw[p, :]).  ``k_block`` is kept
    for parity with the JAX wrapper, whose k-blocked Pallas kernel splits K
    to fit VMEM; it has no effect here: the CUDA kernel accumulates in int32
    registers across all of K, so every ``k_block`` gives the same result.
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
            out.data_ptr(), P, T, K, N, _build.stream_handle(xq.device))
    _build.check(err, name)
    tdmm_int8.launches += 1
    return out


tdmm_int8.launches = 0


def tdmm_int8_depthwise(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                        sw: torch.Tensor) -> torch.Tensor:
    """X (P, T, C) int8 x W (P, C) int8 -> (P, T, C) f32, elementwise.

    Y[p, t, c] = float(X[p, t, c] * W[p, c]) * (sx[p] * sw[p, c]): the
    int32 product is exact, and the dequant is the fused depthwise
    kernel's, so both depthwise datapaths give the same f32 values.
    """
    name = "tdmm_int8_depthwise"
    P, T, C = xq.shape
    if wq.shape != (P, C) or sx.shape != (P,) or sw.shape != (P, C):
        raise ValueError(f"{name}: shapes X {tuple(xq.shape)}, W "
                         f"{tuple(wq.shape)}, sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)} do not agree")
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
            out.data_ptr(), P, T, C, _build.stream_handle(xq.device))
    _build.check(err, name)
    tdmm_int8_depthwise.launches += 1
    return out


tdmm_int8_depthwise.launches = 0
