"""B3: SFC inverse transform A^T Y A.

The port of ``repro/kernels/sfc_inverse.py::_inverse_kernel``, as the CUDA
kernel ``csrc/sfc_inverse.cu``.  A^T carries the correction-term columns,
so the circular -> linear conversion of paper §4.2 happens inside the same
contraction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def sfc_inverse(ty: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """(nT, t, t, O) f32, at (M, t) f32 -> (nT, M, M, O) f32."""
    name = "sfc_inverse"
    if _build.runs_plain(name, ty, at):
        return ref.sfc_inverse_ref(ty, at)
    _build.require(name, ty, "ty", torch.float32, 4)
    _build.require(name, at, "at", torch.float32, 2)
    nT, t, _, O = ty.shape
    M = at.shape[0]
    if ty.shape[2] != t or at.shape[1] != t or t > _build.MAX_T \
            or M > _build.MAX_M:
        raise ValueError(f"{name}: unsupported shapes ty {tuple(ty.shape)}, "
                         f"at {tuple(at.shape)}")
    out = torch.empty((nT, M, M, O), dtype=torch.float32, device=ty.device)
    lib = _build.library()
    with torch.cuda.device(ty.device):
        err = lib.sfc_inverse_launch(ty.data_ptr(), at.data_ptr(),
                                     out.data_ptr(), nT, O, t, M,
                                     _build.stream_handle(ty.device))
    _build.check(err, name)
    sfc_inverse.launches += 1
    return out


sfc_inverse.launches = 0
