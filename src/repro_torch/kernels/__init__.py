"""The port's CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper runs its plain version (``ref.py``) on CPU tensors and
launches its kernel on CUDA tensors, counting launches in its
``launches`` attribute:

  B1 ``sfc_transform_quantize``   csrc/sfc_transform.cu
  B2 ``tdmm_int8``                csrc/sfc_tdmm.cu
  B3 ``sfc_inverse``              csrc/sfc_inverse.cu
  B4 ``sfc_fused_conv2d``         csrc/sfc_fused.cu
"""
from repro_torch.kernels import ref
from repro_torch.kernels.ops import (extract_tiles, quantize_weights,
                                     quantized_fastconv2d, untile)
from repro_torch.kernels.sfc_fused import sfc_fused_conv2d
from repro_torch.kernels.sfc_inverse import sfc_inverse
from repro_torch.kernels.sfc_tdmm import tdmm_int8
from repro_torch.kernels.sfc_transform import sfc_transform_quantize

KERNELS = (sfc_transform_quantize, tdmm_int8, sfc_inverse, sfc_fused_conv2d)


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "sfc_transform_quantize", "tdmm_int8", "sfc_inverse",
    "sfc_fused_conv2d", "quantized_fastconv2d", "quantize_weights",
    "extract_tiles", "untile", "ref", "KERNELS", "launch_counts",
    "reset_launch_counts",
]
