"""The port's CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper runs its plain version (``ref.py``) on CPU tensors and
launches its kernel on CUDA tensors, counting launches in its
``launches`` attribute:

  B1 ``sfc_transform_quantize``       csrc/sfc_transform.cu
     (also ``sfc_transform_quantize_pt``, the same kernel and launch count)
  B2 ``tdmm_int8``                    csrc/sfc_tdmm.cu
  B3 ``sfc_inverse``                  csrc/sfc_inverse.cu
     (also ``sfc_inverse_nhwc``, the same kernel and launch count)
  B4 ``sfc_fused_conv2d``             csrc/sfc_fused.cu
  B5 ``sfc_transform``                csrc/sfc_transform.cu
  B6 ``tdmm_int8_depthwise``          csrc/sfc_tdmm_dw.cu
  B7 ``sfc_fused_conv2d_depthwise``   csrc/sfc_fused_dw.cu
     (also ``sfc_fused_conv2d(..., depthwise=True)``)
"""
from repro_torch.kernels import ref
from repro_torch.kernels.ops import (extract_tiles, fastconv2d_fp,
                                     quantize_weights, quantized_fastconv2d,
                                     quantized_fastconv2d_depthwise, untile)
from repro_torch.kernels.sfc_fused import (sfc_fused_conv2d,
                                           sfc_fused_conv2d_depthwise)
from repro_torch.kernels.sfc_inverse import sfc_inverse, sfc_inverse_nhwc
from repro_torch.kernels.sfc_tdmm import tdmm_int8, tdmm_int8_depthwise
from repro_torch.kernels.sfc_transform import (sfc_transform,
                                               sfc_transform_quantize,
                                               sfc_transform_quantize_pt)

KERNELS = (sfc_transform_quantize, tdmm_int8, sfc_inverse, sfc_fused_conv2d,
           sfc_transform, tdmm_int8_depthwise, sfc_fused_conv2d_depthwise)


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "sfc_transform_quantize", "sfc_transform_quantize_pt", "tdmm_int8",
    "sfc_inverse", "sfc_inverse_nhwc",
    "sfc_fused_conv2d", "sfc_transform", "tdmm_int8_depthwise",
    "sfc_fused_conv2d_depthwise", "quantized_fastconv2d",
    "quantized_fastconv2d_depthwise", "fastconv2d_fp", "quantize_weights",
    "extract_tiles", "untile", "ref", "KERNELS", "launch_counts",
    "reset_launch_counts",
]
