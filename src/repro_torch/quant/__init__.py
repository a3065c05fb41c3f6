"""Quantization substrate of the port: static int8 quantization and BOPs."""
from repro_torch.quant.bops import (ConvWorkload, bops_reduction,
                                    direct_conv_bops, fastconv_bops)
from repro_torch.quant.fake_quant import (FP32, INT4_FREQ, INT6_FREQ,
                                          INT8_FREQ, INT8_TENSOR, QuantConfig,
                                          dequantize, qmax_for_bits, quantize)

__all__ = [
    "QuantConfig", "FP32", "INT8_FREQ", "INT8_TENSOR", "INT6_FREQ",
    "INT4_FREQ", "quantize", "dequantize", "qmax_for_bits",
    "ConvWorkload", "direct_conv_bops", "fastconv_bops", "bops_reduction",
]
