"""Quantization substrate of the port: fake quant, PTQ calibration, BOPs.

The bare ``fake_quant`` *function* is not re-exported: it would shadow the
``repro_torch.quant.fake_quant`` module attribute; import it from
``repro_torch.quant.fake_quant`` directly.
"""
from repro_torch.quant.bops import (ConvWorkload, bops_reduction,
                                    direct_conv_bops, fastconv_bops)
from repro_torch.quant.fake_quant import (FP32, INT4_FREQ, INT6_FREQ,
                                          INT8_FREQ, INT8_TENSOR, QuantConfig,
                                          dequantize, fake_quant_activation,
                                          fake_quant_weight, qmax_for_bits,
                                          quantize)
from repro_torch.quant.ptq import CalibrationState, PTQLayer, mse_scale_search

__all__ = [
    "QuantConfig", "FP32", "INT8_FREQ", "INT8_TENSOR", "INT6_FREQ",
    "INT4_FREQ", "quantize", "dequantize",
    "fake_quant_activation", "fake_quant_weight", "qmax_for_bits",
    "ConvWorkload", "direct_conv_bops", "fastconv_bops", "bops_reduction",
    "CalibrationState", "PTQLayer", "mse_scale_search",
]
