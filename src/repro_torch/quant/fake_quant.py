"""Symmetric integer quantization with the paper's granularities, in torch.

q = clip(round(x / s), -qmax, qmax), with a scale-factor *group* structure
(paper §5, Eq. 17):

  activations (transform domain, shape (..., t, t, C)):
     'tensor'     : one scale for the whole tensor
     'frequency'  : one scale per transform-domain coordinate  -> s[t, t]
  weights (transform domain, shape (t, t, Cin, Cout)):
     'channel'          : per output channel                   -> s[Cout]
     'frequency'        : per coordinate                       -> s[t, t]
     'channel+frequency': per coordinate per channel           -> s[t,t,Cout]

``torch.round`` rounds half to even, as ``jnp.round`` does, and
:func:`quantize` divides by the scale rather than multiplying by its
reciprocal, so the port and the JAX package land on the same integer grid.
The straight-through estimator and the fake-quant hooks belong to the
training slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def qmax_for_bits(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def weight_reduce_axes(ndim: int, granularity: str) -> Tuple[int, ...]:
    """Weights are (t, t, Cin, Cout) (transform) or (R, R, Cin, Cout)."""
    if granularity == "channel":          # keep Cout
        return tuple(range(ndim - 1))
    if granularity == "frequency":        # keep (t, t)
        return (ndim - 2, ndim - 1)
    if granularity == "channel+frequency":  # keep (t, t, Cout)
        return (ndim - 2,)
    if granularity == "tensor":
        return tuple(range(ndim))
    raise ValueError(f"weight granularity: {granularity}")


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Real -> integer grid (still float dtype, values are integers)."""
    q = qmax_for_bits(bits)
    return torch.clamp(torch.round(x / scale), -q, q)


def dequantize(xq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return xq * scale


def quantize_transformed_weights(tw: torch.Tensor, w_scale: torch.Tensor,
                                 bits: int = 8) -> torch.Tensor:
    """Offline weight quantization for the static deployment path.

    (t, t, Cin, Cout) fp transform-domain weights + (t, t, Cout) scales
    -> (t^2, Cin, Cout) int8, the layout ``tdmm_int8`` consumes.
    """
    q = qmax_for_bits(bits)
    t = tw.shape[0]
    wq = torch.clamp(torch.round(tw / w_scale[:, :, None, :]), -q, q)
    return wq.to(torch.int8).reshape(t * t, tw.shape[2], tw.shape[3])


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Transform-domain quantization recipe (paper Eq. 17 + §6.3 ablation)."""

    bits_act: int = 8
    bits_weight: int = 8
    act_granularity: str = "frequency"          # 'tensor' | 'frequency'
    weight_granularity: str = "channel+frequency"
    enabled: bool = True

    def hook(self):
        """The dynamic fake-quant hook (straight-through estimator)."""
        raise NotImplementedError(
            "QuantConfig.hook() (dynamic fake quantization with the "
            "straight-through estimator) comes with the port's training "
            "slice; the inference slice runs static int8 through "
            "prepare_weights(act_scale=...)")


FP32 = QuantConfig(enabled=False)
INT8_FREQ = QuantConfig(8, 8, "frequency", "channel+frequency")
INT8_TENSOR = QuantConfig(8, 8, "tensor", "channel")
INT6_FREQ = QuantConfig(6, 6, "frequency", "channel+frequency")
INT4_FREQ = QuantConfig(4, 4, "frequency", "channel+frequency")
