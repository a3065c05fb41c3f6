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

Spatial-domain tensors use 'tensor' (activations) / 'channel' (weights).

``torch.round`` rounds half to even, as ``jnp.round`` does, and
:func:`quantize` divides by the scale rather than multiplying by its
reciprocal, so the port and the JAX package land on the same integer grid.
Gradients follow ``jax.grad`` of the JAX package's functions: rounding is a
straight-through estimator, the clip passes half the gradient at a bound
(as ``jnp.clip`` does; ``torch.clamp`` would pass all of it), the absmax
shares its gradient among ties, and ``|x|`` has slope 1 at 0.  So the same
code serves PTQ simulation and quantization-aware fine-tuning.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def qmax_for_bits(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def _abs(x: torch.Tensor) -> torch.Tensor:
    # |x| whose gradient at 0 is 1, as jnp.abs's (torch.abs's is 0)
    return torch.where(x >= 0, x, -x)


def _absmax_scale(x: torch.Tensor, reduce_axes: Sequence[int], bits: int
                  ) -> torch.Tensor:
    # torch.amax shares the gradient among tied maxima, as jnp.max does
    amax = torch.amax(_abs(x), dim=tuple(reduce_axes), keepdim=True)
    return amax / qmax_for_bits(bits) + 1e-12


def activation_reduce_axes(ndim: int, granularity: str,
                           t_axes: Tuple[int, int] = (-3, -2)
                           ) -> Tuple[int, ...]:
    """Axes to reduce when computing activation scales.

    For transform-domain activations (..., t, t, C) with 'frequency'
    granularity we keep the two t axes and reduce everything else
    (including channels — the paper's s_Tx is [T x T]).
    """
    t_axes = tuple(a % ndim for a in t_axes)
    if granularity == "tensor":
        return tuple(range(ndim))
    if granularity == "frequency":
        return tuple(a for a in range(ndim) if a not in t_axes)
    raise ValueError(f"activation granularity: {granularity}")


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


class _SteRound(torch.autograd.Function):
    """``torch.round`` forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``t`` over the axes it was broadcast along from ``shape``."""
    lead = t.dim() - len(shape)
    axes = tuple(range(lead)) + tuple(
        lead + i for i, n in enumerate(shape)
        if n == 1 and t.shape[lead + i] != 1)
    return t.sum(dim=axes, keepdim=True).reshape(shape) if axes else t


class _DivByScale(torch.autograd.Function):
    """``x / s`` whose gradient for ``s`` is formed as ``jax.grad`` forms it,
    ``-sum(g * (1 / (s * s)) * x)``, so the absmax elements (which reach
    the scale) get JAX's gradient to the bit wherever the sum is exact."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x, s)
        return x / s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        gx = _sum_to(g / s, x.shape) if ctx.needs_input_grad[0] else None
        gs = -_sum_to(g * (1 / (s * s)) * x, s.shape) \
            if ctx.needs_input_grad[1] else None
        return gx, gs


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # torch.clamp's values; at a bound the gradient is halved, as jnp.clip's
    # (minimum and maximum share it between equal operands).  The bounds
    # are filled on x's device: no copy from the host.
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Real -> integer grid (still float dtype, values are integers)."""
    q = qmax_for_bits(bits)
    return _clip(_SteRound.apply(_DivByScale.apply(x, scale)), -q, q)


def dequantize(xq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return xq * scale


def fake_quant(x: torch.Tensor, bits: int, reduce_axes: Sequence[int],
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """quantize+dequantize; scale computed from data unless provided."""
    s = scale if scale is not None else _absmax_scale(x, reduce_axes, bits)
    return dequantize(quantize(x, s, bits), s)


def fake_quant_activation(x: torch.Tensor, bits: int, granularity: str,
                          scale: Optional[torch.Tensor] = None,
                          t_axes: Tuple[int, int] = (-3, -2)
                          ) -> torch.Tensor:
    axes = activation_reduce_axes(x.dim(), granularity, t_axes)
    return fake_quant(x, bits, axes, scale)


def fake_quant_weight(w: torch.Tensor, bits: int, granularity: str,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    axes = weight_reduce_axes(w.dim(), granularity)
    return fake_quant(w, bits, axes, scale)


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
        """elementwise_hook for ``repro_torch.api`` ConvPlan.apply
        (reference backend): dynamic fake quant of both operands."""
        if not self.enabled:
            return None

        def _hook(tx, tw):
            txq = fake_quant_activation(
                tx, self.bits_act, self.act_granularity, t_axes=(-3, -2))
            twq = fake_quant_weight(tw, self.bits_weight,
                                    self.weight_granularity)
            return txq, twq
        return _hook


FP32 = QuantConfig(enabled=False)
INT8_FREQ = QuantConfig(8, 8, "frequency", "channel+frequency")
INT8_TENSOR = QuantConfig(8, 8, "tensor", "channel")
INT6_FREQ = QuantConfig(6, 6, "frequency", "channel+frequency")
INT4_FREQ = QuantConfig(4, 4, "frequency", "channel+frequency")
