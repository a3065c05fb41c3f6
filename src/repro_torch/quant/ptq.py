"""Post-training quantization calibration (paper §6.1), in torch.

The paper calibrates on ~500 images with AdaQuant; the port, like the JAX
package, implements the robust core of that recipe:

  * **scale search**: per scale-group grid search over a multiplier of the
    absmax scale, minimizing the MSE between the fake-quantized and fp
    tensors (LoWino-style distance minimization, same objective family as
    AdaQuant's first stage);
  * **calibration buffers**: running absmax statistics collected over
    calibration batches, producing *static* scales for deployment (the
    paper stores transform-domain tensors, avoiding double quantization);
    they stay tensors on the calibrated tensor's device, so observing a
    layer on the card never waits for it;
  * a hook factory that plugs the calibrated static scales into the
    element-wise stage of a ``repro_torch.api`` ConvPlan (reference
    backend), and :meth:`PTQLayer.prepare` / :meth:`PTQLayer.static_scales`,
    which export those scales into ``ConvPlan.prepare_weights`` for the
    offline int8 deployment path (both backends).

Typical flow::

    p = plan(spec, backend="cuda")
    layer = PTQLayer(config=spec.quant)
    ref = plan(spec, backend="reference", algo=p.algo_name)
    for batch in calib:                       # calibration (reference)
        ref.apply(batch, w, elementwise_hook=layer.calibration_hook())
    prepared = layer.prepare(p, w)            # offline int8 weights
    y = p.apply(x, prepared)                  # deployment
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.quant.fake_quant as fq


def mse_scale_search(x: torch.Tensor, bits: int, reduce_axes: Sequence[int],
                     n_grid: int = 32, lo: float = 0.3) -> torch.Tensor:
    """Grid-search the scale multiplier minimizing fake-quant MSE per group.

    The multipliers are tried in increasing order and a group keeps the
    first that is strictly best, as in the JAX package.
    """
    axes = tuple(reduce_axes)
    amax_scale = torch.amax(torch.abs(x), dim=axes, keepdim=True) \
        / fq.qmax_for_bits(bits) + 1e-12
    best_scale = amax_scale
    best_err = torch.full_like(amax_scale, float("inf"))
    for m in np.linspace(lo, 1.0, n_grid):
        s = amax_scale * float(np.float32(m))
        err = torch.sum((fq.dequantize(fq.quantize(x, s, bits), s) - x) ** 2,
                        dim=axes, keepdim=True)
        best_scale = torch.where(err < best_err, s, best_scale)
        best_err = torch.minimum(err, best_err)
    return best_scale


@dataclasses.dataclass
class CalibrationState:
    """Running absmax statistics for one tensor's scale group."""

    amax: Optional[torch.Tensor] = None

    def update(self, x: torch.Tensor, reduce_axes: Sequence[int]) -> None:
        x = torch.as_tensor(x).detach()
        cur = torch.amax(torch.abs(x), dim=tuple(reduce_axes), keepdim=True)
        self.amax = cur if self.amax is None else torch.maximum(self.amax,
                                                                cur)

    def scale(self, bits: int) -> torch.Tensor:
        assert self.amax is not None, "no calibration data seen"
        return self.amax / fq.qmax_for_bits(bits) + 1e-12


@dataclasses.dataclass
class PTQLayer:
    """Calibrated transform-domain quantizer for one conv layer."""

    config: fq.QuantConfig
    act_state: CalibrationState = dataclasses.field(
        default_factory=CalibrationState)
    weight_scale: Optional[torch.Tensor] = None

    # ---- calibration pass ----
    def observe(self, tx: torch.Tensor, tw: torch.Tensor) -> None:
        axes = fq.activation_reduce_axes(tx.dim(), self.config.act_granularity)
        self.act_state.update(tx, axes)
        if self.weight_scale is None:
            w_axes = fq.weight_reduce_axes(tw.dim(),
                                           self.config.weight_granularity)
            with torch.no_grad():
                self.weight_scale = mse_scale_search(
                    tw.detach(), self.config.bits_weight, w_axes)

    def calibration_hook(self) -> Callable:
        def _hook(tx, tw):
            self.observe(tx, tw)
            return tx, tw  # calibration runs in fp
        return _hook

    # ---- deployment pass ----
    def quantized_hook(self) -> Callable:
        act_scale = self.act_state.scale(self.config.bits_act)

        def _hook(tx, tw):
            txq = fq.fake_quant(tx, self.config.bits_act,
                                reduce_axes=(), scale=act_scale)
            twq = fq.fake_quant(tw, self.config.bits_weight,
                                reduce_axes=(), scale=self.weight_scale)
            return txq, twq
        return _hook

    # ---- offline deployment (repro_torch.api integration) ----
    def static_scales(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Calibrated (act_scale (t, t), weight_scale) for prepare_weights.

        Frequency-wise activation scales are the paper's s_Tx (Eq. 17);
        tensor-granularity calibration broadcasts to the same shape so the
        static datapath is granularity-agnostic.
        """
        act = torch.squeeze(self.act_state.scale(self.config.bits_act))
        if act.dim() == 0:
            act = act.expand(t, t)
        if tuple(act.shape) != (t, t):
            raise ValueError(
                f"calibrated activation scale has shape {tuple(act.shape)}, "
                f"expected broadcastable to ({t}, {t})")
        return act.to(torch.float32).contiguous(), self.weight_scale

    def prepare(self, plan, w: torch.Tensor):
        """Offline-quantize ``w`` for ``plan`` using the calibrated scales.

        Direct plans have no transform domain — the raw weights pass
        through unquantized.  Lowered (composite) plans are REJECTED
        rather than silently degraded: one PTQLayer holds ONE (t, t) scale
        state, but a composite's sub-convs have different tile sizes and
        input distributions (its calibration hook would mix tensor shapes,
        too).  Calibrate composites per sub-problem with
        ``CompositePlan.calibrate(x)`` -> ``prepare_weights(w,
        act_scale=...)`` instead.
        """
        if plan.path == "lowered":
            raise NotImplementedError(
                "PTQLayer calibrates a single transform domain; lowered "
                f"(composite) plans have one per sub-conv ({plan.algo_name})."
                " Use CompositePlan.calibrate(x) + prepare_weights(w, "
                "act_scale=<per-sub scales>) for the static-int8 path.")
        if plan.algorithm is None:
            return plan.prepare_weights(w)
        act_scale, w_scale = self.static_scales(plan.algorithm.t)
        return plan.prepare_weights(w, act_scale=act_scale, w_scale=w_scale)
