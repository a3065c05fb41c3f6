"""Execution backends behind ``ConvPlan.apply``.

Two backends, both consuming the same ``PreparedWeights``:

  * ``reference`` — plain torch, built from the ``repro_torch.core.conv2d``
    primitives, on whatever device the inputs lie.  It runs the fp fast
    path (with elementwise hooks), the static-int8 *simulation* on the
    int8 plan's integer grid in fp32, and the direct path.  It is the
    numerical oracle of the ``cuda`` backend.
  * ``cuda`` — the hand-written kernels of ``repro_torch.kernels``, the
    counterpart of the JAX package's ``pallas`` backend, branch for branch.
    The int8 path runs the fused kernel (B4; depthwise B7) by default, or
    the staged trio B1 -> B2 -> B3 (depthwise B1 -> B6 -> B3) when the
    plan's ``KernelConfig`` says ``datapath="staged"``.  The fp path (a
    plan without calibrated int8 weights) runs B5, the transform-domain
    product in full float32 (a ``torch.bmm`` over the t^2 positions;
    depthwise the broadcast product), then B3.  Direct plans run the
    reference direct path, as the JAX package's pallas backend runs XLA's
    convolution.  The rank-1 conv has no kernel yet and raises
    ``NotImplementedError``: nothing falls back to the reference backend.

On CPU tensors the ``cuda`` backend's kernel wrappers run their plain
versions, which is how the CPU tests drive this dispatch.
"""
from __future__ import annotations

from typing import Dict

import torch

import repro_torch.quant.fake_quant as fq
from repro_torch.core import conv2d as c2d


def _add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    return y if bias is None else y + bias


def _check_hook_supported(plan, elementwise_hook, prep) -> None:
    if elementwise_hook is None:
        return
    if plan.algorithm is None:
        raise ValueError(
            "elementwise_hook requires the fast path; this plan resolved "
            f"to direct ({plan.spec})")
    if prep.quantized:
        raise ValueError("elementwise_hook cannot be combined with "
                         "static-int8 prepared weights")


def _direct(plan, x, prep, bias) -> torch.Tensor:
    spec = plan.spec
    if spec.rank == 1:
        raise NotImplementedError(
            "the rank-1 depthwise causal conv is a later slice of the port "
            "(queue item A12)")
    groups = prep.w.shape[-1] if spec.depthwise else spec.groups
    return c2d.conv2d_direct(x, prep.w, spec.padding, bias,
                             stride=spec.stride, groups=groups)


class ReferenceBackend:
    """Portable torch path (the oracle)."""

    name = "reference"

    def apply(self, plan, x, prep, *, bias=None, elementwise_hook=None):
        _check_hook_supported(plan, elementwise_hook, prep)
        if plan.algorithm is None:
            return _direct(plan, x, prep, bias)
        if plan.spec.rank == 1:
            raise NotImplementedError(
                "the rank-1 depthwise causal conv is a later slice of the "
                "port (queue item A12)")
        algo = plan.algorithm
        tx, geom = c2d.transform_input_2d(x, algo, plan.spec.padding)
        tw = prep.tw
        if prep.quantized:
            # static-int8 simulation with the same scales and integer grid
            # as the kernel datapath: quantize tx with the calibrated
            # frequency scales, use the offline-quantized weights
            qc = plan.spec.quant
            s_act = prep.act_scale[None, None, None, :, :, None]
            tx = fq.dequantize(fq.quantize(tx, s_act, qc.bits_act), s_act)
            tw = (prep.wq.to(torch.float32).reshape(tw.shape)
                  * prep.w_scale[:, :, None, :]).to(tx.dtype)
        elif elementwise_hook is not None:
            tx, tw = elementwise_hook(tx, tw)
        if plan.spec.depthwise:
            # 2-D depthwise: the element-wise stage is a true
            # transform-domain product (tw (t, t, 1, C) broadcast)
            ty = tx * tw[None, None, None, :, :, 0, :].to(tx.dtype)
        else:
            ty = c2d.transform_domain_matmul(tx, tw)
        return _add_bias(c2d.inverse_transform_2d(ty, algo, geom), bias)


class CudaBackend:
    """``repro_torch.kernels`` datapath; static int8 precision, no hooks."""

    name = "cuda"
    # real int8 x int8 -> int32 accumulation: the planner runs the
    # repro_torch.analysis.ranges overflow pre-flight against this backend
    integer_datapath = True

    def apply(self, plan, x, prep, *, bias=None, elementwise_hook=None):
        if elementwise_hook is not None:
            raise ValueError(
                "the cuda backend takes no elementwise_hook; bake "
                "quantization into the plan (spec.quant + calibrated "
                "prepare_weights) or use backend='reference'")
        if plan.algorithm is None:
            return _direct(plan, x, prep, bias)
        if plan.spec.rank == 1:
            raise NotImplementedError(
                "the rank-1 depthwise causal conv is a later slice of the "
                "port (queue item A12)")
        from repro_torch.kernels import ops, sfc_fused
        algo = plan.algorithm
        depthwise = plan.spec.depthwise
        padding = plan.spec.padding
        if not prep.quantized:
            y = ops.fastconv2d_fp_transformed(x, prep.tw, algo,
                                              padding=padding,
                                              depthwise=depthwise)
            return _add_bias(y, bias)
        from repro_torch.api import tuning
        cfg = plan.config or tuning.DEFAULT_FUSED
        bits = plan.spec.quant.bits_act
        if cfg.datapath == "staged" and depthwise:
            y = ops.quantized_fastconv2d_depthwise(
                x, prep.wq, prep.act_scale, prep.w_scale, algo,
                padding=padding, bits=bits)
        elif cfg.datapath == "staged":
            y = ops.quantized_fastconv2d(
                x, prep.wq, prep.act_scale, prep.w_scale, algo,
                padding=padding, bits=bits, k_block=cfg.k_block)
        else:
            y = sfc_fused.sfc_fused_conv2d(
                x, prep.wq, prep.act_scale, prep.w_scale, algo,
                padding=padding, bits=bits, k_block=cfg.k_block,
                cout_block=cfg.cout_block, depthwise=depthwise)
        return _add_bias(y, bias)


_BACKENDS: Dict[str, object] = {
    "reference": ReferenceBackend(),
    "cuda": CudaBackend(),
}


def register_backend(name: str, backend, overwrite: bool = False) -> None:
    """Add (or with ``overwrite``, replace) an execution backend."""
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _BACKENDS[name] = backend
    from repro_torch.api import planner       # late: avoids import cycle
    planner.invalidate_plan_cache()


def get_backend(name: str):
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; "
                       f"registered: {sorted(_BACKENDS)}") from None


def list_backends():
    return tuple(sorted(_BACKENDS))
