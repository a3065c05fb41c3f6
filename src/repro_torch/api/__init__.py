"""``repro_torch.api`` — the one way to run a convolution in the port.

    spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    act = tuning.calibrate_act_scale(x, p.algorithm, spec.quant)
    prepared = p.prepare_weights(w, act_scale=act)      # offline
    y = p.apply(x, prepared)                            # online

The planner resolves the algorithm (registry name, measured timings from
``tuning.autotune``, the calibrated ``costmodel``, or BOPs
auto-selection), lowers strided and grouped specs onto SFC sub-problems
(``lowering``: a ``CompositePlan``, whose ``calibrate`` gives the per-sub
activation scales), degrades to direct convolution where fast algorithms
do not apply, and dispatches execution to the ``reference`` (plain torch)
or ``cuda`` (hand-written kernels) backend behind one signature; on
``cuda`` through the degradation chain of ``resilience``.  ``cuda_spmd``
(``repro_torch.distributed.conv_spmd``) runs the ``cuda`` datapath per
shard over a device mesh, batch over 'data' and C_out over 'model'.
``serving_cache`` holds one (plan, prepared weights) per served spec.
"""
from repro_torch.api import (costmodel, lowering, resilience, serving_cache,
                             tuning)
from repro_torch.api.backends import (get_backend, list_backends,
                                      register_backend)
from repro_torch.api.lowering import CompositePlan, CompositePrepared
from repro_torch.api.plan import ConvPlan, PreparedWeights
from repro_torch.api.planner import estimate_cost, plan, select_algorithm
from repro_torch.api.registry import (get_algorithm, list_algorithms,
                                      register_algorithm)
from repro_torch.api.spec import ConvSpec
from repro_torch.api.tuning import KernelConfig, autotune

__all__ = [
    "ConvSpec", "ConvPlan", "PreparedWeights", "plan",
    "lowering", "CompositePlan", "CompositePrepared",
    "select_algorithm", "estimate_cost",
    "register_algorithm", "get_algorithm", "list_algorithms",
    "register_backend", "get_backend", "list_backends",
    "tuning", "KernelConfig", "autotune",
    "costmodel", "resilience", "serving_cache",
]
