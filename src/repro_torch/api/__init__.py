"""``repro_torch.api`` — the one way to run a convolution in the port.

    spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    act = tuning.calibrate_act_scale(x, p.algorithm, spec.quant)
    prepared = p.prepare_weights(w, act_scale=act)      # offline
    y = p.apply(x, prepared)                            # online

The planner resolves the algorithm (registry name or BOPs auto-selection),
degrades to direct convolution where fast algorithms do not apply (and
raises for strided or grouped specs the JAX package would lower, until
the lowering pass is ported), and dispatches execution to the
``reference`` (plain torch) or ``cuda`` (hand-written kernels) backend
behind one signature.
"""
from repro_torch.api import tuning
from repro_torch.api.backends import (get_backend, list_backends,
                                      register_backend)
from repro_torch.api.plan import ConvPlan, PreparedWeights
from repro_torch.api.planner import estimate_cost, plan, select_algorithm
from repro_torch.api.registry import (get_algorithm, list_algorithms,
                                      register_algorithm)
from repro_torch.api.spec import ConvSpec
from repro_torch.api.tuning import KernelConfig

__all__ = [
    "ConvSpec", "ConvPlan", "PreparedWeights", "plan",
    "select_algorithm", "estimate_cost",
    "register_algorithm", "get_algorithm", "list_algorithms",
    "register_backend", "get_backend", "list_backends",
    "tuning", "KernelConfig",
]
