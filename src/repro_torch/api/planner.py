"""The planner: ``plan(spec, *, backend, algo="auto") -> ConvPlan``.

Algorithm resolution happens in one place, for every call site:

  * strided or grouped 2-D specs with more than one tap raise
    ``NotImplementedError`` unless ``algo="direct"``: the JAX package
    lowers them onto the fast path (polyphase stride-2 decomposition,
    per-group splitting) where its cost model or an explicit algorithm
    says so, and the port's lowering pass is queue item A6.  A direct plan
    there would compute another function than the JAX package's
    int8-quantized fast path, so the port does not guess;
  * the other shapes a fast algorithm cannot serve natively (pointwise
    1x1, kernel-tap mismatch with the requested algorithm) degrade to the
    direct path, as in the JAX package;
  * ``algo="auto"`` ranks the registered candidates with the paper's BOPs
    cost model (``repro_torch.quant.bops``) against the direct baseline,
    at the spec's precision.  Under int8-or-lower quantization Winograd
    candidates are excluded: their transform dynamic range makes
    low-precision execution inaccurate (paper Fig. 5).  The JAX package's
    measured-timing and calibrated cost-model tiers come with the port of
    its tuning layer;
  * on integer-datapath backends the plan-time overflow pre-flight
    (``repro_torch.analysis.ranges``) rejects specs whose int32
    accumulator could wrap.

A plan's ``config`` stays None (the backend's default datapath) until
the tuning layer is ported.  Plans are memoized on (spec, backend, algo).
"""
from __future__ import annotations

import functools
from typing import Optional

from repro_torch.api import registry
from repro_torch.api.plan import ConvPlan
from repro_torch.api.spec import ConvSpec
from repro_torch.quant.bops import (ConvWorkload, direct_conv_bops,
                                    fastconv_bops)

_FP_SURROGATE_BITS = 16   # cost-model bit width for unquantized specs


def _spec_bits(spec: ConvSpec):
    if spec.quant.enabled:
        return spec.quant.bits_act, spec.quant.bits_weight
    return _FP_SURROGATE_BITS, _FP_SURROGATE_BITS


def _workload(spec: ConvSpec) -> Optional[ConvWorkload]:
    if spec.rank != 2 or spec.in_channels is None \
            or spec.out_channels is None or spec.spatial is None:
        return None
    ba, bw = _spec_bits(spec)
    return ConvWorkload(spec.spatial[0], spec.spatial[1], spec.in_channels,
                        spec.out_channels, spec.kernel_size,
                        bits_act=ba, bits_weight=bw, stride=spec.stride,
                        groups=spec.groups,
                        depthwise=spec.depthwise and spec.rank == 2,
                        padding=spec.padding)


def estimate_cost(spec: ConvSpec, algo_name: str) -> float:
    """BOPs (or a dimensionless surrogate) of running ``spec`` one way."""
    algo = registry.get_algorithm(algo_name)
    if spec.rank == 1:
        # depthwise: no channel contraction — cost is multiplications per
        # output per channel (paper's 1-D counting): R direct, t/M fast.
        return float(spec.kernel_size if algo is None else algo.t / algo.M)
    wl = _workload(spec)
    if wl is not None:
        return direct_conv_bops(wl) if algo is None \
            else fastconv_bops(wl, algo)
    # no shape hints: rank by arithmetic complexity (direct == 1.0)
    return 1.0 if algo is None else algo.arithmetic_complexity_2d


def select_algorithm(spec: ConvSpec) -> str:
    """Cheapest eligible algorithm for the spec by BOPs (may be 'direct')."""
    if not spec.fast_eligible:
        return registry.DIRECT
    candidates = registry.entries(taps=spec.kernel_size)
    ba, bw = _spec_bits(spec)
    if spec.quant.enabled and min(ba, bw) <= 8:
        candidates = [e for e in candidates if e.kind != "winograd"]
    best_name = registry.DIRECT
    best_cost = estimate_cost(spec, registry.DIRECT)
    for entry in candidates:
        cost = estimate_cost(spec, entry.name)
        if cost < best_cost:
            best_name, best_cost = entry.name, cost
    return best_name


def needs_lowering(spec: ConvSpec) -> bool:
    """Whether the JAX package's lowering pass may rewrite ``spec``: a 2-D
    conv with more than one tap that is strided or grouped (a stride-1
    depthwise conv plans natively)."""
    return spec.rank == 2 and spec.kernel_size > 1 \
        and (spec.stride > 1 or spec.groups > 1)


@functools.lru_cache(maxsize=512)
def _plan_cached(spec: ConvSpec, backend: str, algo: str) -> ConvPlan:
    from repro_torch.api import backends
    backend_obj = backends.get_backend(backend)   # fail fast on unknown
    if algo not in ("auto", registry.DIRECT):
        # raises on unknown names even when the spec degrades to direct
        resolved = registry.get_algorithm(algo)
    if algo != registry.DIRECT and needs_lowering(spec):
        raise NotImplementedError(
            f"plan: the JAX package lowers this spec (stride {spec.stride}, "
            f"groups {spec.groups}, {spec.kernel_size}x{spec.kernel_size}) "
            f"onto the fast path by polyphase decomposition or per-group "
            f"splitting; the port's lowering pass is queue item A6.  Plan "
            f"it with algo='direct' for the exact direct conv.")
    if not spec.fast_eligible:
        name = registry.DIRECT
    elif algo == "auto":
        name = select_algorithm(spec)
    elif algo == registry.DIRECT:
        name = registry.DIRECT
    else:
        name = algo if resolved.R == spec.kernel_size else registry.DIRECT
    algorithm = registry.get_algorithm(name)
    if algorithm is not None \
            and getattr(backend_obj, "integer_datapath", False):
        # plan-time overflow pre-flight: the fast path accumulates real
        # int8 x int8 products in int32 on this backend
        from repro_torch.analysis import ranges
        ranges.check_spec_accumulator(spec, algorithm, algo_name=name)
    return ConvPlan(spec=spec, backend=backend, algo_name=name,
                    algorithm=algorithm, cost=estimate_cost(spec, name))


def plan(spec: ConvSpec, *, backend: str = "reference",
         algo: str = "auto") -> ConvPlan:
    """Resolve a :class:`ConvSpec` into an executable plan.

    Inspect ``plan.path`` ('fast' | 'direct') to see where execution lands.
    """
    return _plan_cached(spec, backend, algo)


def invalidate_plan_cache() -> None:
    """Drop memoized plans (the registry calls this when it changes)."""
    _plan_cached.cache_clear()
