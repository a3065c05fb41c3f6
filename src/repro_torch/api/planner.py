"""The planner: ``plan(spec, *, backend, algo="auto") -> ConvPlan``.

Algorithm resolution happens in one place, for every call site:

  * shapes a fast algorithm cannot serve natively are first handed to the
    lowering pass (``repro_torch.api.lowering``): stride-2 convs rewrite
    into polyphase stride-1 sub-specs, grouped convs into per-group dense
    sub-specs, each sub-spec planned recursively onto the fast path and
    priced by the same cost model; ``plan`` then returns a
    ``CompositePlan`` fanning out over the sub-plans;
  * only shapes that neither run natively nor lower profitably (pointwise
    1x1, kernel-tap mismatch with the requested algorithm, polyphase that
    loses to strided direct) degrade to the direct path;
  * measured wall clock from the tuning cache (``repro_torch.api.tuning``)
    takes precedence: if this (spec, backend) has been autotuned on this
    device, ``algo="auto"`` picks the fastest measured algorithm and the
    plan carries the winning kernel config;
  * next the calibrated cost model (``repro_torch.api.costmodel``), when
    fitted for this backend and device: it ranks the candidates by
    predicted time, and a cold spec's plan carries its predicted-best
    config;
  * otherwise ``algo="auto"`` ranks the registered candidates with the
    paper's BOPs cost model (``repro_torch.quant.bops``) against the direct
    baseline, at the spec's precision.  Under int8-or-lower quantization
    Winograd candidates are excluded: their transform dynamic range makes
    low-precision execution inaccurate (paper Fig. 5);
  * on integer-datapath backends the plan-time overflow pre-flight
    (``repro_torch.analysis.ranges``) rejects specs whose int32
    accumulator could wrap.

Plans are memoized on (spec, backend, algo): specs are frozen dataclasses,
so repeated call sites share one plan and its prepared-weight cache.
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


def select_algorithm(spec: ConvSpec, backend: Optional[str] = None) -> str:
    """Cheapest eligible algorithm for the spec (may be 'direct').

    With ``backend`` given, selection walks three tiers of evidence:

      1. **measured** wall clock from the tuning cache (keyed per device),
         but only when the BOPs-best candidate has itself been timed: a
         partial sweep (an autotune restricted to one algorithm, say)
         must not hide a never-measured candidate that BOPs ranks first;
      2. the **calibrated cost model** (``repro_torch.api.costmodel``),
         when fitted for this backend and device and able to price every
         eligible candidate (the same partial-knowledge rule);
      3. raw **BOPs** (``repro_torch.quant.bops``) otherwise.
    """
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
    if backend is not None:
        from repro_torch.api import costmodel, tuning
        measured = tuning.lookup(spec, backend)
        eligible = {registry.DIRECT} | {e.name for e in candidates}
        timed = {n: m["time_s"] for n, m in measured.items()
                 if n in eligible}
        if timed and best_name in timed:
            return min(timed, key=timed.get)
        modeled = costmodel.select_algorithm(spec, sorted(eligible),
                                             backend)
        if modeled is not None:
            return modeled
    return best_name


@functools.lru_cache(maxsize=512)
def _plan_cached(spec: ConvSpec, backend: str, algo: str):
    from repro_torch.api import backends
    backend_obj = backends.get_backend(backend)   # fail fast on unknown
    if algo not in ("auto", registry.DIRECT):
        # raises on unknown names even when the spec degrades to direct
        resolved = registry.get_algorithm(algo)
    if algo != registry.DIRECT:
        # the lowering pass: stride-2 -> polyphase stride-1 sub-specs,
        # groups -> per-group dense sub-specs (recursively planned and
        # cost-checked); None when the spec is native, not lowerable, or
        # the composite loses to strided or grouped direct
        from repro_torch.api import lowering
        lowered = lowering.maybe_lower(spec, backend=backend, algo=algo)
        if lowered is not None:
            return lowered
    if not spec.fast_eligible:
        name = registry.DIRECT
    elif algo == "auto":
        name = select_algorithm(spec, backend)
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
    from repro_torch.api import costmodel, tuning
    # config precedence mirrors the algorithm tiers: a measured winner
    # from the tuning cache first, else the cost model's predicted best
    # for a cold spec (None when the model is unfitted: the backend's
    # default datapath)
    config = tuning.get_config(spec, backend, name)
    if config is None and algorithm is not None:
        config = costmodel.best_config(spec, backend, name)
    return ConvPlan(spec=spec, backend=backend, algo_name=name,
                    algorithm=algorithm, cost=estimate_cost(spec, name),
                    config=config)


def plan(spec: ConvSpec, *, backend: str = "reference",
         algo: str = "auto"):
    """Resolve a :class:`ConvSpec` into an executable plan.

    Returns a :class:`ConvPlan` for native specs, or a
    ``lowering.CompositePlan`` (same ``apply``/``prepare_weights``
    surface) when the spec lowers onto SFC sub-problems; inspect
    ``plan.path`` ('fast' | 'lowered' | 'direct') rather than
    ``plan.algorithm`` to see where execution lands.
    """
    from repro_torch import faults
    faults.maybe_fault(faults.PLAN, detail=spec)
    return _plan_cached(spec, backend, algo)


def invalidate_plan_cache() -> None:
    """Drop memoized plans.

    The registry, the tuning cache and the cost model call this when their
    state changes: memoized plans embed algorithm selections and kernel
    configs resolved against that state.
    """
    _plan_cached.cache_clear()
