"""``ConvPlan`` — a resolved (spec, algorithm, backend) ready to execute.

A plan is produced by ``repro_torch.api.plan()`` and owns the two halves
of the deployment story:

  * :meth:`ConvPlan.prepare_weights` — the offline half: transform weights
    into the algorithm's domain once, optionally quantizing them to int8
    with calibrated static scales (paper §5-6).  Prepared weights are
    memoized per plan, keyed on each operand tensor's identity and version,
    so an in-place update (``w.mul_``, ``copy_``, ``load_state_dict``, an
    optimizer step) prepares them anew.
  * :meth:`ConvPlan.apply` — the online half: one signature for every
    backend and precision.  ``apply(x, w)`` accepts either raw weights
    (prepared on the fly) or a :class:`PreparedWeights`.  On the ``cuda``
    backend it runs through the degradation chain of
    ``repro_torch.api.resilience`` (fused -> staged, and -> reference
    only for tensors on the CPU).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional

import torch

import repro_torch.quant.fake_quant as fq
from repro_torch.api.spec import ConvSpec
from repro_torch.core.conv2d import transform_weights_2d
from repro_torch.core.generator import BilinearAlgorithm

# FIFO bound on prepared weights retained per plan.  Entries pin the raw
# weights plus their ~(t/R)^2-times-larger transform-domain copies; 16
# covers every same-spec layer of the paper's evaluation CNNs.
_PREP_CACHE_MAX = 16


def _version(o) -> Optional[int]:
    """A tensor's in-place version counter; None for anything else, and for
    an inference tensor, which keeps none."""
    if not isinstance(o, torch.Tensor):
        return None
    try:
        return o._version
    except RuntimeError:
        return None


def _leaves(operands):
    """The operands with nested tuples and lists flattened, in order."""
    for o in operands:
        if isinstance(o, (tuple, list)):
            yield from _leaves(o)
        else:
            yield o


def _key(o):
    if isinstance(o, (tuple, list)):
        return tuple(_key(v) for v in o)
    return (id(o), _version(o))


class PrepCache:
    """FIFO of prepared weights keyed on the operands' identity and version.

    Keys hold each operand's id and, for a tensor, its ``_version``, which
    every in-place update advances: JAX arrays cannot change in place, torch
    tensors can, so a hit needs the same objects at the same versions.
    Operands may nest tuples and lists (a composite plan's per-sub scales);
    the key then follows the nesting down to its leaves, so an in-place
    update of one leaf misses too.  An entry pins the leaves so the ids stay
    valid for its lifetime; a newer version of the same leaves replaces it.
    Operands that autograd is recording through are never cached, as the
    JAX package never caches tracers: a cached transform would carry the
    graph of an earlier forward (freed by its backward), or none at all if
    it was prepared under ``torch.no_grad``.
    """

    def __init__(self, maxsize: int = _PREP_CACHE_MAX):
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._entries: Dict[tuple, tuple] = {}

    @staticmethod
    def key_for(operands) -> tuple:
        return tuple(_key(o) for o in operands)

    @staticmethod
    def _same(pinned, leaves) -> bool:
        return len(pinned) == len(leaves) and \
            all(a is b for a, b in zip(pinned, leaves))

    @staticmethod
    def _recorded(leaves) -> bool:
        return torch.is_grad_enabled() and any(
            isinstance(o, torch.Tensor) and o.requires_grad for o in leaves)

    def get(self, key, operands):
        if self._recorded(_leaves(operands)):
            return None
        with self._lock:
            entry = self._entries.get(key)
        if entry is not None and \
                self._same(entry[0], tuple(_leaves(operands))):
            return entry[1]
        return None

    def put(self, key, operands, value) -> None:
        leaves = tuple(_leaves(operands))
        if self._recorded(leaves):
            return
        with self._lock:
            # an older version of the same operands is stale
            for k, (pinned, _) in list(self._entries.items()):
                if self._same(pinned, leaves):
                    del self._entries[k]
            while len(self._entries) >= self._maxsize:
                self._entries.pop(next(iter(self._entries)))
            # the cache entry keeps the leaves alive: ids stay valid
            self._entries[key] = (leaves, value)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def _normalize_w_scale(w_scale, t: int, cout: int, device) -> torch.Tensor:
    """Accept any weight-granularity scale shape; return (t, t, Cout)."""
    s = torch.as_tensor(w_scale, dtype=torch.float32, device=device)
    if s.dim() == 4:                      # keepdims (t|1, t|1, 1, Cout|1)
        return s.expand(t, t, 1, cout)[:, :, 0, :].contiguous()
    if tuple(s.shape) == (t, t, cout):
        return s.contiguous()
    if tuple(s.shape) == (t, t):          # frequency-wise
        return s[:, :, None].expand(t, t, cout).contiguous()
    if s.dim() <= 1:                      # scalar or per-channel
        return s.expand(t, t, cout).contiguous()
    raise ValueError(f"cannot interpret w_scale shape {tuple(s.shape)} "
                     f"for t={t}, Cout={cout}")


@dataclasses.dataclass(frozen=True)
class PreparedWeights:
    """Offline-processed weights for one plan.

    ``tw`` is the transform-domain fp tensor (t, t, Cin, Cout); for int8
    plans ``wq``/``w_scale``/``act_scale`` additionally hold the
    offline-quantized weights and the static scales both backends consume.
    """

    w: Any                                   # raw weights as passed in
    tw: Optional[torch.Tensor] = None
    wq: Optional[torch.Tensor] = None        # (t^2, Cin, Cout) int8
    w_scale: Optional[torch.Tensor] = None   # (t, t, Cout)
    act_scale: Optional[torch.Tensor] = None  # (t, t)

    @property
    def quantized(self) -> bool:
        return self.wq is not None


@dataclasses.dataclass(eq=False)
class ConvPlan:
    """Executable plan: call :meth:`apply`; inspect ``algorithm``/``cost``."""

    spec: ConvSpec
    backend: str
    algo_name: str                            # registry name or 'direct'
    algorithm: Optional[BilinearAlgorithm]    # None = direct path
    cost: Optional[float] = None              # planner's BOPs estimate
    config: Optional[Any] = None              # tuning.KernelConfig
    _prep: PrepCache = dataclasses.field(
        default_factory=PrepCache, repr=False)

    @property
    def path(self) -> str:
        return "direct" if self.algorithm is None else "fast"

    def with_config(self, config) -> "ConvPlan":
        """This plan with a different kernel config (shared prep cache)."""
        return dataclasses.replace(self, config=config)

    # ------------------------------------------------------------------
    # offline: weight preparation
    # ------------------------------------------------------------------
    def prepare_weights(self, w: torch.Tensor, *,
                        act_scale: Optional[torch.Tensor] = None,
                        w_scale: Optional[torch.Tensor] = None
                        ) -> PreparedWeights:
        """Pre-transform (and for int8 plans, pre-quantize) weights.

        ``act_scale`` (t, t) comes from calibration
        (``tuning.calibrate_act_scale``); it is required for the
        static-int8 execution path.  ``w_scale`` defaults to absmax scales
        at the spec's weight granularity, broadcast to (t, t, Cout).
        Results are cached per weight tensor and version; the scales are
        copied, so a PreparedWeights stays as it was prepared when the
        caller updates its operands in place.

        Backends that define ``place_prepared(plan, prep)`` (the sharded
        ``cuda_spmd`` backend: C_out-sharded ``wq``/``w_scale`` placement)
        get the prepared tensors routed through it before caching, so the
        offline half also covers device layout and a re-prepare hands back
        the placed copy.
        """
        from repro_torch import faults
        from repro_torch.api import backends     # late: avoids import cycle
        faults.maybe_fault(faults.PREPARE, detail=self)
        operands = (w, act_scale, w_scale)
        key = PrepCache.key_for(operands)
        cached = self._prep.get(key, operands)
        if cached is not None:
            return cached
        prep = self._prepare_uncached(w, act_scale, w_scale)
        place = getattr(backends.get_backend(self.backend), "place_prepared",
                        None)
        if place is not None:
            prep = place(self, prep)
        self._prep.put(key, operands, prep)
        return prep

    def _prepare_uncached(self, w, act_scale, w_scale) -> PreparedWeights:
        if self.algorithm is None:
            return PreparedWeights(w=w)
        if self.spec.rank == 1:
            raise NotImplementedError(
                "the rank-1 depthwise causal conv is a later slice of the "
                "port (queue item A12)")
        algo = self.algorithm
        # contiguous: the cuda backend's fp product reads tw as (t^2, Cin,
        # Cout) in place (the einsum leaves a permuted view, which that
        # reshape copied on every forward)
        tw = transform_weights_2d(w, algo).contiguous()
        if not self.spec.quant.enabled or act_scale is None:
            return PreparedWeights(w=w, tw=tw)
        t = algo.t
        cout = tw.shape[-1]
        if w_scale is None:
            axes = fq.weight_reduce_axes(
                tw.dim(), self.spec.quant.weight_granularity)
            amax = torch.amax(torch.abs(tw), dim=axes, keepdim=True)
            w_scale = amax / fq.qmax_for_bits(self.spec.quant.bits_weight) \
                + 1e-12
        # copies: _normalize_w_scale and reshape may return the caller's
        # tensors, whose later in-place updates would reach this snapshot
        w_scale = _normalize_w_scale(w_scale, t, cout, tw.device).clone()
        wq = fq.quantize_transformed_weights(
            tw, w_scale, self.spec.quant.bits_weight)
        act_scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                    device=tw.device).reshape(t, t)
        return PreparedWeights(w=w, tw=tw, wq=wq, w_scale=w_scale,
                               act_scale=act_scale.clone(
                                   memory_format=torch.contiguous_format))

    # ------------------------------------------------------------------
    # online: execution
    # ------------------------------------------------------------------
    def apply(self, x: torch.Tensor, w, *,
              bias: Optional[torch.Tensor] = None,
              elementwise_hook: Optional[Callable] = None) -> torch.Tensor:
        """Run the convolution.  ``w`` is raw weights or PreparedWeights.

        ``elementwise_hook(tx, tw) -> (tx, tw)`` injects transform-domain
        processing on the reference backend's fp fast path; static-int8
        plans and the ``cuda`` backend do not take hooks.

        ``cuda``-backend applies run through the resilience layer
        (``repro_torch.api.resilience``): on a kernel failure the datapath
        degrades fused -> staged (bit-identical), each fallback counted;
        on the card a staged failure is raised (the reference level
        follows only for tensors on the CPU), guarded by per-level circuit breakers so a
        persistently broken config stops being retried.  The chain
        disengages when an elementwise hook is passed (the hook's backend
        errors are contract errors, not kernel faults) and under
        ``resilience.configured(enabled=False)``.
        """
        from repro_torch.api import backends, resilience  # late: cycle
        prep = w if isinstance(w, PreparedWeights) else \
            self.prepare_weights(w)
        if elementwise_hook is None and resilience.engaged(self):
            return resilience.apply_resilient(self, x, prep, bias=bias)
        return backends.get_backend(self.backend).apply(
            self, x, prep, bias=bias, elementwise_hook=elementwise_hook)

    def __call__(self, x, w, **kwargs):
        return self.apply(x, w, **kwargs)
