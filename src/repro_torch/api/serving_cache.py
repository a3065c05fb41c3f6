"""ConvSpec-keyed serving cache: plan + prepared weights per workload.

The counterpart of the JAX package's ``repro.api.serving_cache``.  A
serving process resolves each conv workload to one :class:`ConvPlan` and
one :class:`PreparedWeights` *once*, ahead of (or on first) traffic, and
every later hit on the same :class:`ConvSpec` re-uses both — no
re-planning, no re-transform, no re-quantization.

``plan()`` already memoizes planning and each plan FIFO-bounds a prepared
-weights cache, but the serving loop needs more than those internals give
it:

  * one *keyed, accounted* entry point — ``get(spec, w) -> (plan, prep)``
    with hit/miss/prepare counters, so over-serving regressions
    ("re-prepared weights per request") are assertable;
  * stable identity for weights that are re-sliced out of a larger
    parameter tensor every call: pass ``key=`` and the entry survives the
    slice objects changing;
  * LRU eviction sized for a serving deployment rather than the
    per-plan FIFO.

Without ``key`` an entry is found by its operands' identity and, for
tensors, their in-place version (``plan.PrepCache.key_for``): torch
tensors can change in place where JAX arrays cannot, and an updated
weight must be prepared anew.  Operands that autograd records through
(``torch.is_grad_enabled()`` and a leaf that requires grad, the test of
``plan.PrepCache``) bypass the cache: they are prepared on every call and
counted nowhere, as the JAX package bypasses it for tracers.

The module-level :func:`get` / :func:`stats` / :func:`clear` operate on
one process-wide default cache.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from repro_torch.api.plan import (ConvPlan, PrepCache, PreparedWeights,
                                  _leaves)
from repro_torch.api.spec import ConvSpec

_ENV_MAXSIZE = "REPRO_TORCH_SERVING_CACHE_SIZE"
_DEFAULT_MAXSIZE = 256


def default_maxsize() -> int:
    """Deployment-configurable bound for the default cache
    (``REPRO_TORCH_SERVING_CACHE_SIZE``); invalid values fall back to the
    built-in default rather than crashing a serving process at import
    time."""
    raw = os.environ.get(_ENV_MAXSIZE)
    if raw is None:
        return _DEFAULT_MAXSIZE
    try:
        n = int(raw)
    except ValueError:
        return _DEFAULT_MAXSIZE
    return n if n >= 1 else _DEFAULT_MAXSIZE


class ServingCache:
    """Thread-safe LRU of (ConvSpec, backend, algo, weights) -> prepared
    execution state.  Entries pin their operands, so id-based identity
    stays valid for the entry's lifetime.  ``maxsize=None`` resolves from
    ``REPRO_TORCH_SERVING_CACHE_SIZE`` (default 256)."""

    def __init__(self, maxsize: Optional[int] = None):
        if maxsize is None:
            maxsize = default_maxsize()
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1: {maxsize}")
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, Tuple[tuple, PreparedWeights]]" \
            = OrderedDict()
        self._hits = self._misses = self._prepares = self._evictions = 0

    def get(self, spec: ConvSpec, w, *, backend: str = "reference",
            algo: str = "auto", act_scale=None, w_scale=None,
            key: Optional[Any] = None) -> Tuple[ConvPlan, PreparedWeights]:
        """Resolve ``spec`` and return its cached (plan, prepared weights).

        ``key`` is an optional stable identity for the weight operands
        (e.g. a parameter name + layer index).  The default identity is
        the operands' ids and in-place versions — right for long-lived
        weight tensors; pass ``key`` when the caller re-slices weights out
        of a larger tensor per call, where ids are not stable.  Keyed
        entries are trusted until :meth:`clear` — serving weights are
        frozen for a deployment, so a weight swap must clear the cache.
        """
        from repro_torch import faults
        from repro_torch.api import planner
        faults.maybe_fault(faults.CACHE, detail=spec)
        p = planner.plan(spec, backend=backend, algo=algo)
        operands = (w, act_scale, w_scale)
        if PrepCache._recorded(_leaves(operands)):
            # autograd records through the weights (a train step): the
            # prepared weights must carry this graph, so prepare them
            # inline and cache nothing, counting nothing, as the JAX
            # package does for tracers
            return p, p.prepare_weights(w, act_scale=act_scale,
                                        w_scale=w_scale)
        ck = (spec, backend, algo,
              key if key is not None else PrepCache.key_for(operands))
        with self._lock:
            entry = self._entries.get(ck)
            # entries are only valid for the exact plan they were prepared
            # under (identity, not equality): every plan-cache
            # invalidation — a tuning record, a cost-model fit, a
            # registered algorithm/backend overwrite — mints new plan
            # objects, and a prep whose algorithm selection predates the
            # invalidation must be redone, never paired with the fresh
            # plan
            if entry is not None and entry[2] is p and (
                    key is not None
                    or all(a is b for a, b in zip(entry[0], operands))):
                self._entries.move_to_end(ck)
                self._hits += 1
                return p, entry[1]
            self._misses += 1
        prep = p.prepare_weights(w, act_scale=act_scale, w_scale=w_scale)
        with self._lock:
            self._prepares += 1
            # replacing an invalidated same-key entry is not an eviction:
            # only capacity-driven LRU pops count, so a nonzero
            # ``evictions`` under steady traffic means the cache is sized
            # below the live working set (re-prepare churn on hot specs)
            while len(self._entries) >= self._maxsize \
                    and ck not in self._entries:
                self._entries.popitem(last=False)
                self._evictions += 1
            self._entries[ck] = (operands, prep, p)
            self._entries.move_to_end(ck)     # replaced entries become MRU
        return p, prep

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "prepares": self._prepares,
                    "evictions": self._evictions,
                    "size": len(self._entries)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hits = self._misses = self._prepares = self._evictions = 0


_DEFAULT = ServingCache()


def get_serving_cache() -> ServingCache:
    return _DEFAULT


def get(spec: ConvSpec, w, **kwargs) -> Tuple[ConvPlan, PreparedWeights]:
    """Process-wide default-cache :meth:`ServingCache.get`."""
    return _DEFAULT.get(spec, w, **kwargs)


def stats() -> Dict[str, int]:
    return _DEFAULT.stats()


def clear() -> None:
    _DEFAULT.clear()
