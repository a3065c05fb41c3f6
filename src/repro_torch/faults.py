"""Deterministic, seedable fault injection for the port's SFC stack.

The counterpart of the JAX package's ``repro.faults`` (numpy only, so a
copy), with the same seven sites.  A production serving system's failure
handling is only as good as its failure *testing* — and kernel failures
(a refused launch, a build error, shared memory a geometry cannot get)
are rare enough under healthy operation that
the degradation paths they exercise would otherwise never run in CI.
This module plants named injection sites at the plan / prepare / apply /
cache / dispatch boundaries and lets tests and ``chip_smoke.py`` arm them
with per-site schedules:

    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec(p=0.05)},
                       seed=0) as fp:
        ...drive traffic...
    assert fp.injected(faults.APPLY_FUSED) > 0

Design rules:

  * **zero overhead disarmed** — every hook is one module-global load and
    a ``None`` check; nothing else executes outside an ``inject`` block;
  * **deterministic** — each site draws from its own
    ``np.random.RandomState`` stream (seeded from the plan seed and the
    site name), so one site's firing sequence depends only on how often
    *that* site is hit, not on interleaving with other sites;
  * **two fault modes** — ``raise`` (the hook raises :class:`InjectedFault`
    at the site: the kernel "crashed") and ``corrupt`` (the hook rewrites
    the site's value, by default poisoning it with NaN: the kernel
    "served garbage"), covering both halves of the resilience story
    (exception fallback and the numerical guardrail);
  * **data-dependent faults** — ``FaultSpec.when`` predicates see the
    site's detail object (the plan at apply sites, the batch at the
    dispatch site), so a test can poison exactly one request and assert
    its co-batched peers survive quarantine bisection.

The injection sites ship in the production modules of ``repro_torch``
(``api/backends.py``, ``api/plan.py``, ``api/planner.py``,
``api/serving_cache.py``, ``serve/engine.py``) — faults fire inside the
real code paths, not a test double.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np

# ---------------------------------------------------------------------------
# canonical injection sites
# ---------------------------------------------------------------------------
PLAN = "plan"                        # planner.plan entry
PREPARE = "prepare"                  # ConvPlan.prepare_weights entry
CACHE = "cache"                      # ServingCache.get entry
DISPATCH = "dispatch"                # Engine._dispatch entry (detail: Batch)
APPLY_FUSED = "apply:fused"          # cuda fused kernel call (B4, B7)
APPLY_STAGED = "apply:staged"        # cuda staged pipeline call (B1-B3)
APPLY_REFERENCE = "apply:reference"  # reference backend apply

SITES = (PLAN, PREPARE, CACHE, DISPATCH,
         APPLY_FUSED, APPLY_STAGED, APPLY_REFERENCE)


class InjectedFault(RuntimeError):
    """The exception an armed ``raise``-mode site throws.

    Deliberately a plain ``RuntimeError`` subclass: the resilience layer
    must treat it like any other kernel failure — nothing may special-case
    injected faults, or the test would not be testing the real path.
    """


def _nan_poison(value):
    import torch
    return torch.full_like(value, float("nan"))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Schedule for one site: when and how it fires.

    ``p``       per-hit firing probability (1.0 = every eligible hit);
    ``times``   total injections after which the site goes quiet
                (None = unlimited) — a bounded fault *burst*;
    ``after``   eligible hits skipped before the schedule starts;
    ``when``    optional predicate over the site's detail object — only
                matching hits are eligible (data-dependent poison);
    ``mode``    'raise' fires at :func:`maybe_fault` sites, 'corrupt' at
                :func:`maybe_corrupt` sites — one spec arms one mode;
    ``exc``     exception factory for raise mode;
    ``corrupt`` value transform for corrupt mode (default: NaN-poison).
    """

    p: float = 1.0
    times: Optional[int] = None
    after: int = 0
    when: Optional[Callable[[Any], bool]] = None
    mode: str = "raise"
    exc: Callable[[str], BaseException] = InjectedFault
    corrupt: Callable[[Any], Any] = _nan_poison

    def __post_init__(self):
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1]: {self.p}")
        if self.mode not in ("raise", "corrupt"):
            raise ValueError(f"mode must be 'raise' or 'corrupt': "
                             f"{self.mode!r}")


class FaultPlan:
    """Armed fault schedules plus per-site hit/injection accounting.

    Thread-safe: the engine's dispatch thread and a test thread may hit
    sites concurrently.  ``last_fire_t`` records a ``perf_counter`` stamp
    per site (benchmarks measure recovery time from the end of a burst).
    """

    def __init__(self, sites: Dict[str, FaultSpec], *, seed: int = 0,
                 allow_unknown_sites: bool = False):
        unknown = [s for s in sites if s not in SITES]
        if unknown and not allow_unknown_sites:
            raise ValueError(f"unknown fault site(s) {unknown}; "
                             f"known: {list(SITES)}")
        self.specs = dict(sites)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self.last_fire_t: Dict[str, float] = {}
        # per-site streams: firing order at one site is independent of
        # traffic at every other site
        self._rngs = {s: np.random.RandomState(
            (seed ^ zlib.crc32(s.encode())) & 0x7FFFFFFF) for s in sites}

    # ---- accounting ------------------------------------------------------
    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def injected(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self._injected.get(site, 0)
            return sum(self._injected.values())

    # ---- firing decision -------------------------------------------------
    def _should_fire(self, site: str, mode: str,
                     detail: Any) -> Optional[FaultSpec]:
        spec = self.specs.get(site)
        if spec is None or spec.mode != mode:
            return None
        if spec.when is not None and not spec.when(detail):
            return None
        with self._lock:
            self._hits[site] = self._hits.get(site, 0) + 1
            if self._hits[site] <= spec.after:
                return None
            if spec.times is not None \
                    and self._injected.get(site, 0) >= spec.times:
                return None
            if spec.p < 1.0 and self._rngs[site].rand() >= spec.p:
                return None
            self._injected[site] = self._injected.get(site, 0) + 1
            import time
            self.last_fire_t[site] = time.perf_counter()
        return spec


# ---------------------------------------------------------------------------
# global arming
# ---------------------------------------------------------------------------
_ACTIVE: Optional[FaultPlan] = None
_ARM_LOCK = threading.Lock()


def active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def inject(sites: Dict[str, FaultSpec], *, seed: int = 0,
           allow_unknown_sites: bool = False):
    """Arm fault schedules for the dynamic extent of the block.

    Yields the :class:`FaultPlan` for accounting assertions.  Nesting
    restores the previous plan on exit (inner blocks shadow, not merge).
    Arming is process-global — a serving engine's dispatch *thread* sees
    the faults its driving test armed, which is the point.
    """
    global _ACTIVE
    plan = FaultPlan(sites, seed=seed,
                     allow_unknown_sites=allow_unknown_sites)
    with _ARM_LOCK:
        prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        with _ARM_LOCK:
            _ACTIVE = prev


# ---------------------------------------------------------------------------
# hooks (the production-code surface)
# ---------------------------------------------------------------------------
def maybe_fault(site: str, detail: Any = None) -> None:
    """Raise-mode hook: no-op unless armed with a matching 'raise' spec."""
    plan = _ACTIVE
    if plan is None:                       # disarmed: the hot-path cost
        return
    spec = plan._should_fire(site, "raise", detail)
    if spec is not None:
        raise spec.exc(f"injected fault at {site!r}")


def maybe_corrupt(site: str, value, detail: Any = None):
    """Corrupt-mode hook: returns ``value`` unless armed to rewrite it."""
    plan = _ACTIVE
    if plan is None:
        return value
    spec = plan._should_fire(site, "corrupt", detail)
    if spec is not None:
        return spec.corrupt(value)
    return value
