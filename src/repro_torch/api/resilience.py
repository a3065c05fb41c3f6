"""Graceful degradation for ``ConvPlan.apply``: fallback chain, circuit
breakers, and an optional numerical guardrail.

The counterpart of the JAX package's ``repro.api.resilience``, engaged on
the ``cuda`` backend where the JAX one engages on ``pallas``.  A kernel
failure (a refused launch, a build error, a geometry no card can run)
would otherwise propagate straight out of ``ConvPlan.apply``, killing
every co-batched serving request and doing it again on the next batch
because nothing remembered the failure.  This module is the plan-tier
half of the resilience story:

  * **degradation chain** — on exception, the ``cuda`` int8 datapath
    falls fused (B4; depthwise B7) -> staged (B1 -> B2 -> B3; depthwise
    B1 -> B6 -> B3).  Fused and staged share one integer grid and one
    epilogue and are *bit-identical* on the card, so the fallback changes
    nothing a client can observe.  On the card the chain ends there: when
    the hand-written staged level fails too, the last error is raised,
    never answered by plain torch.  Only for tensors on the CPU — where
    the ``cuda`` backend runs the kernels' plain versions anyway — does a
    last ``reference`` level follow (and the one fallback of fp plans).
    Every use of a fallback level is counted (:func:`stats`, and the
    engine's ``MetricsRegistry``).
  * **circuit breaker per (spec, backend, level)** — ``failure_threshold``
    consecutive failures open the breaker: the broken level stops being
    *attempted* under traffic (the fallback is pinned, each request pays
    one dict lookup instead of one kernel crash).  After ``cooldown_s``
    the breaker half-opens and lets exactly one probe through; success
    closes it, failure re-opens with a fresh cool-down.
  * **numerical guardrail** (opt-in via the policy) — a cheap output
    check (NaN/Inf) plus an int8 transform-domain saturation-rate probe;
    a violation is treated exactly like a kernel exception, so garbage
    trips the same breaker instead of being served.

The chain engages only on the ``cuda`` backend with no elementwise hook
(``ConvPlan.apply`` gates it), and the healthy path costs one breaker
lookup and a ``try``.  The policy and the breakers are process-wide
state: tests :func:`reset` around each case.

Observability: every event increments a process-wide counter *and* the
thread-local metrics sink, so a serving engine attributes events from its
own dispatch thread to its own ``MetricsRegistry`` while module-level
``stats()`` still serves tests and scripts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class BreakerOpenError(RuntimeError):
    """Every degradation level's breaker is open — nothing left to try."""


class GuardrailViolation(RuntimeError):
    """The numerical guardrail rejected a level's output."""


class CircuitBreaker:
    """Consecutive-failure breaker with cool-down and half-open probe.

    State machine: CLOSED --(threshold consecutive failures)--> OPEN
    --(cooldown elapsed, next ``allow``)--> HALF_OPEN (exactly one probe
    passes) --(probe success)--> CLOSED / --(probe failure)--> OPEN.
    ``clock`` is injectable so tests step the cool-down deterministically.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1: "
                             f"{failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May this level be attempted now?  An OPEN breaker whose
        cool-down elapsed transitions to HALF_OPEN and admits exactly one
        probe; further calls are refused until the probe resolves."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() - self._opened_at >= self.cooldown_s:
                    self._state = HALF_OPEN
                    self._probing = True
                    return True
                return False
            # HALF_OPEN: one probe already in flight
            if not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> bool:
        """Returns True when this success *recovered* the breaker
        (a half-open probe came back healthy)."""
        with self._lock:
            recovered = self._state != CLOSED
            self._state = CLOSED
            self._failures = 0
            self._probing = False
            return recovered

    def record_failure(self) -> bool:
        """Returns True when this failure *tripped* the breaker
        (CLOSED -> OPEN on the threshold, or a failed half-open probe)."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._state = OPEN
                self._opened_at = self.clock()
                self._probing = False
                return True
            self._failures += 1
            if self._state == CLOSED \
                    and self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = self.clock()
                return True
            return False

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state, "failures": self._failures}


@dataclasses.dataclass(frozen=True)
class Guardrail:
    """Cheap runtime output validation for quantized plans.

    ``check_nonfinite`` scans the output for NaN/Inf (one reduction over
    ``y``).  ``max_sat_frac`` additionally probes the int8 transform-domain
    saturation rate on ``sample_images`` leading images of the input: the
    fraction of transform coefficients whose magnitude exceeds the
    calibrated clip point ``act_scale * qmax``.  A rate above the bound
    means the static scales no longer cover the live activations — the
    output is quantization garbage even though nothing crashed.
    """

    check_nonfinite: bool = True
    max_sat_frac: Optional[float] = None
    sample_images: int = 1

    def check(self, plan, x, prep, y) -> Optional[str]:
        """Violation description, or None when the output passes."""
        import torch
        if self.check_nonfinite and not bool(torch.isfinite(y).all()):
            return "non-finite values in output"
        if self.max_sat_frac is not None and prep is not None \
                and getattr(prep, "act_scale", None) is not None \
                and plan.algorithm is not None and plan.spec.rank == 2:
            from repro_torch.core import conv2d as c2d
            from repro_torch.quant.fake_quant import qmax_for_bits
            tx, _ = c2d.transform_input_2d(
                x[: self.sample_images], plan.algorithm, plan.spec.padding)
            clip = prep.act_scale[None, None, None, :, :, None] \
                * qmax_for_bits(plan.spec.quant.bits_act)
            sat = float((torch.abs(tx) > clip).float().mean())
            if sat > self.max_sat_frac:
                return (f"int8 saturation rate {sat:.4f} exceeds "
                        f"{self.max_sat_frac} (miscalibrated scales?)")
        return None


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Process-wide configuration of the degradation chain."""

    enabled: bool = True
    failure_threshold: int = 3
    cooldown_s: float = 5.0
    guardrail: Optional[Guardrail] = None
    clock: Callable[[], float] = time.monotonic


# ---------------------------------------------------------------------------
# module state: policy, breaker board, counters, metrics sink
# ---------------------------------------------------------------------------
_POLICY = ResiliencePolicy()
_BOARD: Dict[Tuple, CircuitBreaker] = {}
_BOARD_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()
_TLS = threading.local()


def policy() -> ResiliencePolicy:
    return _POLICY


def configure(p: ResiliencePolicy) -> None:
    """Install a new policy and reset breakers/counters (the thresholds
    and clock embedded in live breakers came from the old policy)."""
    global _POLICY
    _POLICY = p
    reset()


@contextlib.contextmanager
def configured(**kwargs):
    """Temporarily override policy fields (tests, benchmarks)."""
    prev = _POLICY
    configure(dataclasses.replace(prev, **kwargs))
    try:
        yield _POLICY
    finally:
        configure(prev)


def reset() -> None:
    """Drop every breaker and zero the counters (test isolation)."""
    with _BOARD_LOCK:
        _BOARD.clear()
    with _COUNTS_LOCK:
        _COUNTS.clear()


def breaker_for(key: Tuple) -> CircuitBreaker:
    with _BOARD_LOCK:
        br = _BOARD.get(key)
        if br is None:
            br = _BOARD[key] = CircuitBreaker(
                failure_threshold=_POLICY.failure_threshold,
                cooldown_s=_POLICY.cooldown_s, clock=_POLICY.clock)
        return br


def board_snapshot() -> Dict[str, Dict]:
    """Readable breaker states keyed by '<spec>|<backend>|<level>'."""
    with _BOARD_LOCK:
        items = list(_BOARD.items())
    return {f"{spec}|{backend}|{level}": br.snapshot()
            for (spec, backend, level), br in items}


def stats() -> Dict[str, int]:
    with _COUNTS_LOCK:
        return dict(_COUNTS)


@contextlib.contextmanager
def metrics_sink(inc: Callable[[str], None]):
    """Route this thread's resilience events into ``inc(counter_name)``
    as well as the global counters — the engine wraps each dispatch so
    events land in its own ``MetricsRegistry``."""
    stack = getattr(_TLS, "sinks", None)
    if stack is None:
        stack = _TLS.sinks = []
    stack.append(inc)
    try:
        yield
    finally:
        stack.pop()


def _emit(kind: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[kind] = _COUNTS.get(kind, 0) + 1
    stack = getattr(_TLS, "sinks", None)
    if stack:
        stack[-1](kind)


# ---------------------------------------------------------------------------
# the degradation chain
# ---------------------------------------------------------------------------
def engaged(plan) -> bool:
    """Does the chain wrap this plan's apply?  ``cuda``-backend plans
    only, where the JAX package has ``pallas``: the reference backend has
    nothing to fall back to."""
    return _POLICY.enabled and plan.backend == "cuda"


def _levels(plan, prep, x):
    """Yield (level_name, plan_variant) degradation levels in order.

    Quantized fast-path plans walk fused -> staged (skipping fused when
    the plan's config already picked staged).  A ``reference`` level
    follows only when ``x`` lies on the CPU: on the card the chain ends
    at the hand-written kernels and the caller gets their error.
    Direct-path plans have no fallback — the cuda backend already runs
    them as the reference backend does.  A generator so the healthy path
    never constructs the fallback plan variants.
    """
    from repro_torch.api import tuning
    if plan.algorithm is None:
        yield "primary", plan
        return
    if plan.spec.rank == 2 and prep is not None \
            and getattr(prep, "quantized", False):
        cfg = plan.config or tuning.DEFAULT_FUSED
        if cfg.datapath == "fused":
            yield "fused", plan
            yield "staged", plan.with_config(
                dataclasses.replace(cfg, datapath="staged"))
        else:
            yield "staged", plan
    else:
        yield "primary", plan
    if x.device.type == "cpu":
        yield "reference", dataclasses.replace(plan, backend="reference")


def apply_resilient(plan, x, prep, *, bias=None):
    """Run ``plan`` through the degradation chain.

    Healthy path: one breaker lookup, one try, zero copies.  On failure
    (exception or guardrail violation) the level's breaker records it and
    the next level runs; open breakers are skipped without attempting.
    Raises the last error when every level fails, or
    :class:`BreakerOpenError` when every level was breaker-skipped.
    """
    from repro_torch.api import backends
    pol = _POLICY
    last_err: Optional[BaseException] = None
    for i, (level, lp) in enumerate(_levels(plan, prep, x)):
        br = breaker_for((plan.spec, plan.backend, level))
        if not br.allow():
            _emit("resilience_breaker_skip")
            continue
        probing = br.state == HALF_OPEN
        if probing:
            _emit("resilience_breaker_probe")
        try:
            y = backends.get_backend(lp.backend).apply(lp, x, prep,
                                                       bias=bias)
            if pol.guardrail is not None:
                violation = pol.guardrail.check(lp, x, prep, y)
                if violation is not None:
                    raise GuardrailViolation(f"{level}: {violation}")
        except Exception as e:               # noqa: BLE001 — the chain IS
            last_err = e                     # the handler of last resort
            _emit("resilience_apply_failure")
            if isinstance(e, GuardrailViolation):
                _emit("resilience_guardrail_trip")
            if br.record_failure():
                _emit("resilience_breaker_trip")
            continue
        if br.record_success():
            _emit("resilience_breaker_recovered")
        if i > 0:
            _emit(f"resilience_fallback_{level}")
        return y
    if last_err is not None:
        raise last_err
    raise BreakerOpenError(
        f"every degradation level's breaker is open for {plan.spec} "
        f"on backend {plan.backend!r} (cooldown {pol.cooldown_s}s)")
