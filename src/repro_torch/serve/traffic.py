"""Synthetic open-loop traffic: arrival processes, shape mixes, prompts
(the JAX package's ``repro.serve.traffic``, which imports no JAX: a copy).

Open-loop means arrivals are scheduled by the *process*, not by the
server's completions — the generator never slows down because the engine
fell behind, which is the regime where queueing (and therefore p99 and
SLO attainment) actually shows up.  Closed-loop harnesses (submit, wait,
submit) hide exactly the tail this subsystem exists to measure.

Everything here is seedable (``np.random.RandomState``): the same seed
reproduces the same arrival times, shapes, SLO classes, and prompt
streams, so benchmark rows are comparable across PRs and engine tests
are deterministic.

``PromptStream`` is the prompt source of the LM serving launcher
(``repro_torch.launch.serve``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.types import BATCH, INTERACTIVE, SLOClass


# --------------------------------------------------------------------------
# arrival processes
# --------------------------------------------------------------------------
def poisson_arrivals(rate_hz: float, n: int, *, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """n absolute arrival times of a homogeneous Poisson process
    (i.i.d. exponential gaps at ``rate_hz``)."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0: {rate_hz}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    return start + np.cumsum(gaps)


def bursty_arrivals(rate_hz: float, n: int, *, seed: int = 0,
                    start: float = 0.0, burst_factor: float = 4.0,
                    period_s: float = 1.0,
                    duty: float = 0.25) -> np.ndarray:
    """Markov-modulated Poisson: the rate alternates between
    ``burst_factor * rate_hz`` (a ``duty`` fraction of each ``period_s``
    cycle, the "on" phase) and a compensating low rate, so the *average*
    rate stays ``rate_hz`` (exactly when ``duty * burst_factor <= 1``;
    above that the low phase clamps near-silent and the average rises)
    while arrivals clump — the traffic shape that separates a continuous
    batcher from a fixed-batch loop.

    A gap drawn in one phase must not leak past the phase boundary (a
    near-silent low phase would otherwise draw multi-period gaps and
    collapse the realized rate): on overshoot the clock advances TO the
    boundary and redraws — exact for exponential gaps (memorylessness).
    """
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1): {duty}")
    lo_factor = max(1e-3, (1.0 - duty * burst_factor) / (1.0 - duty))
    rng = np.random.RandomState(seed)
    times, t = [], float(start)
    while len(times) < n:
        phase = (t - start) % period_s
        on = phase < duty * period_s
        lam = rate_hz * (burst_factor if on else lo_factor)
        to_boundary = (duty * period_s if on else period_s) - phase
        gap = rng.exponential(1.0 / lam)
        if gap >= to_boundary:
            t += to_boundary
            continue
        t += gap
        times.append(t)
    return np.asarray(times)


ARRIVAL_PROCESSES = {"poisson": poisson_arrivals, "bursty": bursty_arrivals}


# --------------------------------------------------------------------------
# request shape / SLO mixes
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeMix:
    """Weighted mix of request spatial shapes."""

    shapes: Tuple[Tuple[int, int], ...]
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.weights is not None \
                and len(self.weights) != len(self.shapes):
            raise ValueError("weights must match shapes")

    def sample(self, rng: np.random.RandomState) -> Tuple[int, int]:
        p = None
        if self.weights is not None:
            w = np.asarray(self.weights, np.float64)
            p = w / w.sum()
        return self.shapes[int(rng.choice(len(self.shapes), p=p))]


def default_shape_mix(cap: int = 28) -> ShapeMix:
    """Heterogeneous shapes under ``cap`` — ragged on purpose, so the
    bucket table's pad-to-bucket path is exercised, not just exact hits."""
    shapes = [(h, w) for h, w in
              ((7, 9), (10, 10), (12, 8), (14, 14), (20, 17), (28, 28))
              if h <= cap and w <= cap]
    return ShapeMix(shapes=tuple(shapes))


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    """One scheduled request: when, what shape, which SLO class."""

    t: float
    shape: Tuple[int, int]
    slo: SLOClass


def synthesize(n: int, *, process: str = "poisson", rate_hz: float = 10.0,
               mix: Optional[ShapeMix] = None,
               slo_mix: Sequence[Tuple[SLOClass, float]] = (
                   (INTERACTIVE, 0.5), (BATCH, 0.5)),
               seed: int = 0, **process_kwargs) -> List[TrafficEvent]:
    """Deterministic open-loop schedule of ``n`` requests."""
    arrivals = ARRIVAL_PROCESSES[process](rate_hz, n, seed=seed,
                                          **process_kwargs)
    mix = mix or default_shape_mix()
    rng = np.random.RandomState(seed + 1)     # shapes/SLOs independent of
    slos = [c for c, _ in slo_mix]            # the arrival gaps
    pw = np.asarray([p for _, p in slo_mix], np.float64)
    pw = pw / pw.sum()
    return [TrafficEvent(t=float(t), shape=mix.sample(rng),
                         slo=slos[int(rng.choice(len(slos), p=pw))])
            for t in arrivals]


# --------------------------------------------------------------------------
# prompt stream (the LM serving launcher's request source)
# --------------------------------------------------------------------------
class PromptStream:
    """Seedable synthetic prompt source with a configurable length
    distribution.

    ``lengths=(lo, hi)`` draws uniform ints in [lo, hi); an explicit
    sequence (optionally with ``weights``) draws from those lengths —
    e.g. a bimodal short-chat / long-context mix.  Token ids are uniform
    over the vocabulary.
    """

    def __init__(self, vocab: int, *, lengths=(4, 16),
                 weights: Optional[Sequence[float]] = None, seed: int = 0):
        if vocab < 1:
            raise ValueError(f"vocab must be >= 1: {vocab}")
        self.rng = np.random.RandomState(seed)
        self.vocab = vocab
        if isinstance(lengths, tuple) and len(lengths) == 2 \
                and weights is None:
            lo, hi = int(lengths[0]), int(lengths[1])
            if not 0 < lo < hi:
                raise ValueError(f"need 0 < lo < hi: {lengths}")
            self._draw = lambda: int(self.rng.randint(lo, hi))
        else:
            ls = [int(x) for x in lengths]
            if any(x < 1 for x in ls):
                raise ValueError(f"prompt lengths must be >= 1: {ls}")
            p = None
            if weights is not None:
                wv = np.asarray(weights, np.float64)
                if len(wv) != len(ls):
                    raise ValueError("weights must match lengths")
                p = wv / wv.sum()
            self._draw = lambda: ls[int(self.rng.choice(len(ls), p=p))]

    def next_prompt(self) -> List[int]:
        n = self._draw()
        return self.rng.randint(0, self.vocab, size=n).tolist()
