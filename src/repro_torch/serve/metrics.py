"""Streaming serving metrics: latency histograms, SLO attainment, queue
depth, batch occupancy, padding waste (the JAX package's
``repro.serve.metrics``, which imports no JAX: a copy).

The registry is the engine's one accounting surface — every serving
number ``chip_smoke.py`` prints comes out of
:meth:`MetricsRegistry.snapshot`.

Histograms are *streaming*: geometric fixed buckets, O(1) memory per
observation, percentiles by linear interpolation inside the bucket.  At
the default growth factor every bucket spans <10% of its lower bound, so
a reported p99 is within 10% of the exact order statistic — tight enough
to rank serving configurations, and immune to the unbounded-sample-list
failure mode of "store everything and sort" under millions of requests.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence

# 10us .. ~300s at 1.10 growth: ~180 buckets, <10% relative error
_LO_MS = 0.01
_GROWTH = 1.10


class LatencyHistogram:
    """Fixed geometric-bucket streaming histogram of millisecond latencies."""

    def __init__(self, lo_ms: float = _LO_MS, growth: float = _GROWTH,
                 n_buckets: int = 180):
        self._lo = lo_ms
        self._log_growth = math.log(growth)
        self._bounds = [lo_ms * growth ** i for i in range(n_buckets)]
        self._counts = [0] * (n_buckets + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def _index(self, ms: float) -> int:
        if ms <= self._lo:
            return 0
        i = int(math.log(ms / self._lo) / self._log_growth) + 1
        return min(i, len(self._counts) - 1)

    def record(self, ms: float) -> None:
        ms = max(0.0, float(ms))
        self._counts[self._index(ms)] += 1
        self.count += 1
        self.sum += ms
        self.max = max(self.max, ms)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; linear interpolation inside the landing bucket."""
        if not self.count:
            return 0.0
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self._counts):
            if not c:
                continue
            if seen + c >= rank:
                lo = self._bounds[i - 1] if i >= 1 else 0.0
                hi = self._bounds[i] if i < len(self._bounds) else self.max
                frac = (rank - seen) / c
                return min(lo + frac * (hi - lo), self.max)
            seen += c
        return self.max

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean_ms": self.mean,
                "p50_ms": self.percentile(50), "p95_ms": self.percentile(95),
                "p99_ms": self.percentile(99), "max_ms": self.max}


class MetricsRegistry:
    """Thread-safe serving metrics: one instance per engine.

    Histograms: ``queue_wait_ms`` (arrival -> dispatch, also split per
    SLO class — the number a deadline-aware scheduler actually moves),
    ``service_ms`` (dispatch -> done, shared by every request in the
    batch), ``e2e_ms`` (arrival -> done, the SLO clock, also per class),
    ``hold_ms`` (batch-aging hold per dispatch).  Occupancy is tracked
    per *dispatch* (requests folded into one engine step, and the
    images each kernel launch took: ``batcher.fold_rows_per_step``).
    SLO attainment is per class.  Padding waste accumulates
    bucket-padded vs real pixels.

    Every histogram mutation happens under the registry lock:
    ``LatencyHistogram.record`` is a non-atomic read-modify-write of
    ``counts/count/sum/max``, so an unlocked record from the dispatch
    thread racing a caller thread silently loses observations (and the
    benchmark's ``count == completed`` ledger drifts).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.queue_wait_ms = LatencyHistogram()
        self.service_ms = LatencyHistogram()
        self.e2e_ms = LatencyHistogram()
        self.hold_ms = LatencyHistogram()
        self._queue_wait_by_class: Dict[str, LatencyHistogram] = {}
        self._e2e_by_class: Dict[str, LatencyHistogram] = {}
        # self-healing counters are pre-seeded so every snapshot carries
        # them (a zero is a measurement — "no sheds under this traffic" —
        # not a missing key the benchmark has to .get() around)
        self.counters: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "rejected": 0, "completed": 0,
            "shed": 0, "quarantined": 0, "dispatch_retries": 0,
            "batch_bisections": 0, "loop_errors": 0, "aged_dispatches": 0}
        self._slo: Dict[str, Dict[str, int]] = {}
        self._occupancy: List[int] = []        # requests per dispatch
        self._imgs_per_step: List[int] = []    # images per kernel launch
        self._queue_depths: List[int] = []     # sampled at dispatch time
        self._real_px = 0
        self._padded_px = 0

    # ---- recording -----------------------------------------------------
    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def record_slo(self, slo_name: str, met: bool) -> None:
        with self._lock:
            self._record_slo_locked(slo_name, met)

    def _record_slo_locked(self, slo_name: str, met: bool) -> None:
        d = self._slo.setdefault(slo_name, {"met": 0, "missed": 0})
        d["met" if met else "missed"] += 1

    def record_dispatch(self, *, occupancy: int, imgs_per_step: int,
                        queue_depth: int, service_ms: float) -> None:
        with self._lock:
            self._occupancy.append(int(occupancy))
            self._imgs_per_step.append(int(imgs_per_step))
            self._queue_depths.append(int(queue_depth))
            self.service_ms.record(service_ms)

    def record_hold(self, hold_ms: float) -> None:
        """Batch-aging hold time for one formed batch (0 = dispatched the
        instant it could; recorded per formation, before shed/retry)."""
        with self._lock:
            self.hold_ms.record(hold_ms)
            if hold_ms > 0:
                self.counters["aged_dispatches"] += 1

    def record_request(self, *, queue_wait_ms: float, e2e_ms: float,
                       slo_name: str, met: bool,
                       real_px: int, padded_px: int) -> None:
        with self._lock:
            self.queue_wait_ms.record(queue_wait_ms)
            self.e2e_ms.record(e2e_ms)
            self._queue_wait_by_class.setdefault(
                slo_name, LatencyHistogram()).record(queue_wait_ms)
            self._e2e_by_class.setdefault(
                slo_name, LatencyHistogram()).record(e2e_ms)
            self._record_slo_locked(slo_name, met)
            self.counters["completed"] += 1
            self._real_px += int(real_px)
            self._padded_px += int(padded_px)

    # ---- reading -------------------------------------------------------
    @staticmethod
    def _mean(xs: Sequence[float]) -> float:
        return sum(xs) / len(xs) if xs else 0.0

    def slo_attainment(self, slo_name: Optional[str] = None) -> float:
        """Fraction of finished requests that met their deadline (1.0 when
        nothing finished yet — no misses observed)."""
        with self._lock:
            if slo_name is None:
                met = sum(d["met"] for d in self._slo.values())
                tot = met + sum(d["missed"] for d in self._slo.values())
            else:
                d = self._slo.get(slo_name, {"met": 0, "missed": 0})
                met, tot = d["met"], d["met"] + d["missed"]
        return met / tot if tot else 1.0

    def batch_occupancy(self) -> Dict[str, float]:
        with self._lock:
            occ, imgs = list(self._occupancy), list(self._imgs_per_step)
        return {"dispatches": len(occ), "mean": self._mean(occ),
                "max": max(occ) if occ else 0,
                "imgs_per_step_mean": self._mean(imgs),
                "imgs_per_step_max": max(imgs) if imgs else 0}

    def snapshot(self) -> Dict:
        """Plain-dict view of everything (the benchmark row source)."""
        with self._lock:
            counters = dict(self.counters)
            slo = {k: dict(v) for k, v in self._slo.items()}
            depths = list(self._queue_depths)
            real_px, padded_px = self._real_px, self._padded_px
            queue_wait = self.queue_wait_ms.summary()
            service = self.service_ms.summary()
            e2e = self.e2e_ms.summary()
            hold = self.hold_ms.summary()
            wait_by_class = {k: h.summary()
                             for k, h in self._queue_wait_by_class.items()}
            e2e_by_class = {k: h.summary()
                            for k, h in self._e2e_by_class.items()}
        return {
            "counters": counters,
            "queue_wait_ms": queue_wait,
            "service_ms": service,
            "e2e_ms": e2e,
            "hold_ms": hold,
            "queue_wait_by_class": wait_by_class,
            "e2e_by_class": e2e_by_class,
            "slo": {name: {**d, "attainment": self.slo_attainment(name)}
                    for name, d in slo.items()},
            "slo_attainment": self.slo_attainment(),
            "batch_occupancy": self.batch_occupancy(),
            "queue_depth": {"mean": self._mean(depths),
                            "max": max(depths) if depths else 0},
            "pad_waste_frac": (padded_px - real_px) / padded_px
            if padded_px else 0.0,
        }
