"""Request model for the serving subsystem (the JAX package's
``repro.serve.types``, which imports no JAX: a copy).

A :class:`Request` is one conv workload instance in flight: the input
image, the SLO class it was admitted under, and the monotonic timestamps
the engine stamps as it moves through the pipeline
(arrival -> dispatch -> done).  All serving-path timing uses
``time.perf_counter`` — a monotonic clock — never ``time.time``: latency
is a *difference* of stamps, and the wall clock can step backwards under
NTP adjustment, which would report negative (or wildly wrong) latencies
exactly when a fleet-wide time sync happens under load.

SLO classes are deadline buckets that double as the scheduling signal:
attainment is *accounted* per class (``metrics.MetricsRegistry``), and a
deadline-aware engine (``batcher.SchedulerPolicy(kind="edf")``) *forms*
batches by earliest absolute deadline (:attr:`Request.deadline_t`), so
an urgent request is dispatched ahead of slack-rich peers instead of
merely being recorded as late afterwards.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from concurrent.futures import Future
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service-level objective: a name and an end-to-end deadline."""

    name: str
    deadline_ms: float

    def met(self, e2e_ms: float) -> bool:
        return e2e_ms <= self.deadline_ms


# Default classes, the JAX package's values (so both engines make the same
# shed and scheduling decisions on the same traffic); they are engine
# *defaults*, every entry point takes explicit SLOClass objects.
INTERACTIVE = SLOClass("interactive", deadline_ms=2_000.0)
BATCH = SLOClass("batch", deadline_ms=20_000.0)

SLO_CLASSES: Dict[str, SLOClass] = {c.name: c for c in (INTERACTIVE, BATCH)}

_IDS = itertools.count()
_IDS_LOCK = threading.Lock()


def _next_id() -> int:
    with _IDS_LOCK:
        return next(_IDS)


@dataclasses.dataclass
class Request:
    """One in-flight conv request.

    ``x`` is a single unbatched image ``(h, w, C_in)``, a tensor on the
    engine's device; the engine owns batching (pad-to-bucket, stack, one
    kernel launch per fold).  The
    ``future`` resolves to a :class:`Result` — or to
    :class:`RejectedError` when admission control turns the request away.
    """

    x: Any                                   # (h, w, C_in)
    slo: SLOClass
    arrival_t: float                         # perf_counter stamp at submit
    id: int = dataclasses.field(default_factory=_next_id)
    future: Future = dataclasses.field(default_factory=Future)
    # engine-stamped:
    bucket_name: Optional[str] = None
    t_dispatch: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return int(self.x.shape[0]), int(self.x.shape[1])

    @property
    def deadline_t(self) -> float:
        """Absolute clock stamp (same clock as ``arrival_t``) at which
        this request's SLO deadline expires — the EDF scheduling key."""
        return self.arrival_t + self.slo.deadline_ms * 1e-3

    def slack_ms(self, now: float) -> float:
        """Milliseconds of headroom left before the deadline (negative:
        already expired).  Bounds how long the batch former may hold this
        request waiting for co-batchable arrivals."""
        return (self.deadline_t - now) * 1e3


@dataclasses.dataclass(frozen=True)
class Result:
    """What a request's future resolves to."""

    y: Any                                   # (h', w', C_out), bucket-cropped
    request_id: int
    bucket_name: str
    batch_size: int                          # requests folded in the dispatch
    imgs_per_step: int                       # images per kernel launch
    queue_wait_ms: float
    service_ms: float
    e2e_ms: float
    deadline_met: bool
    pad_waste_frac: float                    # padded-to-bucket pixel waste


class RejectedError(RuntimeError):
    """Admission control declined the request (reason in ``args[0]``)."""


class ShedError(RuntimeError):
    """The engine shed the request: its SLO deadline had already passed
    before dispatch (``shed_expired`` engines prefer goodput over
    throughput — serving a guaranteed-late request only delays the ones
    that can still make their deadlines)."""


class QuarantinedError(RuntimeError):
    """The request was quarantined: its batch failed dispatch repeatedly,
    bisection isolated this request as the poison, and retries were
    exhausted.  The underlying failure rides ``__cause__``."""
