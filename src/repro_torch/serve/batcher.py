"""Admission control, batch scheduling, and continuous batch formation
(the JAX package's ``repro.serve.batcher``; only the fold decision,
:func:`fold_rows_per_step`, reads the port's own kernel geometry).

The batcher owns the request queue between ``Engine.submit`` and the
dispatch loop.  *How* batches are formed is a :class:`SchedulerPolicy`:

  * ``fcfs`` — head-of-line: the oldest request's bucket, joined by
    every queued same-bucket request in arrival order.  Simple, fair by
    arrival, but blind to deadlines: one slack-rich batch request at the
    head delays an urgent interactive request queued behind it in a
    different bucket.
  * ``edf`` — earliest-deadline-first: the batch is the bucket of the
    most urgent request (smallest ``Request.deadline_t``), filled with
    same-bucket peers in deadline order.  An already-expired request has
    the earliest deadline of all, so it is dispatched (and shed) first
    rather than starving unresolved behind still-viable work.  This is
    what turns the SLO classes from accounting labels into scheduling:
    ``shed_expired`` becomes the backstop EDF makes rare, not the
    mechanism.

Either policy composes with **batch aging** (``max_hold_ms > 0``): an
underfull batch is *held* — ``take_batch`` reports nothing ready — while
the head request is younger than the hold window, so co-batchable
arrivals fold into one fused launch instead of dispatching 1-image
slivers.  The hold is bounded by the head request's own slack (a hold
must never turn a viable request into a shed), and ends the instant the
batch reaches ``max_batch``.  Hold decisions are pure functions of the
injected clock, so tests drive them deterministically.

In either mode, heterogeneous shapes never mix inside one dispatch, so
each dispatch is one warm ``ConvSpec`` and, where the batch folds, one
fused-kernel launch.
Same-bucket matching is by *equality* (``Bucket`` is a frozen
dataclass), never identity: equal buckets reached via distinct objects
(two tables over one workload) must co-batch.

:func:`fold_rows_per_step` is the serving-side view of the fused
kernel's launch: whether the batch the batcher formed goes to the card as
*one* B4 launch of all its images.  The fit decision
goes through the static resource checker
(``repro_torch.analysis.kernel_checks.fold_fits``), which resolves the
launch geometry the kernel's wrapper would use, so the batcher never asks
for a launch the kernel would refuse and never re-derives kernel
arithmetic.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

from repro_torch.serve.bucketing import Bucket
from repro_torch.serve.types import Request


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """How the batch former picks and fills the next dispatch.

    ``kind``        ``"fcfs"`` (head-of-line arrival order) or ``"edf"``
                    (earliest-deadline-first: most urgent viable request
                    picks the bucket, peers fill in deadline order);
    ``max_hold_ms`` batch-aging window: an underfull batch is held up to
                    this long past its head request's arrival — bounded
                    by the head's SLO slack — waiting for co-batchable
                    arrivals.  0 disables aging (dispatch the instant
                    the queue is non-empty, the pre-scheduler behavior).
    """

    kind: str = "fcfs"
    max_hold_ms: float = 0.0

    def __post_init__(self):
        if self.kind not in ("fcfs", "edf"):
            raise ValueError(f"kind must be 'fcfs' or 'edf': {self.kind!r}")
        if self.max_hold_ms < 0:
            raise ValueError(f"max_hold_ms must be >= 0: {self.max_hold_ms}")


FCFS = SchedulerPolicy(kind="fcfs")
EDF = SchedulerPolicy(kind="edf")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounded-queue admission: reject rather than queue unboundedly.

    ``max_queue_depth`` is the back-pressure bound (an open-loop arrival
    process does not slow down when the engine falls behind — without a
    bound the queue, and every latency behind it, grows without limit).
    Requests whose shape fits no bucket are rejected outright: padding
    down (truncation) would silently corrupt outputs.  So are requests
    whose output would be *empty* under the workload (a VALID conv on an
    image smaller than the kernel): serving a 0-row tensor is a silent
    data-loss bug, not an answer.

    The depth bound itself is enforced atomically by
    :meth:`BatchQueue.put_if_below` — checking ``queue.depth()`` first
    and putting after is a TOCTOU race under concurrent submitters.
    :meth:`admit` keeps the combined (shape + sampled-depth) check for
    single-threaded callers; the engine uses :meth:`admit_shape` plus
    the atomic put.
    """

    max_queue_depth: int = 256

    def admit_shape(self, request: Request,
                    bucket: Optional[Bucket]) -> Tuple[bool, Optional[str]]:
        """Depth-independent checks: bucket fit and output viability."""
        h, w = request.shape
        if bucket is None:
            return False, f"no bucket fits shape ({h}, {w})"
        r = bucket.spec.kernel_size
        if bucket.spec.padding == "VALID" and (h < r or w < r):
            return False, (
                f"shape ({h}, {w}) is smaller than the {r}x{r} kernel: a "
                f"VALID conv output would be empty")
        return True, None

    def depth_reason(self, queue_depth: int) -> str:
        return f"queue depth {queue_depth} at limit {self.max_queue_depth}"

    def admit(self, request: Request, bucket: Optional[Bucket],
              queue_depth: int) -> Tuple[bool, Optional[str]]:
        ok, reason = self.admit_shape(request, bucket)
        if not ok:
            return ok, reason
        if queue_depth >= self.max_queue_depth:
            return False, self.depth_reason(queue_depth)
        return True, None


@dataclasses.dataclass
class Batch:
    """One dispatch unit: same-bucket requests, in formation order.

    ``hold_ms`` is how long the batch former aged this batch (time the
    oldest member spent waiting in the hold window before formation,
    clamped to the policy's ``max_hold_ms``; 0 when aging is off).
    """

    bucket: Bucket
    requests: List[Request]
    hold_ms: float = 0.0

    def __len__(self) -> int:
        return len(self.requests)


class BatchQueue:
    """Thread-safe request queue with policy-driven batch formation.

    The queue stores arrival order; :meth:`take_batch` *forms* a batch
    according to a :class:`SchedulerPolicy` (FCFS head-of-line or EDF)
    without disturbing the positions of requests it leaves behind.  The
    clock is injected so hold-window (aging) decisions are deterministic
    under test clocks.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._q: Deque[Tuple[Request, Bucket]] = deque()
        self._clock = clock

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def put(self, request: Request, bucket: Bucket) -> None:
        with self._nonempty:
            self._q.append((request, bucket))
            self._nonempty.notify()

    def put_if_below(self, request: Request, bucket: Bucket,
                     bound: int) -> bool:
        """Atomically enqueue iff the depth is below ``bound``.

        The admission depth check and the enqueue happen under ONE lock
        acquisition — the only way a concurrent-submitter fleet cannot
        overshoot the bound (read-depth-then-put is a TOCTOU race).
        """
        with self._nonempty:
            if len(self._q) >= bound:
                return False
            self._q.append((request, bucket))
            self._nonempty.notify()
            return True

    # ---- formation ----------------------------------------------------
    @staticmethod
    def _edf_key(req: Request) -> Tuple[float, float, int]:
        # deterministic total order: deadline, then arrival, then id
        return (req.deadline_t, req.arrival_t, req.id)

    def _candidate(self, max_batch: int, policy: SchedulerPolicy
                   ) -> List[Tuple[Request, Bucket]]:
        """The (request, bucket) pairs the policy would dispatch next.
        Caller holds the lock.  Never returns empty for a non-empty
        queue."""
        if policy.kind == "edf":
            # an expired request has the earliest deadline of all, so it
            # sorts maximally urgent and is dispatched (-> shed backstop)
            # immediately instead of starving behind still-viable work
            _, head_bucket = min(self._q,
                                 key=lambda rb: self._edf_key(rb[0]))
            peers = sorted((rb for rb in self._q if rb[1] == head_bucket),
                           key=lambda rb: self._edf_key(rb[0]))
            return peers[:max_batch]
        head_bucket = self._q[0][1]
        return [rb for rb in self._q if rb[1] == head_bucket][:max_batch]

    def _hold_until(self, taken: List[Tuple[Request, Bucket]],
                    policy: SchedulerPolicy) -> float:
        """Absolute clock stamp the aging window for this candidate
        closes at: head arrival + ``max_hold_ms``, bounded by the
        earliest member deadline (holding must never expire a request)."""
        head_arrival = min(r.arrival_t for r, _ in taken)
        earliest_deadline = min(r.deadline_t for r, _ in taken)
        return min(head_arrival + policy.max_hold_ms * 1e-3,
                   earliest_deadline)

    def take_batch(self, max_batch: int, timeout: Optional[float] = None,
                   policy: Optional[SchedulerPolicy] = None
                   ) -> Optional[Batch]:
        """Form one batch under ``policy`` (default FCFS, no aging).

        Blocks up to ``timeout`` for a first request; ``timeout=0``
        polls.  Returns None when nothing arrived — or when aging is
        holding an underfull batch whose window is still open (in poll
        mode the caller re-polls; in blocking mode the wait happens
        here, waking early if an arrival completes the batch).
        Requests left behind keep their queue positions.
        """
        policy = policy or FCFS
        with self._nonempty:
            if not self._q and timeout != 0:
                self._nonempty.wait(timeout)
            while True:
                if not self._q:
                    return None
                now = self._clock()
                taken = self._candidate(max_batch, policy)
                hold_until = (self._hold_until(taken, policy)
                              if policy.max_hold_ms > 0 else now)
                if len(taken) >= max_batch or now >= hold_until:
                    break
                # aging: the window is open and the batch is underfull
                if timeout == 0:
                    return None            # poll mode never blocks
                self._nonempty.wait(hold_until - now)
            taken_ids = {r.id for r, _ in taken}
            self._q = deque(rb for rb in self._q
                            if rb[0].id not in taken_ids)
            head_arrival = min(r.arrival_t for r, _ in taken)
            hold_ms = (min((now - head_arrival) * 1e3, policy.max_hold_ms)
                       if policy.max_hold_ms > 0 else 0.0)
            return Batch(bucket=taken[0][1],
                         requests=[r for r, _ in taken],
                         hold_ms=max(0.0, hold_ms))


def fold_rows_per_step(plan, batch_size: int
                       ) -> Optional[Tuple[int, int, int]]:
    """(rows_per_step, imgs, rows): how the batch folds into the fused
    kernel's launches, the JAX package's return contract.

    On the card a *step* is one B4 launch.  B4 has no ``rows_per_step``
    knob (the TPU kernel's image-folding grid): it takes every tile of
    the images it is given in one launch, with a geometry
    (``kernels.sfc_fused.fused_geometry``) sized for them, so the JAX
    function's walk down the divisors of the batch has nothing to find
    below the whole batch (a smaller launch needs the same shared memory
    and block shape; only the grid's 65535 groups of 16 tiles, beyond any
    batch the engine forms, grow with it).  The decision left is fold or
    not: whether the
    batch's single launch passes the static checks
    (``analysis.kernel_checks.fold_fits``: KC001-KC004).  ``rows`` is the
    tile rows of one image (nH) and ``rows_per_step = imgs * rows`` the
    tile rows of the launch, as in the JAX package.

    Returns None for plans the folding does not apply to (direct or
    lowered paths, unquantized or depthwise, or a config that picked the
    staged datapath) and where the launch fails the checks: the dispatch
    then runs the plan as it is and ``imgs_per_step`` records 1.  The
    checks run once per (spec, config, batch size); a dispatch after the
    first of its shape looks the answer up.
    """
    from repro_torch.api import tuning
    spec = plan.spec
    if plan.path != "fast" or plan.algorithm is None \
            or not spec.quant.enabled or spec.depthwise \
            or spec.spatial is None:
        return None
    cfg = plan.config or tuning.DEFAULT_FUSED
    if cfg.datapath != "fused":
        return None
    return _fold(plan.algorithm, spec, cfg, max(1, batch_size))


@functools.lru_cache(maxsize=1024)
def _fold(algo, spec, cfg, b: int) -> Optional[Tuple[int, int, int]]:
    from repro_torch.analysis import kernel_checks
    from repro_torch.core import conv2d as c2d
    H, W = spec.spatial
    nH = c2d.tile_grid(H, W, algo.M, algo.R, spec.padding).nH
    if kernel_checks.fold_fits(algo, cfg, b, H, W, spec.in_channels,
                               spec.out_channels, padding=spec.padding):
        return b * nH, b, nH
    return None
