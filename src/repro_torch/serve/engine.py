"""The continuous-batching conv serving engine (the JAX package's
``repro.serve.engine`` on the port's plans and kernels).

``Engine`` is the subsystem's assembly: bucket table + admission policy +
batch queue + metrics + the ConvSpec-keyed serving cache, around one conv
workload's weights, on one device (``device="cuda"`` by default; the CPU
runs the kernels' plain versions).  The lifecycle:

  * construction *warms* every bucket: each bucket's ``ConvSpec`` is
    planned, its activation scales calibrated, and its weights prepared
    (transformed + int8-quantized) through
    ``repro_torch.api.serving_cache`` — so the request path never plans,
    never transforms, never quantizes (assertable: cache ``prepares``
    stays at the bucket count under load);
  * :meth:`submit` places the image (a numpy array or a tensor) on the
    engine's device, stamps arrival (``time.perf_counter``), runs
    admission (bucket fit + queue bound) and returns a
    ``concurrent.futures.Future`` immediately — the caller never blocks
    on the batch;
  * a dispatch thread (:meth:`start`; or deterministic :meth:`step` calls
    in tests) drains the queue one same-bucket batch at a time — *which*
    batch is the engine's ``SchedulerPolicy`` (FCFS head-of-line, or
    earliest-deadline-first with optional batch aging: see
    ``batcher.SchedulerPolicy``) — pads each request to the bucket,
    stacks them, and runs the whole batch through the bucket's plan: one
    B4 launch for the batch where it folds (``batcher.fold_rows_per_step``),
    which is where continuous batching meets the card, or the staged trio
    where the bucket's config says staged;
  * the engine waits for the card (its stream) before it stamps each
    dispatch done, then crops every result back to the request's own
    output extent and resolves it into its future with full timing/SLO
    accounting.

Warm-up and dispatch run on one CUDA stream, the one current on the
device when the engine is built.

Self-healing (the resilience tier above ``repro_torch.api.resilience``'s
plan-level degradation chain):

  * **deadline shedding** (``shed_expired=True``): requests whose SLO
    deadline already passed are resolved with ``ShedError`` *before*
    dispatch;
  * **bounded retry** (``max_dispatch_retries``): a failed batch dispatch
    retries with exponential backoff — transient faults (a failure the
    degradation chain could not absorb, an injected dispatch fault)
    never surface to callers;
  * **quarantine bisection**: a batch that keeps failing is split in
    half and each half served independently, recursively — one poison
    request ends up alone, its future resolved with ``QuarantinedError``,
    and every co-batched peer is served instead of re-killed;
  * the dispatch loop retains (and counts) its own errors instead of
    swallowing them — ``stop(raise_on_error=True)`` re-raises the last
    one, and ``loop_errors`` rides the metrics snapshot.

Every decision is counted in ``MetricsRegistry`` (``shed``,
``dispatch_retries``, ``batch_bisections``, ``quarantined``,
``loop_errors``) and plan-level resilience events from this engine's
dispatches land in the same registry via ``resilience.metrics_sink``.

Bit-identity: B4's int32 sums are exact and each tile's output depends on
that tile alone, fused and staged share one epilogue, and bucket padding
is output-exact (``bucketing``) — so on the card a batched engine answer
equals the per-request ``plan.apply`` bit for bit (``chip_smoke.py``
phase 7).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import contextlib

import numpy as np
import torch

from repro_torch import faults
from repro_torch.api import resilience
from repro_torch.api import serving_cache as sc
from repro_torch.serve.batcher import (AdmissionPolicy, Batch, BatchQueue,
                                       SchedulerPolicy, fold_rows_per_step)
from repro_torch.serve.bucketing import Bucket, BucketTable
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.types import (BATCH, QuarantinedError, Request,
                                     RejectedError, Result, ShedError,
                                     SLOClass)


class Engine:
    """Continuous-batching serving engine over one conv workload."""

    def __init__(self, w, buckets: BucketTable, *,
                 backend: str = "cuda", algo: str = "auto",
                 device="cuda", max_batch: int = 8,
                 admission: Optional[AdmissionPolicy] = None,
                 cache: Optional[sc.ServingCache] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 calib_seed: int = 0, round_batches: bool = False,
                 warm_compile: bool = False, shed_expired: bool = False,
                 scheduler: Optional[SchedulerPolicy] = None,
                 max_dispatch_retries: int = 2,
                 retry_backoff_s: float = 0.02):
        self.device = torch.device(device)
        self.w = torch.as_tensor(w, dtype=torch.float32).to(self.device)
        self.buckets = buckets
        self.backend = backend
        self.algo = algo
        self.max_batch = int(max_batch)
        self.admission = admission or AdmissionPolicy()
        self.cache = cache if cache is not None else sc.ServingCache()
        self.metrics = metrics or MetricsRegistry()
        self.clock = clock
        self.scheduler = scheduler or SchedulerPolicy()
        self.queue = BatchQueue(clock=clock)
        self._act_scales: Dict[str, Optional[torch.Tensor]] = {}
        # warm-up and dispatch share one stream: the one current here
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        self.round_batches = round_batches
        self.shed_expired = shed_expired
        self.max_dispatch_retries = int(max_dispatch_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._inflight = 0
        self._inflight_zero = threading.Condition()
        self._loop_errors = 0
        self._last_loop_error: Optional[BaseException] = None
        # per-bucket provenance of the warm-up kernel config: 'measured'
        # (timing-cache entry), 'model' (cost-model prediction for a cold
        # bucket), or 'default' (the backend's default datapath)
        self.warm_sources: Dict[str, str] = {}
        with self._on_stream():
            self._warm(calib_seed)
            if warm_compile:
                self._warm_compile()

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()

    # ------------------------------------------------------------------
    # startup: warm every bucket off the request path
    # ------------------------------------------------------------------
    def _warm(self, calib_seed: int) -> None:
        """Plan + calibrate + prepare each bucket through the serving
        cache.  Activation scales are absmax-calibrated per bucket on a
        synthetic batch (a deployment would substitute PTQ calibration
        data); the scale arrays are pinned here so the cache's identity
        checks hold for the engine's lifetime.  The provenance reads the
        tuning cache and the cost model under the device token the planner
        resolved the plans with."""
        from repro_torch.api import costmodel, tuning
        from repro_torch.api.tuning import calibrate_act_scale
        rng = np.random.RandomState(calib_seed)
        for b in self.buckets.buckets:
            p = self._plan(b)
            # warm-config provenance: a timed bucket rides its measured
            # winner; a COLD bucket with a fitted cost model rides the
            # model-predicted config (planner fallback) instead of
            # blocking construction on an exhaustive sweep
            if tuning.lookup(b.spec, self.backend):
                src = "measured"
            elif p.path == "fast" and getattr(p, "config", None) is not None \
                    and costmodel.is_fitted(self.backend):
                src = "model"
            else:
                src = "default"
            self.warm_sources[b.name] = src
            self.metrics.inc(f"warm_config_{src}")
            scale = None
            if p.spec.quant.enabled and p.path == "fast" \
                    and p.algorithm is not None:
                xc = torch.as_tensor(
                    rng.randn(1, b.h, b.w, b.spec.in_channels),
                    dtype=torch.float32).to(self.device)
                scale = calibrate_act_scale(xc, p.algorithm, p.spec.quant,
                                            p.spec.padding)
            self._act_scales[b.name] = scale
            self.cache.get(b.spec, self.w, backend=self.backend,
                           algo=self.algo, act_scale=scale,
                           key=("serve", b.name, self.device))

    def _plan(self, bucket: Bucket):
        from repro_torch.api import planner
        return planner.plan(bucket.spec, backend=self.backend,
                            algo=self.algo)

    # ---- batch-shape bounding ----------------------------------------
    def _batch_sizes(self) -> List[int]:
        """The dispatch batch shapes this engine can emit (with
        ``round_batches``: powers of two up to ``max_batch``, plus
        ``max_batch`` itself) — the set ``_warm_compile`` pre-traces."""
        if not self.round_batches:
            return list(range(1, self.max_batch + 1))
        sizes, s = [], 1
        while s < self.max_batch:
            sizes.append(s)
            s *= 2
        sizes.append(self.max_batch)
        return sizes

    def _round_batch(self, n: int) -> int:
        if not self.round_batches:
            return n
        return next(s for s in self._batch_sizes() if s >= n)

    def _warm_compile(self) -> None:
        """Run every (bucket, batch shape) dispatch once off the request
        path: one zero-input dispatch per combination, routed through the
        exact request-path code (fold included), so live traffic never
        pays a first shape's one-time costs (the kernel build, each
        geometry's host-side tables)."""
        for b in self.buckets.buckets:
            for s in self._batch_sizes():
                reqs = [Request(x=torch.zeros((b.h, b.w, b.spec.in_channels),
                                              device=self.device),
                                slo=BATCH, arrival_t=self.clock())
                        for _ in range(s)]
                self._dispatch(Batch(bucket=b, requests=reqs), record=False)

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def submit(self, x, slo: SLOClass = BATCH) -> Future:
        """Admit one (h, w, C_in) image, a numpy array or a tensor, placed
        on the engine's device as float32; returns a Future of
        ``Result``.

        Rejections resolve the future immediately with
        :class:`RejectedError` — an open-loop client observes back
        pressure as failed futures, not blocked submits.
        """
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        req = Request(x=x, slo=slo, arrival_t=self.clock())
        self.metrics.inc("submitted")
        h, w = req.shape
        bucket = self.buckets.bucket_for(h, w)
        ok, reason = self.admission.admit_shape(req, bucket)
        if not ok:
            self.metrics.inc("rejected")
            req.future.set_exception(RejectedError(reason))
            return req.future
        req.bucket_name = bucket.name
        with self._inflight_zero:
            self._inflight += 1
        # the depth bound is enforced atomically INSIDE the queue lock —
        # a sampled depth() followed by put() lets concurrent submitters
        # overshoot the admission bound (TOCTOU)
        if not self.queue.put_if_below(req, bucket,
                                       self.admission.max_queue_depth):
            with self._inflight_zero:
                self._inflight -= 1
                if self._inflight == 0:
                    self._inflight_zero.notify_all()
            self.metrics.inc("rejected")
            req.future.set_exception(RejectedError(
                self.admission.depth_reason(self.admission.max_queue_depth)))
            return req.future
        self.metrics.inc("admitted")
        return req.future

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def step(self, timeout: Optional[float] = 0) -> int:
        """Drain ONE batch synchronously; returns requests resolved
        (served, shed, or quarantined — 0 when the queue stayed empty
        *or* batch aging is holding an underfull batch whose window is
        still open: with ``timeout=0`` the hold never blocks, so
        deterministic tests advance the injected clock instead).
        The deterministic entry point tests and the dispatch thread
        share.  Dispatch failures are absorbed by retry, bisection, and
        quarantine — ``step`` itself only raises on failures *outside*
        the serve path (e.g. batch formation), and even then every taken
        request's future is resolved first."""
        batch = self.queue.take_batch(self.max_batch, timeout=timeout,
                                      policy=self.scheduler)
        if batch is None:
            return 0
        self.metrics.record_hold(batch.hold_ms)
        n = len(batch)
        try:
            batch = self._shed_past_deadline(batch)
            if batch.requests:
                self._serve_batch(batch)
        except Exception as e:             # resolve, don't wedge callers
            for r in batch.requests:
                if not r.future.done():
                    r.future.set_exception(e)
            raise
        finally:
            with self._inflight_zero:
                self._inflight -= n
                if self._inflight == 0:
                    self._inflight_zero.notify_all()
        return n

    # ---- self-healing serve path -------------------------------------
    def _shed_past_deadline(self, batch: Batch) -> Batch:
        """Resolve already-expired requests with ``ShedError`` (counted,
        SLO-missed) and return the still-viable remainder."""
        if not self.shed_expired:
            return batch
        now = self.clock()
        kept = []
        for r in batch.requests:
            if (now - r.arrival_t) * 1e3 > r.slo.deadline_ms:
                self.metrics.inc("shed")
                self.metrics.record_slo(r.slo.name, met=False)
                r.future.set_exception(ShedError(
                    f"deadline {r.slo.deadline_ms:.0f}ms passed before "
                    f"dispatch (queued {(now - r.arrival_t) * 1e3:.0f}ms)"))
            else:
                kept.append(r)
        return Batch(bucket=batch.bucket, requests=kept)

    def _serve_batch(self, batch: Batch) -> None:
        """Dispatch with bounded retry; on persistent failure, bisect the
        batch so one poison request cannot re-kill its co-batched peers.
        Never raises: a single request that still fails alone is resolved
        with ``QuarantinedError`` carrying the underlying failure."""
        err: Optional[BaseException] = None
        for attempt in range(self.max_dispatch_retries + 1):
            # a partial failure may have resolved some futures already
            pending = [r for r in batch.requests if not r.future.done()]
            if not pending:
                return
            batch = Batch(bucket=batch.bucket, requests=pending)
            if attempt and self.retry_backoff_s > 0:
                time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
            try:
                self._dispatch(batch)
                return
            except Exception as e:
                err = e
                if attempt < self.max_dispatch_retries:
                    self.metrics.inc("dispatch_retries")
        pending = [r for r in batch.requests if not r.future.done()]
        if len(pending) <= 1:
            for r in pending:
                self.metrics.inc("quarantined")
                q = QuarantinedError(
                    f"request {r.id} failed "
                    f"{self.max_dispatch_retries + 1} dispatch attempts")
                q.__cause__ = err
                r.future.set_exception(q)
            return
        self.metrics.inc("batch_bisections")
        mid = len(pending) // 2
        self._serve_batch(Batch(bucket=batch.bucket,
                                requests=pending[:mid]))
        self._serve_batch(Batch(bucket=batch.bucket,
                                requests=pending[mid:]))

    def _dispatch(self, batch: Batch, record: bool = True) -> None:
        if record:
            # warm-compile dispatches (record=False) are construction-time
            # plumbing, not traffic: an armed fault burst (times=...) must
            # fire under load, not be consumed warming the engine
            faults.maybe_fault(faults.DISPATCH, detail=batch)
        bucket = batch.bucket
        t_dispatch = self.clock()
        depth_after = self.queue.depth()
        B_real = len(batch)
        B = self._round_batch(B_real)
        imgs_list = [BucketTable.pad_to(r.x, bucket)
                     for r in batch.requests]
        if B > B_real:
            # round the batch shape up with zero images (outputs dropped):
            # the set of batch shapes stays bounded, per-image independence
            # keeps every real output bit-identical
            zero = torch.zeros_like(imgs_list[0])
            imgs_list += [zero] * (B - B_real)
        xb = torch.stack(imgs_list)
        plan, prep = self.cache.get(
            bucket.spec, self.w, backend=self.backend, algo=self.algo,
            act_scale=self._act_scales[bucket.name],
            key=("serve", bucket.name, self.device))
        fold = fold_rows_per_step(plan, B)
        imgs = 1 if fold is None else fold[1]
        # plan-level resilience events (fallbacks, breaker trips) raised
        # by THIS dispatch land in THIS engine's registry; the card is
        # waited for before the dispatch is stamped done
        with resilience.metrics_sink(self.metrics.inc), self._on_stream():
            y = plan.apply(xb, prep)
            if self._stream is not None:
                self._stream.synchronize()
        t_done = self.clock()
        if not record:
            return
        service_ms = (t_done - t_dispatch) * 1e3
        self.metrics.record_dispatch(
            occupancy=B_real, imgs_per_step=imgs,
            queue_depth=depth_after, service_ms=service_ms)
        if B > B_real:
            self.metrics.inc("batch_pad_imgs", B - B_real)
        for i, r in enumerate(batch.requests):
            if r.future.done():            # resolved on an earlier attempt
                continue
            r.t_dispatch, r.t_done = t_dispatch, t_done
            h, w = r.shape
            yi = BucketTable.crop_output(y[i], h, w, bucket)
            queue_wait_ms = (t_dispatch - r.arrival_t) * 1e3
            e2e_ms = (t_done - r.arrival_t) * 1e3
            met = r.slo.met(e2e_ms)
            self.metrics.record_request(
                queue_wait_ms=queue_wait_ms, e2e_ms=e2e_ms,
                slo_name=r.slo.name, met=met,
                real_px=h * w, padded_px=bucket.h * bucket.w)
            r.future.set_result(Result(
                y=yi, request_id=r.id, bucket_name=bucket.name,
                batch_size=len(batch), imgs_per_step=imgs,
                queue_wait_ms=queue_wait_ms, service_ms=service_ms,
                e2e_ms=e2e_ms, deadline_met=met,
                pad_waste_frac=bucket.waste(h, w)))

    # ------------------------------------------------------------------
    # async dispatch thread
    # ------------------------------------------------------------------
    def start(self) -> "Engine":
        if self._thread is not None:
            return self
        # a retained error belongs to the PREVIOUS run: stop(raise_on_
        # error=True) after a clean second run must not re-raise it
        self._last_loop_error = None
        self._running.set()

        def loop():
            while self._running.is_set():
                try:
                    self.step(timeout=0.02)
                except Exception as e:
                    # the futures of the failed batch already carry the
                    # error (``step`` resolves before re-raising); the
                    # loop keeps serving — but the failure is COUNTED and
                    # RETAINED, never silently dropped: ``loop_errors``
                    # rides every snapshot and ``stop(raise_on_error=
                    # True)`` re-raises the last one
                    self._loop_errors += 1
                    self._last_loop_error = e
                    self.metrics.inc("loop_errors")

        self._thread = threading.Thread(target=loop, name="serve-dispatch",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, raise_on_error: bool = False) -> None:
        """Stop the dispatch thread.  ``raise_on_error=True`` re-raises
        the last error the loop absorbed (if any) once the thread has
        joined — the shutdown-time check that the loop's error counter is
        not hiding a persistent failure."""
        if self._thread is not None:
            self._running.clear()
            self._thread.join()
            self._thread = None
        if raise_on_error and self._last_loop_error is not None:
            raise self._last_loop_error

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request resolved (True) or timeout."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._inflight_zero:
            while self._inflight > 0:
                rem = None if deadline is None \
                    else deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    return False
                self._inflight_zero.wait(rem if rem is not None else 0.5)
        return True

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """Metrics + serving-cache stats (with derived hit rate) in one
        dict — the benchmark row source."""
        snap = self.metrics.snapshot()
        cstats = self.cache.stats()
        lookups = cstats["hits"] + cstats["misses"]
        snap["serving_cache"] = {
            **cstats,
            "hit_rate": cstats["hits"] / lookups if lookups else 0.0,
        }
        snap["buckets"] = [b.name for b in self.buckets.buckets]
        snap["warm_config_sources"] = dict(self.warm_sources)
        snap["scheduler"] = {"kind": self.scheduler.kind,
                             "max_hold_ms": self.scheduler.max_hold_ms}
        snap["loop_errors"] = self._loop_errors
        snap["last_loop_error"] = (repr(self._last_loop_error)
                                   if self._last_loop_error else None)
        snap["breakers"] = resilience.board_snapshot()
        return snap

    @property
    def last_loop_error(self) -> Optional[BaseException]:
        return self._last_loop_error

    def __enter__(self) -> "Engine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def results(futures: List[Future], timeout: Optional[float] = None
            ) -> List[Result]:
    """Gather resolved results (rejected futures raise RejectedError)."""
    return [f.result(timeout=timeout) for f in futures]
