"""The port's serving subsystem (``repro_torch.serve``) against the JAX
package's (``repro.serve``).

The same requests, seeds and a fake clock go through the JAX
``Engine(backend="reference")`` and the port's ``Engine(device="cpu")`` on
its ``reference`` and ``cuda`` backends (the kernels' plain versions on
CPU tensors).  Both must make the same decisions: the same batch of each
request (bucket, batch size, images per launch), the same sheds, retries,
bisections and quarantines, the same SLO accounting and counters, the
same ``warm_sources``; outputs agree within ``DEFAULT_TOL`` of the
output's scale.  Within the port a batched answer equals the per-request
one bit for bit.  The copied modules (traffic, metrics, bucketing) give
the JAX modules' values.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as jserve  # noqa: E402
from repro import faults as jfaults  # noqa: E402
from repro.api.serving_cache import ServingCache as JServingCache  # noqa: E402
from repro.quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

import repro_torch.serve as tserve  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.analysis import kernel_checks  # noqa: E402
from repro_torch.api import (ConvSpec, costmodel, plan, registry,  # noqa: E402
                             resilience, tuning)
from repro_torch.api.serving_cache import ServingCache  # noqa: E402
from repro_torch.quant import FP32, INT8_FREQ  # noqa: E402
from repro_torch.serve import (BATCH, INTERACTIVE,  # noqa: E402
                               BucketTable, Engine, LatencyHistogram,
                               QuarantinedError, RejectedError,
                               SchedulerPolicy, ShapeMix, ShedError,
                               fold_rows_per_step, results, synthesize)
from repro_torch.testing import DEFAULT_TOL  # noqa: E402

CIN, COUT = 8, 16
SHAPES = ((10, 10), (14, 14), (20, 20))
POISON = 77.0


@pytest.fixture(autouse=True)
def _isolated(tmp_path):
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    costmodel.set_cache_path(str(tmp_path / "port_costmodel.json"))
    resilience.reset()
    yield
    resilience.reset()
    tuning.set_cache_path(None)
    costmodel.set_cache_path(None)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _weights(seed=0):
    w = np.random.RandomState(seed).randn(3, 3, CIN, COUT) * 0.2
    return w.astype(np.float32)


def _tables(shapes=SHAPES, padding="SAME"):
    mine = BucketTable.for_workload(shapes, kernel_size=3, in_channels=CIN,
                                    out_channels=COUT, padding=padding,
                                    quant=INT8_FREQ)
    theirs = jserve.BucketTable.for_workload(
        shapes, kernel_size=3, in_channels=CIN, out_channels=COUT,
        padding=padding, quant=JINT8_FREQ)
    return mine, theirs


def _images(shapes, seed=1, poison=()):
    rng = np.random.RandomState(seed)
    out = []
    for i, (h, w) in enumerate(shapes):
        x = rng.randn(h, w, CIN).astype(np.float32)
        if i in poison:
            x[0, 0, 0] = POISON
        out.append(x)
    return out


def _is_poisoned(batch):
    return any(float(r.x[0, 0, 0]) == POISON for r in batch.requests)


def _outcome(fut, mod):
    try:
        r = fut.result(timeout=0)
    except (mod.ShedError, mod.QuarantinedError, mod.RejectedError) as e:
        return type(e).__name__, None
    return (r.bucket_name, r.batch_size, r.imgs_per_step, r.deadline_met,
            round(r.queue_wait_ms, 6), round(r.e2e_ms, 6)), np.asarray(r.y)


def _run_script(eng, clock, mod, xs, script):
    """Drive ``eng`` through ``script``: ("submit", t, i, slo) submits
    image i at clock t, ("step", t) steps once at clock t, ("drain", t)
    steps until nothing is served.  Returns each step's count, each
    request's outcome and output."""
    slos = {"i": mod.INTERACTIVE, "b": mod.BATCH}
    futs, steps = {}, []
    for op in script:
        clock.t = op[1]
        if op[0] == "submit":
            x = xs[op[2]] if mod is jserve else xs[op[2]].copy()
            futs[op[2]] = eng.submit(jnp.asarray(x) if mod is jserve else x,
                                     slos[op[3]])
        elif op[0] == "step":
            steps.append(eng.step())
        else:
            while True:
                n = eng.step()
                steps.append(n)
                if n == 0:
                    break
    return steps, {i: _outcome(f, mod) for i, f in sorted(futs.items())}


def _snapshot_view(eng):
    snap = eng.snapshot()
    return {k: snap[k] for k in (
        "counters", "queue_wait_ms", "service_ms", "e2e_ms", "hold_ms",
        "queue_wait_by_class", "e2e_by_class", "slo", "slo_attainment",
        "batch_occupancy", "queue_depth", "pad_waste_frac", "buckets",
        "warm_config_sources", "scheduler")}


def _compare(script, xs, backend, faults_armed=None, shapes=SHAPES,
             **engine_kw):
    """The script through the JAX engine and the port's; asserts the same
    decisions and outputs within DEFAULT_TOL; returns the port engine."""
    mine_t, theirs_t = _tables(shapes)
    runs = []
    for mod, fmod, table in ((tserve, faults, mine_t),
                             (jserve, jfaults, theirs_t)):
        clock = _FakeClock()
        kw = dict(engine_kw, clock=clock, retry_backoff_s=0.0,
                  calib_seed=3, algo="sfc6_6")
        if mod is jserve:
            eng = jserve.Engine(jnp.asarray(_weights()), table,
                                backend="reference", cache=JServingCache(),
                                **kw)
        else:
            eng = Engine(_weights(), table, backend=backend, device="cpu",
                         cache=ServingCache(), **kw)
        armed = {} if faults_armed is None else faults_armed(fmod)
        with fmod.inject(armed):
            steps, outs = _run_script(eng, clock, mod, xs, script)
        runs.append((eng, steps, outs))
    (mine, m_steps, m_outs), (theirs, t_steps, t_outs) = runs
    assert m_steps == t_steps
    assert mine.warm_sources == theirs.warm_sources
    assert _snapshot_view(mine) == _snapshot_view(theirs)
    for i in m_outs:
        (m_dec, m_y), (t_dec, t_y) = m_outs[i], t_outs[i]
        assert m_dec == t_dec, i
        if m_y is not None:
            np.testing.assert_allclose(
                m_y, t_y, rtol=DEFAULT_TOL,
                atol=DEFAULT_TOL * np.abs(t_y).max())
    return mine, m_outs


# ----------------------------------------------------------------------
# the same decisions as the JAX engine
# ----------------------------------------------------------------------
FCFS_SCRIPT = ([("submit", 0.001 * i, i, "b") for i in range(7)]
               + [("drain", 0.01)])
EDF_SCRIPT = ([("submit", 0.0, 0, "b"), ("submit", 0.0, 1, "i"),
               ("submit", 0.001, 2, "b"), ("submit", 0.002, 3, "i"),
               ("step", 0.003), ("submit", 0.004, 4, "i"),
               ("step", 0.005), ("step", 0.020), ("submit", 0.021, 5, "b"),
               ("submit", 0.022, 6, "i"), ("step", 3.0), ("drain", 3.1)])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_fcfs_batches_match_jax(backend):
    shapes = [(10, 10), (14, 14), (9, 7), (20, 20), (12, 14), (10, 10),
              (5, 5)]
    _, outs = _compare(FCFS_SCRIPT, _images(shapes), backend, max_batch=4)
    assert max(d[1] for d, _ in outs.values()) > 1


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_edf_aging_and_shedding_match_jax(backend):
    """EDF with batch aging and deadline shedding, the clock stepped past
    the interactive deadline (2 s): the same holds, sheds and batches."""
    shapes = [(10, 10), (10, 10), (14, 14), (10, 10), (9, 9), (20, 20),
              (14, 14)]
    eng, outs = _compare(EDF_SCRIPT, _images(shapes, seed=2), backend,
                         max_batch=4, shed_expired=True,
                         scheduler=SchedulerPolicy(kind="edf",
                                                   max_hold_ms=10.0))
    snap = eng.snapshot()
    assert snap["counters"]["shed"] >= 1
    assert snap["counters"]["aged_dispatches"] >= 1
    assert any(d == "ShedError" for d, _ in outs.values())


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_round_batches_match_jax(backend):
    shapes = [(10, 10)] * 3 + [(14, 14)] * 5
    script = [("submit", 0.0, i, "b") for i in range(8)] + [("drain", 0.1)]
    eng, _ = _compare(script, _images(shapes, seed=4), backend, max_batch=4,
                      round_batches=True)
    assert eng.snapshot()["counters"]["batch_pad_imgs"] == 1   # 3 -> 4


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_retry_and_quarantine_match_jax(backend):
    """A one-off dispatch fault is retried; a poison request is isolated
    by bisection and quarantined, its peers served: the same retries,
    bisections and quarantines as the JAX engine."""
    shapes = [(10, 10)] * 4 + [(14, 14)] * 3
    xs = _images(shapes, seed=5, poison={1})
    script = [("submit", 0.0, i, "b") for i in range(7)] + [("drain", 0.1)]
    eng, outs = _compare(
        script, xs, backend, max_batch=4, max_dispatch_retries=1,
        faults_armed=lambda f: {f.DISPATCH: f.FaultSpec(when=_is_poisoned)})
    assert outs[1][0] == "QuarantinedError"
    c = eng.snapshot()["counters"]
    assert c["quarantined"] == 1 and c["batch_bisections"] >= 1
    eng, _ = _compare(
        script, _images(shapes, seed=5), backend, max_batch=4,
        faults_armed=lambda f: {f.DISPATCH: f.FaultSpec(times=1)})
    c = eng.snapshot()["counters"]
    assert c["dispatch_retries"] == 1 and c["quarantined"] == 0


def test_admission_matches_jax():
    """Queue bound, no bucket, and a VALID image smaller than the kernel:
    rejected by both engines with the same reasons."""
    for padding, shapes, bound in (("SAME", [(10, 10), (30, 30), (10, 10),
                                             (14, 14)], 2),
                                   ("VALID", [(2, 2), (10, 10)], 8)):
        mine_t, theirs_t = _tables(padding=padding)
        reasons = []
        for mod, table in ((tserve, mine_t), (jserve, theirs_t)):
            adm = mod.AdmissionPolicy(max_queue_depth=bound)
            if mod is jserve:
                eng = jserve.Engine(jnp.asarray(_weights()), table,
                                    backend="reference", admission=adm)
            else:
                eng = Engine(_weights(), table, device="cpu", admission=adm)
            futs = [eng.submit(x) for x in _images(shapes)]
            got = []
            for f in futs:
                e = f.exception(timeout=0) if f.done() else None
                got.append(None if e is None else str(e))
            reasons.append(got)
        assert reasons[0] == reasons[1]
        assert any(r is not None for r in reasons[0])


# ----------------------------------------------------------------------
# within the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_batched_bit_identical_to_per_request(backend):
    shapes = [(11, 10), (10, 10), (14, 14), (7, 5), (20, 17), (19, 20)]
    xs = _images(shapes, seed=3)
    table, _ = _tables()
    cache = ServingCache()
    served = []
    for max_batch in (4, 1):
        eng = Engine(_weights(), table, backend=backend, algo="sfc6_6",
                     device="cpu", max_batch=max_batch, cache=cache)
        futs = [eng.submit(x) for x in xs]
        while eng.step() > 0:
            pass
        served.append(results(futs))
        occ = eng.snapshot()["batch_occupancy"]["max"]
        assert (occ > 1) == (max_batch > 1)
    for b, s in zip(*served):
        assert torch.equal(b.y, s.y)
    # and equal to the bucket plan's own apply on the padded image
    for x, r in zip(xs, served[0]):
        b = table.bucket_for(*x.shape[:2])
        p, prep = cache.get(b.spec, eng.w, backend=backend, algo="sfc6_6",
                            act_scale=eng._act_scales[b.name],
                            key=("serve", b.name, eng.device))
        y = p.apply(BucketTable.pad_to(torch.from_numpy(x), b)[None], prep)
        assert torch.equal(BucketTable.crop_output(y[0], *x.shape[:2], b),
                           r.y)


def test_request_path_never_reprepares():
    cache = ServingCache()
    table, _ = _tables()
    eng = Engine(_weights(), table, device="cpu", max_batch=4, cache=cache)
    warm = cache.stats()
    assert warm["prepares"] == len(table.buckets)
    futs = [eng.submit(x) for x in _images([(10, 10), (14, 14)] * 4)]
    while eng.step() > 0:
        pass
    results(futs)
    after = cache.stats()
    assert after["prepares"] == warm["prepares"]
    assert after["evictions"] == 0 and after["hits"] > warm["hits"]


def test_chain_fallback_counted_in_the_engine_registry():
    """A fused failure during a dispatch is served by staged bit for bit
    and counted in the engine's own registry; with the chain off the
    same fault quarantines the request."""
    table, _ = _tables()
    xs = _images([(10, 10)] * 2, seed=8)
    clean = Engine(_weights(), table, device="cpu", max_batch=2)
    futs = [clean.submit(x) for x in xs]
    clean.step()
    want = [r.y for r in results(futs)]
    eng = Engine(_weights(), table, device="cpu", max_batch=2,
                 retry_backoff_s=0.0)
    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}) as fp:
        futs = [eng.submit(x) for x in xs]
        eng.step()
    assert fp.injected(faults.APPLY_FUSED) == 1
    assert all(torch.equal(r.y, y) for r, y in zip(results(futs), want))
    c = eng.snapshot()["counters"]
    assert c["resilience_fallback_staged"] == 1
    assert c["resilience_apply_failure"] == 1
    with resilience.configured(enabled=False):
        eng = Engine(_weights(), table, device="cpu", max_batch=2,
                     retry_backoff_s=0.0, max_dispatch_retries=0)
        with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}):
            futs = [eng.submit(x) for x in xs[:1]]
            eng.step()
        with pytest.raises(QuarantinedError) as ei:
            futs[0].result(timeout=0)
        assert isinstance(ei.value.__cause__, faults.InjectedFault)


def test_threaded_start_submit_drain_stop():
    table, _ = _tables()
    eng = Engine(_weights(), table, device="cpu", max_batch=4,
                 scheduler=SchedulerPolicy(kind="edf", max_hold_ms=2.0))
    eng.start()
    xs = _images([(10, 10), (14, 14), (20, 20), (9, 13)] * 3, seed=9)
    futs = []

    def submitter():
        for i, x in enumerate(xs):
            futs.append(eng.submit(x, INTERACTIVE if i % 2 else BATCH))

    th = threading.Thread(target=submitter)
    th.start()
    th.join()
    assert eng.drain(timeout=60) is True
    eng.stop(raise_on_error=True)
    rs = results(futs)
    assert [tuple(r.y.shape) for r in rs] == \
        [(x.shape[0], x.shape[1], COUT) for x in xs]
    snap = eng.snapshot()
    assert snap["counters"]["completed"] == len(xs)
    assert snap["e2e_ms"]["count"] == len(xs)


def test_submit_takes_numpy_or_tensors_onto_the_engine_device():
    table, _ = _tables()
    eng = Engine(_weights(), table, device="cpu", max_batch=2)
    x = _images([(10, 10)])[0]
    f1, f2 = eng.submit(x), eng.submit(torch.from_numpy(x).double())
    eng.step()
    r1, r2 = results([f1, f2])
    assert r1.y.device.type == "cpu" and r1.y.dtype == torch.float32
    assert torch.equal(r1.y, r2.y)
    with pytest.raises(RejectedError, match="no bucket"):
        eng.submit(np.zeros((40, 40, CIN), np.float32)).result(timeout=0)


def test_shed_before_dispatch():
    clock = _FakeClock()
    table, _ = _tables()
    eng = Engine(_weights(), table, device="cpu", max_batch=4, clock=clock,
                 shed_expired=True)
    x = _images([(10, 10)])[0]
    f_late, f_ok = eng.submit(x, INTERACTIVE), eng.submit(x, BATCH)
    clock.t = 3.0
    assert eng.step() == 2
    with pytest.raises(ShedError):
        f_late.result(timeout=0)
    assert f_ok.result(timeout=0).y.shape == (10, 10, COUT)


# ----------------------------------------------------------------------
# the fold decision: the batcher's view of B4
# ----------------------------------------------------------------------
def _plan(spec_kw=None, config=None):
    kw = dict(kernel_size=3, in_channels=CIN, out_channels=COUT,
              spatial=(14, 14), quant=INT8_FREQ)
    kw.update(spec_kw or {})
    p = plan(ConvSpec(**kw), backend="cuda", algo="sfc6_6")
    return p if config is None else p.with_config(config)


@pytest.mark.parametrize("batch", [1, 3, 4, 8])
def test_fold_takes_the_whole_batch_in_one_launch(batch):
    p = _plan()
    nH = -(-14 // p.algorithm.M)
    assert fold_rows_per_step(p, batch) == (batch * nH, batch, nH)
    assert kernel_checks.fold_fits(p.algorithm, tuning.DEFAULT_FUSED, batch,
                                   14, 14, CIN, COUT)


def test_fold_does_not_apply_where_the_jax_one_does_not():
    assert fold_rows_per_step(_plan(config=tuning.DEFAULT_STAGED), 4) is None
    assert fold_rows_per_step(_plan({"quant": FP32}), 4) is None
    assert fold_rows_per_step(_plan({"depthwise": True,
                                     "out_channels": CIN}), 4) is None
    assert fold_rows_per_step(plan(_plan().spec, backend="cuda",
                                   algo="direct"), 4) is None


def test_fold_checks_run_once_per_shape(monkeypatch):
    """A dispatch after the first of its (spec, config, batch) looks the
    fold up: the static checks are not run on the request path."""
    calls = []
    real = kernel_checks.fold_fits

    def counting(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(kernel_checks, "fold_fits", counting)
    p = _plan({"spatial": (13, 13)})
    nH = -(-13 // p.algorithm.M)
    for _ in range(3):
        assert fold_rows_per_step(p, 5) == (5 * nH, 5, nH)
        assert fold_rows_per_step(_plan({"spatial": (13, 13)}), 6) \
            == (6 * nH, 6, nH)
    assert calls == [5, 6]


def test_fold_fits_refuses_a_launch_no_geometry_takes():
    """A config whose knobs name no B4 kernel folds nothing (KC004)."""
    algo = registry.get_algorithm("sfc6_6")
    bad = tuning.KernelConfig(datapath="fused", k_block=48)
    assert not kernel_checks.fold_fits(algo, bad, 2, 14, 14, CIN, COUT)
    assert fold_rows_per_step(_plan(config=bad), 2) is None


# ----------------------------------------------------------------------
# the copied modules give the JAX modules' values
# ----------------------------------------------------------------------
@pytest.mark.parametrize("process", ["poisson", "bursty"])
def test_traffic_matches_jax(process):
    mine = synthesize(40, process=process, rate_hz=50.0, seed=3,
                      mix=ShapeMix(shapes=((10, 10), (14, 14), (20, 20))))
    theirs = jserve.synthesize(
        40, process=process, rate_hz=50.0, seed=3,
        mix=jserve.ShapeMix(shapes=((10, 10), (14, 14), (20, 20))))
    assert [(e.t, e.shape, e.slo.name) for e in mine] == \
        [(e.t, e.shape, e.slo.name) for e in theirs]


def test_latency_histogram_matches_jax():
    values = np.random.RandomState(0).lognormal(0.0, 1.5, 500)
    mine, theirs = LatencyHistogram(), jserve.LatencyHistogram()
    for v in values:
        mine.record(v)
        theirs.record(v)
    assert mine.summary() == theirs.summary()


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_pad_and_crop_match_jax(padding):
    mine_t, theirs_t = _tables(padding=padding)
    for x in _images([(7, 9), (14, 14), (13, 20)], seed=6):
        b, jb = mine_t.bucket_for(*x.shape[:2]), \
            theirs_t.bucket_for(*x.shape[:2])
        assert b.name == jb.name and b.waste(*x.shape[:2]) == \
            jb.waste(*x.shape[:2])
        padded = BucketTable.pad_to(torch.from_numpy(x), b)
        assert np.array_equal(padded.numpy(), np.asarray(
            jserve.BucketTable.pad_to(jnp.asarray(x), jb)))
        assert tuple(BucketTable.crop_output(padded, *x.shape[:2], b).shape) \
            == tuple(jserve.BucketTable.crop_output(
                jnp.asarray(padded.numpy()), *x.shape[:2], jb).shape)


def test_warm_compile_runs_every_shape_off_the_books():
    """warm_compile dispatches every (bucket, batch shape) once before
    traffic: no metrics, and an armed dispatch fault is left for traffic,
    as in the JAX engine."""
    table, _ = _tables()
    with faults.inject({faults.DISPATCH: faults.FaultSpec(times=1)}) as fp:
        eng = Engine(_weights(), table, device="cpu", max_batch=4,
                     round_batches=True, warm_compile=True,
                     retry_backoff_s=0.0)
        assert eng._batch_sizes() == [1, 2, 4]
        assert fp.injected() == 0
        snap = eng.snapshot()
        assert snap["batch_occupancy"]["dispatches"] == 0
        assert snap["counters"]["completed"] == 0
        f = eng.submit(_images([(10, 10)])[0])
        eng.step()
    assert fp.injected() == 1
    assert f.result(timeout=0).y.shape == (10, 10, COUT)
    assert eng.snapshot()["counters"]["dispatch_retries"] == 1
