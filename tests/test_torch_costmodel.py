"""The port's calibrated cost model (``repro_torch.api.costmodel``).

Held to the JAX package's documented contract (``tests/test_costmodel.py``
adapted): monotone memory features, an unfitted model predicting nothing,
fit determinism and exact recovery of a linear pseudo-latency, persistence
keyed per backend and device, ``autotune(top_k=k)`` measuring exactly k
candidates (all of them unfitted), the planner's measured > model > BOPs
precedence, the model's config riding cold plans, and the engine's warm
provenance.  Against the JAX functions themselves: ``_fit_nonneg`` gives
the same coefficients on the same samples (to 1e-12 relative),
``features_for`` prices and refuses the same specs, and
``fit_coefficients`` / ``rank_candidates`` recover the same coefficients
and rank the datapaths alike when both packages measure the same fake
latency (a fixed linear function of each package's own features), with
``tuning._measure_plan`` replaced on both sides.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.api import costmodel as jcostmodel  # noqa: E402
from repro.api import tuning as jtuning  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch.analysis import kernel_checks  # noqa: E402
from repro_torch.api import (ConvSpec, KernelConfig, costmodel,  # noqa: E402
                             plan, registry, select_algorithm, tuning)
from repro_torch.kernels import sfc_fused  # noqa: E402
from repro_torch.quant import INT8_FREQ  # noqa: E402

# the fake latency both packages measure: base per datapath + 1e-5 s a
# step + 2 x the roofline seconds
TRUE = {"fused": (1e-3, 1e-5, 2.0), "staged": (3e-3, 1e-5, 2.0),
        "direct": (5e-3, 2.0)}


@pytest.fixture(autouse=True)
def _isolated_port_caches(tmp_path):
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    costmodel.set_cache_path(str(tmp_path / "port_costmodel.json"))
    yield
    tuning.set_cache_path(None)
    costmodel.set_cache_path(None)


@pytest.fixture
def jax_costmodel_cache(tmp_path):
    prev = jcostmodel.cache_path()
    jcostmodel.set_cache_path(str(tmp_path / "jax_costmodel.json"))
    yield
    jcostmodel.set_cache_path(prev)


def _spec(cin=64, cout=128, hw=14, **kw):
    return ConvSpec(kernel_size=3, in_channels=cin, out_channels=cout,
                    spatial=(hw, hw), quant=INT8_FREQ, **kw)


def _jspec(spec):
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec) if f.name != "quant"}
    return japi.ConvSpec(quant=JINT8_FREQ, **fields)


def _algo(spec):
    return registry.get_algorithm(select_algorithm(spec))


def _fake_latency(features_for):
    """A ``_measure_plan`` stand-in: TRUE's linear function of the
    candidate's own analytic features; nothing executes."""
    def fake(p, x, w, reps):
        feats = features_for(p.spec, p.algorithm, p.config,
                             batch=x.shape[0])
        return float(np.dot(TRUE[feats.datapath], feats.vector()))
    return fake


def _full_coefs(fused=TRUE["fused"], staged=TRUE["staged"],
                direct=TRUE["direct"]):
    return {"fused": list(fused), "staged": list(staged),
            "direct": list(direct)}


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------
def test_memory_feature_monotone_in_cin():
    algo = _algo(_spec())
    for cfg in (tuning.DEFAULT_FUSED, tuning.DEFAULT_STAGED):
        mem = [costmodel.features_for(_spec(cin=c), algo, cfg).memory_s
               for c in (32, 64, 128, 256, 512)]
        assert all(b >= a for a, b in zip(mem, mem[1:])), (cfg, mem)


@pytest.mark.parametrize("T,cin,cout", [(9, 256, 128), (100, 64, 64),
                                         (25, 512, 512)])
def test_memory_feature_invariant_in_k_blocking(T, cin, cout):
    """At one cluster shape, B4 reads each input channel and weight once
    whatever its stage width: 32- and 64-channel stages price the same
    bytes (the JAX package's "k-blocking never reduces traffic").  The
    auto geometry may pick another cluster per stage width; sharing a
    transform over more C_out blocks reads the input fewer times."""
    algo = registry.get_algorithm("sfc6_6")
    compared, x_by_share = 0, {}
    for cb in sfc_fused.COUT_BLOCKS:
        for ns in (1, 2, 4, 8, 16):
            got = []
            for kb in (32, 64):
                try:
                    got.append(sfc_fused.fused_geometry(
                        algo, T, cin, cout, k_block=kb, cout_block=cb,
                        n_share=ns, k_split=1))
                except ValueError:
                    continue
            # one cluster shape: the same tiles a block (where two stages
            # of 64 channels do not fit, B4 falls to 8 tiles a block, which
            # reads each weight once per 8 tiles)
            got = [g for g in got if g.tiles == sfc_fused.TILES]
            if len(got) == 2:
                assert got[0].hbm_bytes() == got[1].hbm_bytes(), (cb, ns)
                compared += 1
            if got and cb == 8:
                x_by_share[ns] = got[0].hbm_bytes()["x"]
    assert compared >= 1
    xs = [x_by_share[n] for n in sorted(x_by_share)]
    assert xs == sorted(xs, reverse=True)


def test_steps_are_launches_plus_waves():
    """The port's step: a launch, plus each wave of its blocks over the
    H100's SMs; the staged trio is three launches, B4 one."""
    spec = _spec(cin=256, cout=256, hw=56)
    algo = registry.get_algorithm("sfc6_6")
    fused = costmodel.features_for(spec, algo, tuning.DEFAULT_FUSED)
    staged = costmodel.features_for(spec, algo, tuning.DEFAULT_STAGED)
    geoms = kernel_checks.geometries_for(algo, tuning.DEFAULT_STAGED, 1, 56,
                                         56, 256, 256)
    assert len(geoms) == 3
    assert staged.steps == 3 + sum(g.waves for g in geoms)
    assert fused.steps >= 2 and staged.steps > fused.steps
    # batch 8 has more blocks, hence at least as many waves
    assert costmodel.features_for(spec, algo, tuning.DEFAULT_STAGED,
                                  batch=8).steps >= staged.steps
    # the staged round trip of the transform-domain tensor costs bytes
    assert staged.hbm_bytes > fused.hbm_bytes * 0.5
    assert staged.vector() == (1.0, float(staged.steps), staged.roof_s)


@pytest.mark.parametrize("case", [
    "strided", "grouped", "no_spatial", "tap_mismatch", "native",
    "depthwise", "direct"])
def test_features_price_and_refuse_the_jax_specs(case):
    """features_for prices (and refuses) the same specs as the JAX
    function, with the same datapath and vector width."""
    spec = {"strided": _spec(stride=2),
            "grouped": _spec(groups=2),
            "no_spatial": ConvSpec(kernel_size=3, in_channels=8,
                                   out_channels=8, quant=INT8_FREQ),
            "tap_mismatch": _spec(),
            "native": _spec(),
            "depthwise": ConvSpec(kernel_size=3, in_channels=32,
                                  out_channels=32, spatial=(14, 14),
                                  depthwise=True, quant=INT8_FREQ),
            "direct": _spec()}[case]
    name = {"tap_mismatch": "sfc4_5_r2", "direct": None}.get(case, "sfc6_6")
    algo = None if name is None else registry.get_algorithm(name)
    jalgo = None if name is None else japi.registry.get_algorithm(name)
    for cfg, jcfg in ((tuning.DEFAULT_FUSED, jtuning.DEFAULT_FUSED),
                      (tuning.DEFAULT_STAGED, jtuning.DEFAULT_STAGED)):
        got = costmodel.features_for(spec, algo, cfg)
        want = jcostmodel.features_for(_jspec(spec), jalgo, jcfg)
        assert (got is None) == (want is None), (case, got, want)
        if got is not None:
            assert got.datapath == want.datapath
            assert len(got.vector()) == len(want.vector()) \
                == costmodel.N_FEATURES[got.datapath]
            assert got.roof_s > 0


def test_unfitted_model_predicts_nothing():
    spec = _spec()
    assert not costmodel.is_fitted("cuda")
    assert costmodel.predict_time(spec, _algo(spec),
                                  tuning.DEFAULT_FUSED) is None
    assert costmodel.best_config(spec, "cuda", "sfc4_4") is None
    assert costmodel.rank_candidates(spec, _algo(spec)) is None
    assert costmodel.select_algorithm(
        spec, [registry.DIRECT, "sfc4_4"], "cuda") is None


# ---------------------------------------------------------------------------
# the fit, against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_fit_nonneg_matches_jax(seed):
    """The copied active-set least squares, on the same samples: the same
    coefficients, negative ones zeroed in the same order."""
    rng = np.random.RandomState(seed)
    n = 3 if seed % 2 else 2
    X = np.column_stack([np.ones(12), rng.rand(12, n - 1) * 10])
    y = X @ (rng.randn(n) * 1e-3) + rng.rand(12) * 1e-4
    got = costmodel._fit_nonneg(X, y)
    want = jcostmodel._fit_nonneg(X, y)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-18)
    assert all(c >= 0 for c in got)


def test_fit_determinism(monkeypatch):
    monkeypatch.setattr(tuning, "_measure_plan",
                        _fake_latency(costmodel.features_for))
    r1 = costmodel.fit_coefficients(device="cpu", persist=False)
    costmodel.clear()
    r2 = costmodel.fit_coefficients(device="cpu", persist=False)
    assert r1["coefficients"] == r2["coefficients"]
    assert set(r1["coefficients"]) == {"fused", "staged", "direct"}


def test_fit_recovers_the_jax_coefficients(monkeypatch,
                                           jax_costmodel_cache):
    """Both packages measure TRUE's latency on the port's default probes
    (each over its own features and candidates) and both fits recover
    TRUE: the port's and the JAX package's coefficients agree to 1e-6."""
    monkeypatch.setattr(tuning, "_measure_plan",
                        _fake_latency(costmodel.features_for))
    monkeypatch.setattr(jtuning, "_measure_plan",
                        _fake_latency(jcostmodel.features_for))
    probes = costmodel.default_probe_specs()
    got = costmodel.fit_coefficients(probes, device="cpu", persist=False)
    want = jcostmodel.fit_coefficients([_jspec(s) for s in probes],
                                       persist=False)
    assert set(got["coefficients"]) == set(want["coefficients"])
    for dp, c in got["coefficients"].items():
        np.testing.assert_allclose(c, want["coefficients"][dp], rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(c, TRUE[dp], rtol=1e-6, atol=1e-12)
        assert got["fit_error"][dp]["max_rel"] < 1e-6
    assert got["device"] == "cpu"


def test_fit_without_a_card_raises_instead_of_timing_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    timed = []
    monkeypatch.setattr(tuning, "_measure_plan",
                        lambda *a, **k: timed.append(a) or 1e-3)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        costmodel.fit_coefficients(persist=False)
    assert timed == [] and not costmodel.is_fitted("cuda")


def test_fit_recovers_linear_pseudo_latency(monkeypatch):
    fake = _fake_latency(costmodel.features_for)
    monkeypatch.setattr(tuning, "_measure_plan", fake)
    costmodel.fit_coefficients(device="cpu", persist=False)
    spec = _spec(cin=128, cout=128, hw=10)
    x, w = tuning._synthetic_operands(spec)
    p = plan(spec, backend="cuda", algo=select_algorithm(spec))
    for cfg in (tuning.DEFAULT_FUSED, tuning.DEFAULT_STAGED):
        pred = costmodel.predict_time(spec, p.algorithm, cfg)
        want = fake(p.with_config(cfg), x, w, 1)
        assert abs(pred - want) / want < 1e-6


def test_coefficients_persist_keyed_per_backend_and_device(monkeypatch):
    coefs = _full_coefs()
    costmodel.set_coefficients(coefs, "cuda", device="cpu")
    path = costmodel.cache_path()
    costmodel.set_cache_path(path)          # a fresh process: reload
    assert costmodel.coefficients("cuda", "cpu") == coefs
    assert costmodel.coefficients("reference", "cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    # a fit on the CPU's plain versions never prices the card
    assert costmodel.coefficients("cuda", "cuda") is None
    assert costmodel._key("cuda", "cuda") == "cuda|NVIDIA H100 80GB HBM3"
    with pytest.raises(ValueError, match="expected 3"):
        costmodel.set_coefficients({"fused": [1.0]})
    with pytest.raises(ValueError, match="unknown datapath"):
        costmodel.set_coefficients({"pipelined": [1.0, 2.0, 3.0]})


# ---------------------------------------------------------------------------
# ranking
# ---------------------------------------------------------------------------
def test_rank_candidates_orders_by_prediction():
    spec = _spec()
    algo = _algo(spec)
    costmodel.set_coefficients(_full_coefs())
    ranked = costmodel.rank_candidates(spec, algo)
    launchable, _ = kernel_checks.check_candidates(
        spec, algo, tuning.DEFAULT_CANDIDATES)
    assert [c for c, _ in ranked] != [] and len(ranked) == len(launchable)
    preds = [t for _, t in ranked]
    assert preds == sorted(preds)
    for cfg, t in ranked:
        assert abs(costmodel.predict_time(spec, algo, cfg) - t) < 1e-12


def test_step_priced_ranking_agrees_with_jax(jax_costmodel_cache):
    """Priced by steps alone, both packages rank a fused config first and
    the staged trio last: one launch against three (the port), one grid
    against three (the JAX package)."""
    spec = _spec()
    steps_only = _full_coefs(fused=(0.0, 1e-5, 0.0),
                             staged=(0.0, 1e-5, 0.0), direct=(5e-3, 0.0))
    costmodel.set_coefficients(steps_only)
    jcostmodel.set_coefficients(steps_only, "pallas", interpret=True,
                                persist=False)
    name = select_algorithm(spec)
    got = costmodel.rank_candidates(spec, registry.get_algorithm(name))
    want = jcostmodel.rank_candidates(_jspec(spec),
                                      japi.registry.get_algorithm(name))
    for ranked in (got, want):
        assert ranked[0][0].datapath == "fused"
        assert ranked[-1][0].datapath == "staged"
    assert costmodel.best_config(spec, "cuda", name).datapath == "fused"


# ---------------------------------------------------------------------------
# autotune top-k
# ---------------------------------------------------------------------------
def _count_measures(monkeypatch):
    counted = []
    fake = _fake_latency(costmodel.features_for)

    def counting(p, x, w, reps):
        counted.append(p.config)
        return fake(p, x, w, reps)

    monkeypatch.setattr(tuning, "_measure_plan", counting)
    return counted


def test_autotune_topk_measures_exactly_k(monkeypatch):
    spec = _spec()
    algo = registry.get_algorithm("sfc6_6")
    launchable, _ = kernel_checks.check_candidates(
        spec, algo, tuning.DEFAULT_CANDIDATES, batch=1)
    assert len(launchable) > 3          # the truncation is observable
    costmodel.set_coefficients(_full_coefs())
    counted = _count_measures(monkeypatch)
    name = "sfc6_6"
    results = tuning.autotune(spec, "cuda", device="cpu", algos=[name],
                              include_direct=False, top_k=2)
    assert len(counted) == 2
    # predicted-vs-measured self-validation rides the cache entry
    assert "predicted_s" in results[name]
    assert "predicted_s" in tuning.lookup(spec, "cuda")[name]


def test_autotune_unfitted_measures_every_launchable(monkeypatch):
    spec = _spec()
    algo = _algo(spec)
    launchable, _ = kernel_checks.check_candidates(
        spec, algo, tuning.DEFAULT_CANDIDATES, batch=1)
    assert not costmodel.is_fitted("cuda")
    counted = _count_measures(monkeypatch)
    tuning.autotune(spec, "cuda", device="cpu",
                    algos=[select_algorithm(spec)],
                    include_direct=False, top_k=3)
    assert len(counted) == len(launchable)


# ---------------------------------------------------------------------------
# planner precedence: measured > model > BOPs
# ---------------------------------------------------------------------------
def test_planner_precedence_measured_over_model_over_bops():
    spec = _spec()
    bops_best = select_algorithm(spec)          # no backend: pure BOPs
    assert bops_best != registry.DIRECT
    assert select_algorithm(spec, backend="cuda") == bops_best
    # a fitted model that prices direct as near-free overrides BOPs
    costmodel.set_coefficients(_full_coefs(
        fused=(10.0, 0.0, 0.0), staged=(10.0, 0.0, 0.0),
        direct=(1e-6, 0.0)))
    assert select_algorithm(spec, backend="cuda") == registry.DIRECT
    assert plan(spec, backend="cuda").path == "direct"
    # measured wall clock beats the model
    tuning.record(spec, "cuda", bops_best, 1e-4)
    tuning.record(spec, "cuda", registry.DIRECT, 5e-4)
    assert select_algorithm(spec, backend="cuda") == bops_best


def test_model_predicted_config_rides_cold_plan():
    spec = _spec()
    costmodel.set_coefficients(_full_coefs(
        fused=(0.0, 1e-5, 0.0), staged=(0.0, 1e-5, 0.0),
        direct=(5e-3, 0.0)))
    name = select_algorithm(spec)
    p = plan(spec, backend="cuda", algo=name)
    assert p.config is not None
    assert p.config == costmodel.best_config(spec, "cuda", name)
    assert p.config.datapath == "fused"
    # the measured config takes over once recorded
    cfg = KernelConfig(datapath="staged", k_block=None)
    tuning.record(spec, "cuda", name, 1e-4, cfg)
    assert plan(spec, backend="cuda", algo=name).config == cfg


def test_engine_warm_source_accounting():
    """Cold buckets under a fitted model warm as 'model', timed buckets
    as 'measured', the rest as 'default'; the snapshot carries it."""
    from repro_torch.serve import BucketTable, Engine
    w = np.random.RandomState(0).randn(3, 3, 8, 8).astype("float32") * 0.1
    table = BucketTable.for_workload([(10, 10), (14, 14)], kernel_size=3,
                                     in_channels=8, out_channels=8,
                                     quant=INT8_FREQ)
    b10, b14 = table.buckets
    assert Engine(w, table, device="cpu").warm_sources == {
        b10.name: "default", b14.name: "default"}
    tuning.record(b10.spec, "cuda", select_algorithm(b10.spec), 1e-4,
                  KernelConfig())
    costmodel.set_coefficients(_full_coefs())
    eng = Engine(w, table, device="cpu")
    assert eng.warm_sources == {b10.name: "measured", b14.name: "model"}
    snap = eng.snapshot()
    assert snap["warm_config_sources"] == eng.warm_sources
    assert snap["counters"]["warm_config_model"] == 1
    assert snap["counters"]["warm_config_measured"] == 1


def test_inverse_geometry_restates_the_launch_of_sfc_inverse_cu():
    """B3 computes its own grid in csrc/sfc_inverse.cu; the cost model
    and KC002 read it from ``InverseGeometry``.  The two must not drift."""
    import importlib
    import pathlib
    import re
    sfc_inverse = importlib.import_module("repro_torch.kernels.sfc_inverse")
    src = (pathlib.Path(sfc_inverse.__file__).parent.parent / "csrc"
           / "sfc_inverse.cu").read_text()
    const = dict(re.findall(r"constexpr int (kThreads|kSplits) = (\d+);",
                            src))
    assert int(const["kThreads"]) == sfc_inverse.INVERSE_THREADS
    assert int(const["kSplits"]) == sfc_inverse.INVERSE_SPLITS
    bounds = re.findall(r"__launch_bounds__\(kThreads, (\d+)\)", src)
    assert bounds and {int(b) for b in bounds} \
        == {sfc_inverse.INVERSE_RESIDENT}
    # the grid: ceil(n_tiles * min(kSplits, M) * O / kThreads) blocks
    assert "total = (long long)a.n_tiles * a.splits * a.O;" in src
    assert "blocks = (unsigned)((total + kThreads - 1) / kThreads);" in src
    assert "splits = M < kSplits ? M : kSplits;" in src
    for M, n_tiles, ch in ((6, 100, 256), (1, 7, 3), (4, 33, 65)):
        g = sfc_inverse.InverseGeometry(t=M + 2, M=M, n_tiles=n_tiles,
                                        channels=ch)
        splits = min(int(const["kSplits"]), M)
        assert g.blocks == -(-n_tiles * splits * ch
                             // int(const["kThreads"]))
