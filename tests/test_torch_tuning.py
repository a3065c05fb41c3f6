"""The port's measured tuning tier (``repro_torch.api.tuning``) and the
static launch checks (``repro_torch.analysis.kernel_checks``).

The tier is held to the JAX package's documented contract by calling its
functions directly: the cache's round trips, the adaptive timing protocol,
measured times overriding the planner (lower-or-direct in both directions,
the partial-sweep rule) with the same verdicts as the JAX planner given
the same measurements, measured configs riding plans, and ``autotune`` on
the ``cuda`` backend's plain versions (CPU tensors).
"""
import dataclasses
import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch.analysis import kernel_checks  # noqa: E402
from repro_torch.api import (ConvSpec, KernelConfig, plan,  # noqa: E402
                             registry, select_algorithm, tuning)
from repro_torch.kernels import sfc_fused  # noqa: E402
from repro_torch.kernels.sfc_transform import (  # noqa: E402
    transform_geometry)
from repro_torch.quant import INT8_FREQ  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated_port_tuning_cache(tmp_path):
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    yield
    tuning.set_cache_path(None)


def _spec(**kw):
    fields = dict(kernel_size=3, in_channels=16, out_channels=16,
                  spatial=(10, 10))
    fields.update(kw)
    return ConvSpec(quant=INT8_FREQ, **fields)


def _jspec(spec):
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec) if f.name != "quant"}
    return japi.ConvSpec(quant=JINT8_FREQ, **fields)


def _record_both(spec, algo, time_s, config=None):
    """The same measurement in the port's cache ("cuda", this device) and
    the JAX package's ("pallas", interpret mode)."""
    tuning.record(spec, "cuda", algo, time_s, config)
    japi.tuning.record(_jspec(spec), "pallas", algo, time_s)


# ----------------------------------------------------------------------
# the cache
# ----------------------------------------------------------------------
def test_record_lookup_and_get_config_round_trip(tmp_path):
    spec = _spec()
    cfg = KernelConfig(datapath="staged", k_block=None)
    tuning.record(spec, "cuda", "sfc4_4", 2e-3, cfg)
    tuning.record(spec, "cuda", "direct", 5e-3)
    assert tuning.get_config(spec, "cuda", "sfc4_4") == cfg
    assert tuning.get_config(spec, "cuda", "direct") is None
    assert tuning.get_config(spec, "cuda", "sfc6_6") is None
    assert tuning.lookup(spec, "cuda") == {
        "sfc4_4": {"time_s": 2e-3, "config": cfg.to_json()},
        "direct": {"time_s": 5e-3}}
    assert tuning.lookup(spec, "reference") == {}
    # persisted: a fresh load of the same file serves the same entries
    path = tuning.cache_path()
    tuning.set_cache_path(str(tmp_path / "elsewhere.json"))
    assert tuning.lookup(spec, "cuda") == {}
    tuning.set_cache_path(path)
    assert tuning.get_config(spec, "cuda", "sfc4_4") == cfg
    # the last measurement wins; clear drops the in-memory store
    tuning.record(spec, "cuda", "sfc4_4", 9e-3, tuning.DEFAULT_FUSED)
    assert tuning.get_config(spec, "cuda", "sfc4_4") == tuning.DEFAULT_FUSED
    tuning.clear()
    assert tuning.lookup(spec, "cuda") == {}


def test_old_cache_entries_survive_unknown_keys(tmp_path):
    """Configs written with other knobs (the JAX package's TPU geometry,
    keys of a later version) load with those dropped and the rest kept."""
    spec = _spec(groups=2, in_channels=8, out_channels=8)
    key = tuning.spec_key(spec, "cuda")
    path = tmp_path / "old.json"
    path.write_text(json.dumps({key: {"sfc6_6": {
        "time_s": 1e-3, "predicted_s": 2e-3,
        "config": {"datapath": "staged", "k_block": 64,
                   "rows_per_step": None, "double_buffer": True,
                   "tile_block": 8, "from_the_future": 1}}}}))
    tuning.set_cache_path(str(path))
    assert "g2" in key
    assert tuning.get_config(spec, "cuda", "sfc6_6") == KernelConfig(
        datapath="staged", k_block=64, cout_block=None)
    cfg = KernelConfig(datapath="fused", k_block=64, cout_block=8)
    assert KernelConfig.from_json(cfg.to_json()) == cfg
    assert KernelConfig.from_json({}) == tuning.DEFAULT_FUSED


def test_spec_key_names_the_device(monkeypatch):
    spec = _spec()
    assert tuning.spec_key(spec, "cuda", "cpu").endswith("|cuda|cpu")
    assert tuning.spec_key(ConvSpec(depthwise=True, quant=INT8_FREQ),
                           "cuda", "cpu").split("|")[0].endswith("dw")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    card = tuning.spec_key(spec, "cuda", "cuda")
    assert card.endswith("|cuda|NVIDIA H100 80GB HBM3")
    # an entry timed on the CPU's plain versions never governs the card
    tuning.record(spec, "cuda", "sfc6_6", 1e-3, tuning.DEFAULT_STAGED,
                  device="cpu")
    assert tuning.lookup(spec, "cuda", device="cpu")
    assert tuning.lookup(spec, "cuda", device="cuda") == {}
    assert tuning.get_config(spec, "cuda", "sfc6_6", device="cuda") is None


def test_cache_that_cannot_be_written_keeps_serving(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    tuning.set_cache_path(str(blocker / "tuning.json"))
    spec = _spec()
    with pytest.warns(RuntimeWarning, match="not persisted"):
        tuning.record(spec, "cuda", "sfc6_6", 1e-3, tuning.DEFAULT_STAGED)
    assert tuning.get_config(spec, "cuda", "sfc6_6") == tuning.DEFAULT_STAGED


# ----------------------------------------------------------------------
# the timing protocol
# ----------------------------------------------------------------------
def _counting_fn(calls):
    def fn():
        calls[0] += 1
        return torch.zeros(())
    return fn


def test_time_fn_fixed_protocol_when_floor_disabled():
    calls = [0]
    tuning.time_fn(_counting_fn(calls), reps=3, min_total_s=0.0)
    assert calls[0] == 1 + 3


def test_time_fn_adaptive_batches_cap_at_max_reps():
    calls = [0]
    tuning.time_fn(_counting_fn(calls), reps=3, min_total_s=1e9,
                   max_reps=17)
    assert calls[0] == 1 + 17          # batches 3+3+6+5, capped


def test_time_fn_doubles_until_the_floor(monkeypatch):
    """Each call takes 2 ms of a fake clock: the timed batches double
    (2, 2, 4) until 16 ms >= the 15 ms floor."""
    clock = [0.0]
    monkeypatch.setattr(tuning, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    calls = [0]
    counting = _counting_fn(calls)

    def two_ms():
        clock[0] += 0.002
        return counting()

    t = tuning.time_fn(two_ms, reps=2, min_total_s=0.015)
    assert calls[0] == 1 + 8
    assert t == pytest.approx(0.002)


def test_time_fn_stops_once_floor_crossed():
    calls = [0]
    counting = _counting_fn(calls)

    def slow():
        time.sleep(0.004)
        return counting()

    t = tuning.time_fn(slow, reps=3, min_total_s=0.01)
    assert calls[0] == 1 + 3
    assert t >= 0.003                  # mean per call, not total


# ----------------------------------------------------------------------
# the planner's measured tier, held to the JAX planner's verdicts
# ----------------------------------------------------------------------
def _path(spec, algo="auto"):
    port = plan(spec, backend="cuda", algo=algo)
    jax_plan = japi.plan(_jspec(spec), backend="pallas", algo=algo)
    assert (port.path, port.algo_name) == (jax_plan.path, jax_plan.algo_name)
    return port.path


def test_measured_times_override_lowering_both_ways():
    # BOPs lowers this one ...
    spec = _spec(stride=2, in_channels=64, out_channels=128,
                 spatial=(56, 56))
    assert _path(spec) == "lowered"
    _record_both(spec, "direct", 1e-3)
    _record_both(spec, "sfc6_6", 5e-3)
    assert _path(spec) == "direct"            # measured: direct wins
    _record_both(spec, "sfc6_6", 5e-4)
    assert _path(spec) == "lowered"           # re-tuned the other way
    # ... and keeps this one direct, with fast sub-convs
    small = _spec(stride=2, in_channels=8, out_channels=8, spatial=(12, 12))
    assert _path(small) == "direct"
    _record_both(small, "direct", 5e-3)
    _record_both(small, "sfc6_6", 1e-3)
    assert _path(small) == "lowered"


def test_one_sided_measurements_leave_bops_in_charge():
    spec = _spec(stride=2, in_channels=64, out_channels=128,
                 spatial=(56, 56))
    _record_both(spec, "direct", 1e-9)
    assert _path(spec) == "lowered"
    native = _spec(spatial=(56, 56), in_channels=64, out_channels=64)
    best = select_algorithm(native)
    other = next(e.name for e in registry.entries(taps=3)
                 if e.name != best and e.kind != "winograd")
    # a partial sweep that never timed the BOPs-best candidate
    _record_both(native, other, 1e-9)
    assert select_algorithm(native, "cuda") == best \
        == japi.planner.select_algorithm(_jspec(native), "pallas")
    _record_both(native, best, 1e-3)
    assert select_algorithm(native, "cuda") == other \
        == japi.planner.select_algorithm(_jspec(native), "pallas")
    assert _path(native) == "fast"


def test_measured_config_rides_native_and_lowered_plans():
    native = _spec()
    tuning.record(native, "cuda", "sfc6_6", 1e-3, tuning.DEFAULT_STAGED)
    assert plan(native, backend="cuda", algo="sfc6_6").config \
        == tuning.DEFAULT_STAGED
    assert plan(native, backend="reference", algo="sfc6_6").config is None
    spec = _spec(stride=2, in_channels=64, out_channels=128,
                 spatial=(56, 56))
    cfg = KernelConfig(datapath="fused", k_block=64, cout_block=8)
    tuning.record(spec, "cuda", "sfc6_6", 1e-3, cfg)
    for algo in ("auto", "sfc6_6"):
        p = plan(spec, backend="cuda", algo=algo)
        assert p.path == "lowered" and p.config == cfg
        assert all(sp.config == cfg for sp in p.sub_plans)


# ----------------------------------------------------------------------
# autotune on the plain versions
# ----------------------------------------------------------------------
def test_autotune_records_a_winner_that_plan_carries():
    spec = _spec(spatial=(9, 11), in_channels=4, out_channels=8)
    lines = []
    got = tuning.autotune(spec, "cuda", device="cpu",
                          algos=["sfc6_6", "sfc4_4"], reps=1,
                          log=lines.append)
    assert set(got) == {"direct", "sfc6_6", "sfc4_4"}
    for name in ("sfc6_6", "sfc4_4"):
        cfg = KernelConfig.from_json(got[name]["config"])
        assert cfg in tuning.DEFAULT_CANDIDATES
        assert tuning.lookup(spec, "cuda")[name] == got[name]
        assert plan(spec, backend="cuda", algo=name).config == cfg
    assert sum("autotune sfc6_6 " in line for line in lines) \
        == len(tuning.DEFAULT_CANDIDATES)
    # auto ranks by the measurements now
    fastest = min(got, key=lambda n: got[n]["time_s"])
    assert select_algorithm(spec, "cuda") == fastest


def test_autotune_times_each_composite_once():
    spec = _spec(stride=2, in_channels=8, out_channels=8, spatial=(12, 12))
    lines = []
    got = tuning.autotune(spec, "cuda", device="cpu", reps=1,
                          log=lines.append)
    names = [e.name for e in registry.entries(taps=3)]
    timed = [n for n in names if n in got]
    assert len(timed) == 1 and "direct" in got
    assert sum("same lowered composite" in line for line in lines) \
        == len(names) - 1
    # the composite carries the measured config, and the measurement
    # decides lower-or-direct
    p = plan(spec, backend="cuda", algo=timed[0])
    assert p.path == "lowered"
    assert p.config == KernelConfig.from_json(got[timed[0]]["config"])
    lowered = got[timed[0]]["time_s"] < got["direct"]["time_s"]
    assert (plan(spec, backend="cuda").path == "lowered") == lowered


def test_autotune_without_a_card_raises_instead_of_timing_the_cpu(
        monkeypatch):
    # with no device given autotune measures on the card; on a host
    # without one it raises before timing anything, and a CPU timing
    # needs device="cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    timed = []
    monkeypatch.setattr(tuning, "_measure_plan",
                        lambda *a, **k: timed.append(a) or 1e-3)
    spec = _spec(spatial=(9, 11), in_channels=4, out_channels=8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tuning.autotune(spec, "cuda", algos=["sfc6_6"], reps=1)
    assert timed == [] and tuning.lookup(spec, "cuda") == {}
    assert set(tuning.autotune(spec, "cuda", device="cpu", algos=["sfc6_6"],
                               reps=1)) == {"direct", "sfc6_6"}


def test_autotune_skips_what_the_overflow_preflight_rejects():
    spec = _spec(in_channels=140000, out_channels=1, spatial=(3, 3))
    lines = []
    assert tuning.autotune(spec, "cuda", device="cpu", algos=["sfc6_6"],
                           include_direct=False, log=lines.append) == {}
    assert "skipped" in lines[0]


# ----------------------------------------------------------------------
# static launch checks
# ----------------------------------------------------------------------
VGG16 = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
         (56, 128, 256), (56, 256, 256), (28, 256, 512), (28, 512, 512),
         (14, 512, 512)]
RESNET18 = [(224, 3, 64, 7, 2), (56, 64, 64, 3, 1), (56, 64, 128, 3, 2),
            (28, 128, 128, 3, 1), (28, 128, 256, 3, 2),
            (14, 256, 256, 3, 1), (14, 256, 512, 3, 2), (7, 512, 512, 3, 1)]
MOBILENET_DW = [(112, 32, 1), (112, 96, 2), (56, 144, 2), (28, 192, 2),
                (14, 576, 2), (7, 960, 1)]


def _fast_plans(spec, algo):
    p = plan(spec, backend="cuda", algo=algo)
    stack, out = [p], []
    while stack:
        q = stack.pop()
        if q.path == "lowered":
            stack.extend(q.sub_plans)
        elif q.path == "fast":
            out.append(q)
    return out


# what B4's shared memory cannot hold at t = 12 (the stem's 4-tap
# sub-convs, sfc6_6_r4): 16 output channels a block, or 64-channel stages
T12_REJECTED = [KernelConfig(datapath="fused", k_block=64),
                KernelConfig(datapath="fused", k_block=32, cout_block=16)]


@pytest.mark.parametrize("batch", [1, 4])
def test_default_candidates_launch_on_vgg_resnet_and_mobilenet(batch):
    """Every default candidate launches at every fast (sub-)conv of
    VGG-16, ResNet-18 and MobileNetV2's depthwise convs, but for two B4
    geometries at the stem's t = 12 sub-convs, which the pre-flight
    rejects (KC004) and ``autotune`` then never times."""
    specs = [(_spec(in_channels=ci, out_channels=co, spatial=(hw, hw)),
              "sfc6_6") for hw, ci, co in VGG16]
    specs += [(_spec(kernel_size=r, stride=s, in_channels=ci,
                     out_channels=co, spatial=(hw, hw)), "sfc6_6")
              for hw, ci, co, r, s in RESNET18]
    specs += [(_spec(depthwise=True, stride=s, in_channels=c,
                     out_channels=c, spatial=(hw, hw)),
               "sfc6_6" if s == 1 else "sfc4_4_r2")
              for hw, c, s in MOBILENET_DW]
    checked = 0
    for spec, algo in specs:
        for p in _fast_plans(spec, algo):
            ok, rejected = kernel_checks.check_candidates(
                p.spec, p.algorithm, tuning.DEFAULT_CANDIDATES, batch=batch)
            want = T12_REJECTED if p.algorithm.t == 12 else []
            assert [cfg for cfg, _ in rejected] == want, p.spec
            assert all(f.code == "KC004" for _, fs in rejected for f in fs)
            assert ok == [c for c in tuning.DEFAULT_CANDIDATES
                          if c not in want]
            checked += 1
    assert checked >= len(specs)
    stem = plan(_spec(kernel_size=7, stride=2, in_channels=3,
                      out_channels=64, spatial=(224, 224)),
                backend="cuda", algo="sfc6_6")
    ok, rejected = tuning._launchable(stem, tuning.DEFAULT_CANDIDATES, batch)
    assert ok == [c for c in tuning.DEFAULT_CANDIDATES
                  if c not in T12_REJECTED]
    assert {cfg for cfg, _ in rejected} == set(T12_REJECTED)


def test_a_config_no_geometry_runs_is_rejected():
    spec = _spec(in_channels=64, out_channels=64, spatial=(28, 28))
    algo = registry.get_algorithm("sfc6_6")
    bad = [KernelConfig(datapath="fused", k_block=48),
           KernelConfig(datapath="fused", cout_block=24),
           KernelConfig(datapath="staged", k_block=0)]
    ok, rejected = kernel_checks.check_candidates(
        spec, algo, list(tuning.DEFAULT_CANDIDATES) + bad)
    assert ok == list(tuning.DEFAULT_CANDIDATES)
    assert [cfg for cfg, _ in rejected] == bad
    for _, findings in rejected:
        assert [f.code for f in findings] == ["KC004"]
        assert isinstance(findings[0], kernel_checks.Finding)
        assert str(findings[0]).startswith("ERROR KC004")
    assert kernel_checks.check_spec_config(
        ConvSpec(quant=INT8_FREQ), algo, tuning.DEFAULT_FUSED) is None


def test_geometry_checks_name_each_limit():
    algo = registry.get_algorithm("sfc6_6")
    g = sfc_fused.fused_geometry(algo, 100, 256, 256)
    assert kernel_checks.check_geometry(g) == []
    codes = {name: [f.code for f in kernel_checks.check_geometry(
        dataclasses.replace(g, **knobs))] for name, knobs in {
        "smem": {"kb": 1024},
        "cluster": {"n_share": 16, "k_split": 2},
        "pairs": {"pairs": 7},
        "grid": {"n_tiles": 16 * 70000}}.items()}
    assert "KC001" in codes["smem"]
    assert "KC003" in codes["cluster"] and "KC003" in codes["pairs"]
    assert codes["grid"] == ["KC002"]
    t = transform_geometry(algo, (10, 10), 64)
    assert kernel_checks.check_geometry(t) == []
    assert {f.code for f in kernel_checks.check_geometry(
        dataclasses.replace(t, tiles=40, cb=64))} == {"KC001", "KC002"}
    d = sfc_fused.depthwise_geometry(algo, (10, 10), 64)
    assert kernel_checks.check_geometry(d) == []
    assert [f.code for f in kernel_checks.check_geometry(
        dataclasses.replace(d, splits=10, tiles=4, cb=32))] == ["KC002"]
    with pytest.raises(TypeError):
        kernel_checks.check_geometry(object())
