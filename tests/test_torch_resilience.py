"""The port's fault injection (``repro_torch.faults``) and degradation chain
(``repro_torch.api.resilience``), held to the JAX package's.

  * ``faults``: the same firing sequence for the same seed and schedule at
    every site, hit for hit, as ``repro.faults``;
  * the circuit breaker: the same state after the same calls;
  * the chain on the ``cuda`` backend (the kernels' plain versions on CPU
    tensors): the same fallback levels, breaker states and counters as the
    JAX chain on ``pallas`` under the same injected faults.  The JAX plan
    runs its fused level with ``double_buffer=True``, the one fused
    configuration that launches under JAX 0.9 (ROADMAP C1); served outputs
    agree within ``DEFAULT_TOL``.  Within the port a fused failure is
    served by staged bit for bit.

The policy, breakers and counters are process-wide: every test resets
them before and after.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as jfaults  # noqa: E402
from repro.api import planner as jplanner  # noqa: E402
from repro.api import resilience as jresilience  # noqa: E402
from repro.api import tuning as jtuning  # noqa: E402
from repro.api.spec import ConvSpec as JConvSpec  # noqa: E402
from repro.quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch import faults  # noqa: E402
from repro_torch.api import (ConvSpec, costmodel, plan,  # noqa: E402
                             resilience, tuning)
from repro_torch.quant import INT8_FREQ  # noqa: E402
from repro_torch.testing import DEFAULT_TOL  # noqa: E402

CIN, COUT, HW = 8, 16, 10
SITES = {faults.APPLY_FUSED: jfaults.APPLY_FUSED,
         faults.APPLY_STAGED: jfaults.APPLY_STAGED,
         faults.APPLY_REFERENCE: jfaults.APPLY_REFERENCE}


@pytest.fixture(autouse=True)
def _fresh_boards(tmp_path):
    resilience.reset()
    jresilience.reset()
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    costmodel.set_cache_path(str(tmp_path / "port_costmodel.json"))
    yield
    resilience.reset()
    jresilience.reset()
    tuning.set_cache_path(None)
    costmodel.set_cache_path(None)


def _operands(seed=0, calib_scale=1.0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(3, 3, CIN, COUT) * 0.2).astype(np.float32)
    x = rng.randn(2, HW, HW, CIN).astype(np.float32)
    xc = (x * calib_scale).astype(np.float32)
    return w, x, xc


@pytest.fixture(scope="module")
def port_plan():
    """The port's int8 sfc6_6 plan on the cuda backend, prepared, with an
    input and its healthy (fused) answer."""
    w, x, _ = _operands()
    spec = ConvSpec(kernel_size=3, in_channels=CIN, out_channels=COUT,
                    spatial=(HW, HW), quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    xt = torch.from_numpy(x)
    act = tuning.calibrate_act_scale(xt, p.algorithm, INT8_FREQ)
    prep = p.prepare_weights(torch.from_numpy(w), act_scale=act)
    assert prep.quantized and p.config is None
    with resilience.configured(enabled=False):
        baseline = p.apply(xt, prep)
    return p, prep, xt, baseline


@pytest.fixture(scope="module")
def jax_plan():
    """The JAX package's int8 sfc6_6 pallas plan on the same operands,
    its fused level double-buffered (C1)."""
    w, x, _ = _operands()
    spec = JConvSpec(kernel_size=3, in_channels=CIN, out_channels=COUT,
                     spatial=(HW, HW), quant=JINT8_FREQ)
    p = jplanner.plan(spec, backend="pallas", algo="sfc6_6").with_config(
        jtuning.KernelConfig(datapath="fused", double_buffer=True))
    xj = jnp.asarray(x)
    act = jtuning.calibrate_act_scale(xj, p.algorithm, JINT8_FREQ)
    prep = p.prepare_weights(jnp.asarray(w), act_scale=act)
    return p, prep, xj


# ----------------------------------------------------------------------
# faults: the same firing sequence as the JAX package's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("site", faults.SITES)
@pytest.mark.parametrize("seed,spec", [
    (0, dict(p=0.3)), (7, dict(p=0.5, after=3, times=5)),
    (11, dict(p=1.0, after=2, times=4))])
def test_firing_sequence_matches_jax(site, seed, spec):
    fired = []
    for mod in (faults, jfaults):
        seq = []
        with mod.inject({site: mod.FaultSpec(**spec)}, seed=seed) as fp:
            for _ in range(60):
                try:
                    mod.maybe_fault(site)
                    seq.append(0)
                except mod.InjectedFault:
                    seq.append(1)
            assert fp.hits(site) == 60
            assert fp.injected(site) == sum(seq)
        fired.append(seq)
    assert fired[0] == fired[1]
    assert faults.active() is None


def test_sites_and_spec_validation_match_jax():
    assert faults.SITES == jfaults.SITES
    with pytest.raises(ValueError, match="unknown fault site"):
        with faults.inject({"apply:bogus": faults.FaultSpec()}):
            pass
    with pytest.raises(ValueError, match="p must be"):
        faults.FaultSpec(p=1.5)
    with pytest.raises(ValueError, match="mode must be"):
        faults.FaultSpec(mode="explode")


def test_corrupt_mode_poisons_with_nan_and_nesting_restores():
    t = torch.ones(3)
    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec(
            mode="corrupt")}) as outer:
        with faults.inject({faults.APPLY_STAGED: faults.FaultSpec()}):
            # the inner plan shadows the outer one
            assert faults.maybe_corrupt(faults.APPLY_FUSED, t) is t
        got = faults.maybe_corrupt(faults.APPLY_FUSED, t)
        assert torch.isnan(got).all()
        # a raise-mode hook does not fire on a corrupt spec
        faults.maybe_fault(faults.APPLY_FUSED)
        assert outer.injected() == 1
    assert faults.maybe_corrupt(faults.APPLY_FUSED, t) is t


def test_when_predicate_selects_the_hits():
    with faults.inject({faults.DISPATCH: faults.FaultSpec(
            when=lambda d: d == "poison")}) as fp:
        faults.maybe_fault(faults.DISPATCH, detail="healthy")
        with pytest.raises(faults.InjectedFault):
            faults.maybe_fault(faults.DISPATCH, detail="poison")
    assert fp.hits(faults.DISPATCH) == 1


# ----------------------------------------------------------------------
# the circuit breaker: the same states as the JAX package's
# ----------------------------------------------------------------------
def test_breaker_state_machine():
    t = [0.0]
    br = resilience.CircuitBreaker(failure_threshold=3, cooldown_s=5.0,
                                   clock=lambda: t[0])
    assert br.state == resilience.CLOSED and br.allow()
    assert br.record_failure() is False
    assert br.record_failure() is False
    assert br.record_failure() is True
    assert br.state == resilience.OPEN and not br.allow()
    t[0] = 5.0
    assert br.allow() and br.state == resilience.HALF_OPEN
    assert not br.allow()
    assert br.record_failure() is True and br.state == resilience.OPEN
    t[0] = 10.0
    assert br.allow() and br.record_success() is True
    assert br.snapshot() == {"state": "closed", "failures": 0}
    with pytest.raises(ValueError, match="failure_threshold"):
        resilience.CircuitBreaker(failure_threshold=0)


@pytest.mark.parametrize("seed", range(4))
def test_breaker_transitions_match_jax(seed):
    rng = np.random.RandomState(seed)
    t = [0.0]
    mine = resilience.CircuitBreaker(2, 3.0, clock=lambda: t[0])
    theirs = jresilience.CircuitBreaker(2, 3.0, clock=lambda: t[0])
    for _ in range(80):
        op = rng.choice(["allow", "fail", "ok", "tick"])
        if op == "tick":
            t[0] += float(rng.choice([0.5, 1.0, 3.0]))
            continue
        name = {"allow": "allow", "fail": "record_failure",
                "ok": "record_success"}[op]
        assert getattr(mine, name)() == getattr(theirs, name)()
        assert mine.snapshot() == theirs.snapshot()


# ----------------------------------------------------------------------
# the chain against the JAX package's, under the same faults
# ----------------------------------------------------------------------
def _levels_state(board):
    return {k.rsplit("|", 1)[1]: v for k, v in board.items()}


@pytest.mark.parametrize("armed", [
    (), (faults.APPLY_FUSED,), (faults.APPLY_STAGED,),
    (faults.APPLY_FUSED, faults.APPLY_STAGED),
    (faults.APPLY_FUSED, faults.APPLY_STAGED, faults.APPLY_REFERENCE)])
def test_chain_matches_jax_under_the_same_faults(port_plan, jax_plan,
                                                 armed):
    """Repeated applies under the same armed sites: the same outcome per
    call (served, or the same error raised: the last level's, then
    ``BreakerOpenError`` once every breaker is open), the same counters,
    the same breaker state per level; what is served agrees within
    DEFAULT_TOL."""
    p, prep, xt, _ = port_plan
    jp, jprep, xj = jax_plan
    calls = resilience.policy().failure_threshold + 2
    outcomes = []
    for mod, res, fn in (
            (faults, resilience, lambda: p.apply(xt, prep).numpy()),
            (jfaults, jresilience, lambda: np.asarray(jp.apply(xj, jprep)))):
        res.reset()
        got = []
        with mod.inject({SITES[s] if mod is jfaults else s: mod.FaultSpec()
                         for s in armed}):
            for _ in range(calls):
                try:
                    got.append(fn())
                except (mod.InjectedFault, res.BreakerOpenError) as e:
                    got.append(type(e).__name__)
        outcomes.append((got, res.stats(),
                         _levels_state(res.board_snapshot())))
    (mine, mine_stats, mine_board), (theirs, their_stats, their_board) = \
        outcomes
    assert mine_stats == their_stats
    assert mine_board == their_board
    for a, b in zip(mine, theirs):
        if isinstance(a, str) or isinstance(b, str):
            assert a == b
        else:
            np.testing.assert_allclose(a, b, rtol=DEFAULT_TOL,
                                       atol=DEFAULT_TOL * np.abs(b).max())


# ----------------------------------------------------------------------
# the port's chain
# ----------------------------------------------------------------------
def test_fused_fault_falls_back_bit_identical(port_plan):
    p, prep, x, baseline = port_plan
    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}) as fp:
        y = p.apply(x, prep)
    assert fp.injected(faults.APPLY_FUSED) == 1
    assert torch.equal(y, baseline)
    assert resilience.stats() == {"resilience_apply_failure": 1,
                                  "resilience_fallback_staged": 1}


def test_double_fault_falls_back_to_reference(port_plan):
    p, prep, x, baseline = port_plan
    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec(),
                        faults.APPLY_STAGED: faults.FaultSpec()}):
        y = p.apply(x, prep)
    st = resilience.stats()
    assert st["resilience_fallback_reference"] == 1
    assert st["resilience_apply_failure"] == 2
    torch.testing.assert_close(y, baseline, rtol=DEFAULT_TOL,
                               atol=DEFAULT_TOL)


def test_staged_config_skips_the_fused_level(port_plan):
    p, prep, x, baseline = port_plan
    staged = p.with_config(tuning.DEFAULT_STAGED)
    with faults.inject({faults.APPLY_STAGED: faults.FaultSpec()}):
        y = staged.apply(x, prep)
    assert resilience.stats()["resilience_fallback_reference"] == 1
    assert [lvl for lvl, _ in resilience._levels(staged, prep, x)] == \
        ["staged", "reference"]
    torch.testing.assert_close(y, baseline, rtol=DEFAULT_TOL,
                               atol=DEFAULT_TOL)


@pytest.mark.parametrize("config,levels", [
    (None, ["fused", "staged"]),
    (tuning.DEFAULT_STAGED, ["staged"]),
])
def test_chain_off_the_cpu_ends_at_the_kernels(port_plan, config, levels):
    """A tensor that is not on the CPU never reaches the reference level:
    the chain ends at the hand-written kernels."""
    p, prep, x, _ = port_plan
    if config is not None:
        p = p.with_config(config)
    off_cpu = torch.empty(x.shape, device="meta")
    assert [lvl for lvl, _ in resilience._levels(p, prep, off_cpu)] \
        == levels
    assert [lvl for lvl, _ in resilience._levels(p, prep, x)] \
        == levels + ["reference"]


def test_chain_off_the_cpu_raises_the_staged_error(port_plan, monkeypatch):
    """When fused and staged both fail on a tensor off the CPU, the
    staged level's error reaches the caller; plain torch never runs."""
    from repro_torch.api import backends
    p, prep, x, _ = port_plan
    tried = []

    class Broken:
        def apply(self, lp, xx, pp, *, bias=None):
            level = (lp.config or tuning.DEFAULT_FUSED).datapath
            tried.append((lp.backend, level))
            raise RuntimeError(f"{level} failed")

    monkeypatch.setattr(backends, "get_backend", lambda name: Broken())
    with pytest.raises(RuntimeError, match="staged failed"):
        p.apply(torch.empty(x.shape, device="meta"), prep)
    assert tried == [("cuda", "fused"), ("cuda", "staged")]
    assert resilience.stats() == {"resilience_apply_failure": 2}


def test_breaker_pins_fallback_and_recovers(port_plan):
    p, prep, x, baseline = port_plan
    t = [0.0]
    with resilience.configured(cooldown_s=10.0, clock=lambda: t[0]):
        thr = resilience.policy().failure_threshold
        with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}) as fp:
            for _ in range(thr + 3):
                assert torch.equal(p.apply(x, prep), baseline)
            assert fp.hits(faults.APPLY_FUSED) == thr      # pinned out
        key = (p.spec, p.backend, "fused")
        assert resilience.breaker_for(key).state == resilience.OPEN
        assert resilience.stats()["resilience_breaker_skip"] == 3
        t[0] = 11.0                                         # half-open
        assert torch.equal(p.apply(x, prep), baseline)
        st = resilience.stats()
        assert st["resilience_breaker_probe"] == 1
        assert st["resilience_breaker_recovered"] == 1
        assert resilience.breaker_for(key).state == resilience.CLOSED


def test_disabled_policy_propagates_faults(port_plan):
    p, prep, x, _ = port_plan
    with resilience.configured(enabled=False):
        assert not resilience.engaged(p)
        with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}):
            with pytest.raises(faults.InjectedFault):
                p.apply(x, prep)
    assert resilience.stats() == {}


def test_only_the_cuda_backend_engages(port_plan):
    p = port_plan[0]
    assert resilience.engaged(p)
    assert not resilience.engaged(plan(p.spec, backend="reference",
                                       algo="sfc6_6"))


def test_guardrail_converts_nan_output_into_fallback(port_plan):
    p, prep, x, baseline = port_plan
    with resilience.configured(guardrail=resilience.Guardrail()):
        with faults.inject({faults.APPLY_FUSED: faults.FaultSpec(
                mode="corrupt")}) as fp:
            y = p.apply(x, prep)
        assert fp.injected(faults.APPLY_FUSED) == 1
        assert torch.equal(y, baseline)
        st = resilience.stats()
        assert st["resilience_guardrail_trip"] == 1
        assert st["resilience_fallback_staged"] == 1


def test_guardrail_saturation_probe_trips_on_miscalibrated_scales():
    w, x, xc = _operands(seed=1, calib_scale=0.01)
    spec = ConvSpec(kernel_size=3, in_channels=CIN, out_channels=COUT,
                    spatial=(HW, HW), quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    prep = p.prepare_weights(wt, act_scale=tuning.calibrate_act_scale(
        torch.from_numpy(xc), p.algorithm, INT8_FREQ))
    guard = resilience.Guardrail(max_sat_frac=0.05)
    with resilience.configured(guardrail=guard):
        with pytest.raises(resilience.GuardrailViolation,
                           match="saturation"):
            p.apply(xt, prep)
        assert resilience.stats()["resilience_guardrail_trip"] >= 2
    resilience.reset()
    prep2 = p.prepare_weights(wt, act_scale=tuning.calibrate_act_scale(
        xt, p.algorithm, INT8_FREQ))
    with resilience.configured(guardrail=guard):
        p.apply(xt, prep2)
    assert "resilience_guardrail_trip" not in resilience.stats()


def test_metrics_sink_routes_events_to_caller(port_plan):
    p, prep, x, _ = port_plan
    seen = {}

    def inc(name, by=1):
        seen[name] = seen.get(name, 0) + by

    with resilience.metrics_sink(inc):
        with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}):
            p.apply(x, prep)
    assert seen == {"resilience_apply_failure": 1,
                    "resilience_fallback_staged": 1}
    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}):
        p.apply(x, prep)
    assert seen["resilience_fallback_staged"] == 1
    assert resilience.stats()["resilience_fallback_staged"] == 2
    assert any(k.endswith("|cuda|fused")
               for k in resilience.board_snapshot())


def test_plan_and_prepare_sites_fire(port_plan):
    p, _, x, _ = port_plan
    w = torch.zeros(3, 3, CIN, COUT)
    with faults.inject({faults.PREPARE: faults.FaultSpec(),
                        faults.PLAN: faults.FaultSpec()}) as fp:
        with pytest.raises(faults.InjectedFault):
            p.prepare_weights(w)
        with pytest.raises(faults.InjectedFault):
            plan(p.spec, backend="cuda", algo="sfc6_6")
    assert fp.injected() == 2


def test_configured_restores_previous_policy():
    before = resilience.policy()
    with resilience.configured(failure_threshold=99) as pol:
        assert pol.failure_threshold == 99
        assert resilience.policy() is pol
    assert resilience.policy() == before
    assert dataclasses.asdict(before).keys() == \
        dataclasses.asdict(jresilience.policy()).keys()
