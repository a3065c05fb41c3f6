"""The port's ``repro_torch.api`` against the JAX package's ``repro.api``.

The ``cuda`` backend runs on CPU tensors here, where its kernel wrappers
compute with their plain versions: this drives the backend's dispatch and
the planner, and holds both int8 datapaths to the JAX reference backend's
static-int8 simulation with the same prepared weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.quant.fake_quant import FP32 as JFP32  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.analysis.ranges import AccumulatorOverflowError  # noqa: E402
from repro_torch.api import (ConvSpec, KernelConfig, plan,  # noqa: E402
                             select_algorithm, tuning)
from repro_torch.interop import prepared_from_jax  # noqa: E402
from repro_torch.quant import FP32, INT8_FREQ  # noqa: E402
from repro_torch.testing import assert_conv_conformance  # noqa: E402

CONFIGS = {"fused": tuning.DEFAULT_FUSED, "staged": tuning.DEFAULT_STAGED,
           "staged_kblock": KernelConfig(datapath="staged", k_block=2),
           "fused_full_k": KernelConfig(datapath="fused", k_block=None,
                                        cout_block=8)}


def _snapped(rng, shape):
    return (np.round(rng.randn(*shape) * 16) / 16).astype(np.float32)


def _jax_int8(x, w, name, padding):
    """(JAX reference-backend output, JAX prepared weights)."""
    spec = japi.ConvSpec.for_conv2d(x.shape, w.shape, padding=padding,
                                    quant=JINT8_FREQ)
    p = japi.plan(spec, backend="reference", algo=name)
    act = japi.tuning.calibrate_act_scale(jnp.asarray(x), p.algorithm,
                                          JINT8_FREQ, padding)
    prep = p.prepare_weights(jnp.asarray(w), act_scale=act)
    return np.asarray(p.apply(jnp.asarray(x), prep)), prep


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("name", ["sfc4_4", "sfc6_6", "sfc6_7"])
def test_cuda_backend_matches_jax_reference(name, padding, config):
    rng = np.random.RandomState(0)
    x = _snapped(rng, (2, 13, 11, 5))
    w = (rng.randn(3, 3, 5, 7) * 0.3).astype(np.float32)
    want, jprep = _jax_int8(x, w, name, padding)
    spec = ConvSpec.for_conv2d(x.shape, w.shape, padding=padding,
                               quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo=name)
    assert p.path == "fast" and p.algo_name == name and p.config is None
    got = p.with_config(CONFIGS[config]).apply(
        torch.from_numpy(x), prepared_from_jax(jprep, device="cpu"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_reference_backend_int8_simulation_matches_jax(padding):
    rng = np.random.RandomState(1)
    x = _snapped(rng, (1, 12, 9, 6))
    w = (rng.randn(3, 3, 6, 4) * 0.3).astype(np.float32)
    want, jprep = _jax_int8(x, w, "sfc6_6", padding)
    spec = ConvSpec.for_conv2d(x.shape, w.shape, padding=padding,
                               quant=INT8_FREQ)
    got = plan(spec, backend="reference", algo="sfc6_6").apply(
        torch.from_numpy(x), prepared_from_jax(jprep, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_port_prepared_weights_and_bias_match_jax():
    rng = np.random.RandomState(2)
    x = _snapped(rng, (1, 14, 14, 8))
    w = (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32)
    b = (rng.randn(16) * 0.1).astype(np.float32)
    spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    xt = torch.from_numpy(x)
    act = tuning.calibrate_act_scale(xt, p.algorithm, spec.quant)
    prep = p.prepare_weights(torch.from_numpy(w), act_scale=act)
    assert p.prepare_weights(prep.w, act_scale=act) is not None
    got = p.apply(xt, prep, bias=torch.from_numpy(b))
    jspec = japi.ConvSpec.for_conv2d(x.shape, w.shape, quant=JINT8_FREQ)
    jp = japi.plan(jspec, backend="reference", algo="sfc6_6")
    jprep = jp.prepare_weights(jnp.asarray(w),
                               act_scale=jnp.asarray(act.numpy()))
    want = np.asarray(jp.apply(jnp.asarray(x), jprep, bias=jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_prepared_weights_are_cached_per_tensor():
    rng = np.random.RandomState(3)
    w = torch.from_numpy((rng.randn(3, 3, 4, 4)).astype(np.float32))
    act = torch.full((10, 10), 0.1)
    p = plan(ConvSpec.for_conv2d((1, 8, 8, 4), w.shape, quant=INT8_FREQ),
             backend="cuda", algo="sfc6_6")
    assert p.prepare_weights(w, act_scale=act) is \
        p.prepare_weights(w, act_scale=act)


def test_pointwise_spec_goes_direct():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 7, 6).astype(np.float32)
    w = rng.randn(1, 1, 6, 5).astype(np.float32)
    spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    assert p.path == "direct" and p.algo_name == "direct"
    got = p.apply(torch.from_numpy(x), torch.from_numpy(w))
    jspec = japi.ConvSpec.for_conv2d(x.shape, w.shape, quant=JINT8_FREQ)
    want = japi.plan(jspec, backend="reference", algo="sfc6_6").apply(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_strided_spec_goes_direct_in_this_slice():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 9, 9, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 4).astype(np.float32)
    spec = ConvSpec.for_conv2d(x.shape, w.shape, stride=2, quant=FP32)
    p = plan(spec, backend="cuda")
    assert p.path == "direct"
    got = p.apply(torch.from_numpy(x), torch.from_numpy(w))
    jspec = japi.ConvSpec.for_conv2d(x.shape, w.shape, stride=2, quant=JFP32)
    want = japi.plan(jspec, backend="reference", algo="direct").apply(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fp_fast_path_on_cuda_raises():
    spec = ConvSpec.for_conv2d((1, 8, 8, 4), (3, 3, 4, 4), quant=FP32)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    assert p.path == "fast"
    with pytest.raises(NotImplementedError, match="B5"):
        p.apply(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 4))


def test_depthwise_on_cuda_raises():
    spec = ConvSpec.for_conv2d_depthwise((1, 8, 8, 4), (3, 3, 1, 4),
                                         quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    w = torch.ones(3, 3, 1, 4)
    prep = p.prepare_weights(w, act_scale=torch.ones(10, 10))
    with pytest.raises(NotImplementedError, match="B6/B7"):
        p.apply(torch.zeros(1, 8, 8, 4), prep)


def test_hooks_rejected_on_cuda():
    spec = ConvSpec.for_conv2d((1, 8, 8, 4), (3, 3, 4, 4), quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    with pytest.raises(ValueError, match="elementwise_hook"):
        p.apply(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 4),
                elementwise_hook=lambda tx, tw: (tx, tw))


def test_overflow_preflight_only_on_integer_datapath():
    spec = ConvSpec.for_conv2d((1, 8, 8, 133145), (3, 3, 133145, 4),
                               quant=INT8_FREQ)
    with pytest.raises(AccumulatorOverflowError, match="133144"):
        plan(spec, backend="cuda", algo="sfc6_6")
    assert plan(spec, backend="reference", algo="sfc6_6").path == "fast"


def test_unknown_names_raise():
    spec = ConvSpec.for_conv2d((1, 8, 8, 4), (3, 3, 4, 4))
    with pytest.raises(KeyError, match="sfc9_9"):
        plan(spec, backend="cuda", algo="sfc9_9")
    with pytest.raises(KeyError, match="tpu"):
        plan(spec, backend="tpu")


@pytest.mark.parametrize("hw,cin,cout", [(224, 3, 64), (56, 256, 256),
                                         (14, 512, 512), (7, 16, 16)])
def test_auto_selection_matches_jax(hw, cin, cout):
    for quant, jquant in ((INT8_FREQ, JINT8_FREQ), (FP32, JFP32)):
        spec = ConvSpec.for_conv2d((1, hw, hw, cin), (3, 3, cin, cout),
                                   quant=quant)
        jspec = japi.ConvSpec.for_conv2d((1, hw, hw, cin), (3, 3, cin, cout),
                                         quant=jquant)
        assert select_algorithm(spec) == japi.select_algorithm(jspec)
        assert plan(spec, backend="cuda").algo_name == \
            japi.plan(jspec, backend="reference").algo_name


def test_cpu_plans_launch_no_kernel():
    kernels.reset_launch_counts()
    rng = np.random.RandomState(6)
    x = torch.from_numpy(_snapped(rng, (1, 10, 10, 4)))
    w = torch.from_numpy(rng.randn(3, 3, 4, 8).astype(np.float32))
    spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    prep = p.prepare_weights(w, act_scale=tuning.calibrate_act_scale(
        x, p.algorithm, INT8_FREQ))
    for cfg in CONFIGS.values():
        p.with_config(cfg).apply(x, prep)
    assert set(kernels.launch_counts().values()) == {0}


def test_kernel_config_validates_datapath():
    with pytest.raises(ValueError, match="datapath"):
        KernelConfig(datapath="pipelined")


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("name", ["sfc4_4", "sfc6_6", "sfc6_7"])
def test_conformance_oracle_on_cpu(name, padding):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_snapped(rng, (2, 13, 11, 37)))
    w = torch.from_numpy((rng.randn(3, 3, 37, 9) * 0.1).astype(np.float32))
    spec = ConvSpec.for_conv2d(x.shape, w.shape, padding=padding,
                               quant=INT8_FREQ)
    y = assert_conv_conformance(x, w, spec, name)
    assert y.shape[-1] == 9 and torch.isfinite(y).all()


def test_conformance_oracle_rejects_unexpected_direct():
    spec = ConvSpec.for_conv2d((1, 6, 6, 4), (1, 1, 4, 4), quant=INT8_FREQ)
    x, w = torch.ones(1, 6, 6, 4), torch.ones(1, 1, 4, 4)
    with pytest.raises(AssertionError, match="degraded"):
        assert_conv_conformance(x, w, spec, "sfc6_6")
    assert_conv_conformance(x, w, spec, "sfc6_6", allow_degraded=True)


def test_register_backend_round_trip():
    from repro_torch.api import backends, get_backend, list_backends
    with pytest.raises(ValueError, match="already registered"):
        backends.register_backend("cuda", object())
    backends.register_backend("reference_alias", get_backend("reference"))
    try:
        assert "reference_alias" in list_backends()
        spec = ConvSpec.for_conv2d((1, 6, 6, 4), (3, 3, 4, 4))
        assert plan(spec, backend="reference_alias").backend == \
            "reference_alias"
    finally:
        del backends._BACKENDS["reference_alias"]
