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
from repro.api.lowering import (  # noqa: E402
    CompositePrepared as JCompositePrepared)
from repro.quant.fake_quant import FP32 as JFP32  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.analysis.ranges import AccumulatorOverflowError  # noqa: E402
from repro_torch.api import (CompositePrepared, ConvSpec,  # noqa: E402
                             KernelConfig, plan, select_algorithm, tuning)
from repro_torch.interop import prepared_from_jax  # noqa: E402
from repro_torch.quant import FP32, INT8_FREQ  # noqa: E402
from repro_torch.testing import assert_conv_conformance  # noqa: E402

CONFIGS = {"fused": tuning.DEFAULT_FUSED, "staged": tuning.DEFAULT_STAGED,
           "staged_kblock": KernelConfig(datapath="staged", k_block=2),
           "fused_full_k": KernelConfig(datapath="fused", k_block=None,
                                        cout_block=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated_port_tuning_cache(tmp_path):
    """Plans carry configs from the port's timing cache: keep it empty."""
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    yield
    tuning.set_cache_path(None)


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


# (label, x shape, w shape, stride, groups, depthwise)
PLANNER_SPECS = [
    ("dense_s2_3to4", (1, 9, 9, 3), (3, 3, 3, 4), 2, 1, False),
    ("dense_s2_16", (1, 16, 16, 16), (3, 3, 16, 16), 2, 1, False),
    ("dense_s2_5x5", (1, 16, 16, 8), (5, 5, 8, 8), 2, 1, False),
    ("grouped_g2", (1, 12, 12, 8), (3, 3, 4, 8), 1, 2, False),
    ("grouped_g2_s2", (1, 12, 12, 8), (3, 3, 4, 8), 2, 2, False),
    ("pointwise", (1, 9, 7, 6), (1, 1, 6, 5), 1, 1, False),
    ("pointwise_s2", (1, 9, 7, 6), (1, 1, 6, 5), 2, 1, False),
    ("pointwise_g2", (1, 9, 7, 6), (1, 1, 3, 4), 1, 2, False),
    ("depthwise", (1, 14, 14, 8), (3, 3, 1, 8), 1, 1, True),
    ("depthwise_s2", (1, 14, 14, 8), (3, 3, 1, 8), 2, 1, True),
    ("dense", (1, 14, 14, 8), (3, 3, 8, 8), 1, 1, False),
]


def _spec_pair(x_shape, w_shape, stride, groups, depthwise):
    if depthwise:
        return (ConvSpec.for_conv2d_depthwise(x_shape, w_shape, stride=stride,
                                              quant=INT8_FREQ),
                japi.ConvSpec.for_conv2d_depthwise(
                    x_shape, w_shape, stride=stride, quant=JINT8_FREQ))
    return (ConvSpec.for_conv2d(x_shape, w_shape, stride=stride,
                                groups=groups, quant=INT8_FREQ),
            japi.ConvSpec.for_conv2d(x_shape, w_shape, stride=stride,
                                     groups=groups, quant=JINT8_FREQ))


def _sub_plans(p):
    """(sub-spec fields, resolved algorithm) of each sub-plan, in order."""
    out = []
    for sp in getattr(p, "sub_plans", ()):
        fields = dict(vars(sp.spec))
        fields.pop("quant")
        out.append((fields, sp.algo_name, _sub_plans(sp)))
    return out


def _jax_prepared(jp, x, w):
    """A JAX plan's prepared weights, int8-calibrated on ``x`` wherever it
    has a transform domain (per sub-conv when lowered)."""
    if jp.path == "lowered":
        return jp.prepare_weights(w, act_scale=jp.calibrate(x))
    if jp.path == "fast":
        act = japi.tuning.calibrate_act_scale(x, jp.algorithm, JINT8_FREQ,
                                              jp.spec.padding)
        return jp.prepare_weights(w, act_scale=act)
    return jp.prepare_weights(w)


def _port_prepared(jprep):
    if isinstance(jprep, JCompositePrepared):
        return CompositePrepared(w=torch.from_numpy(np.array(jprep.w)),
                                 subs=tuple(map(_port_prepared, jprep.subs)))
    return prepared_from_jax(jprep, device="cpu")


@pytest.mark.parametrize("algo", ["sfc6_6", "auto", "direct"])
@pytest.mark.parametrize("case", PLANNER_SPECS, ids=[c[0] for c in PLANNER_SPECS])
def test_plans_take_the_jax_path_and_give_its_output(case, algo):
    # the port resolves the path, algo_name and sub-plans the JAX package
    # resolves, lowering strided and grouped specs where it lowers them,
    # and gives its output on the same prepared weights
    label, x_shape, w_shape, stride, groups, depthwise = case
    spec, jspec = _spec_pair(x_shape, w_shape, stride, groups, depthwise)
    jp = japi.plan(jspec, backend="pallas", algo=algo)
    p = plan(spec, backend="cuda", algo=algo)
    assert (p.path, p.algo_name) == (jp.path, jp.algo_name), (label, algo)
    assert _sub_plans(p) == _sub_plans(jp), (label, algo)
    rng = np.random.RandomState(5)
    x = _snapped(rng, x_shape)
    w = (rng.randn(*w_shape) * 0.3).astype(np.float32)
    jref = japi.plan(jspec, backend="reference", algo=algo)
    jprep = _jax_prepared(jref, jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(jref.apply(jnp.asarray(x), jprep))
    got = p.apply(torch.from_numpy(x), _port_prepared(jprep))
    tol = 1e-5 if p.path == "direct" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_strided_int8_spec_is_lowered_as_jax_lowers_it():
    spec, jspec = _spec_pair((1, 9, 9, 3), (3, 3, 3, 4), 2, 1, False)
    for algo in ("sfc6_6", "auto"):
        jp = japi.plan(jspec, backend="pallas", algo=algo)
        p = plan(spec, backend="cuda", algo=algo)
        assert p.path == jp.path == "lowered"
        assert p.algo_name == jp.algo_name
        assert _sub_plans(p) == _sub_plans(jp)


def _jax_fp(x, w, name, padding, depthwise):
    """(JAX reference-backend fp output, JAX prepared weights)."""
    make = japi.ConvSpec.for_conv2d_depthwise if depthwise \
        else japi.ConvSpec.for_conv2d
    p = japi.plan(make(x.shape, w.shape, padding=padding, quant=JFP32),
                  backend="reference", algo=name)
    prep = p.prepare_weights(jnp.asarray(w))
    return np.asarray(p.apply(jnp.asarray(x), prep)), prep


@pytest.mark.parametrize("depthwise", [False, True], ids=["dense", "depthwise"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("name", ["sfc4_4", "sfc6_6", "sfc6_7"])
def test_cuda_fp_path_matches_jax(name, padding, depthwise):
    # B5 -> f32 product (depthwise: broadcast product) -> B3, within 1e-4
    rng = np.random.RandomState(8)
    x = rng.randn(2, 13, 11, 6).astype(np.float32)
    w_shape = (3, 3, 1, 6) if depthwise else (3, 3, 6, 7)
    w = (rng.randn(*w_shape) * 0.3).astype(np.float32)
    want, jprep = _jax_fp(x, w, name, padding, depthwise)
    make = ConvSpec.for_conv2d_depthwise if depthwise else ConvSpec.for_conv2d
    p = plan(make(x.shape, w.shape, padding=padding, quant=FP32),
             backend="cuda", algo=name)
    assert p.path == "fast"
    xt = torch.from_numpy(x)
    for prep in (torch.from_numpy(w), prepared_from_jax(jprep, device="cpu")):
        got = p.apply(xt, prep)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _jax_int8_depthwise(x, w, name, padding):
    spec = japi.ConvSpec.for_conv2d_depthwise(x.shape, w.shape,
                                              padding=padding,
                                              quant=JINT8_FREQ)
    p = japi.plan(spec, backend="reference", algo=name)
    act = japi.tuning.calibrate_act_scale(jnp.asarray(x), p.algorithm,
                                          JINT8_FREQ, padding)
    prep = p.prepare_weights(jnp.asarray(w), act_scale=act)
    return np.asarray(p.apply(jnp.asarray(x), prep)), prep


@pytest.mark.parametrize("config", ["fused", "staged"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("name", ["sfc4_4", "sfc6_6", "sfc6_7"])
def test_cuda_int8_depthwise_matches_jax_reference(name, padding, config):
    # B7 (fused) or B1 -> B6 -> B3 (staged) against the JAX reference
    # backend's int8 simulation, within 1e-4, with JAX's prepared weights
    # and with the port's own
    rng = np.random.RandomState(9)
    x = _snapped(rng, (2, 13, 11, 10))
    w = (rng.randn(3, 3, 1, 10) * 0.3).astype(np.float32)
    want, jprep = _jax_int8_depthwise(x, w, name, padding)
    spec = ConvSpec.for_conv2d_depthwise(x.shape, w.shape, padding=padding,
                                         quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo=name).with_config(CONFIGS[config])
    assert p.path == "fast"
    xt = torch.from_numpy(x)
    act = tuning.calibrate_act_scale(xt, p.algorithm, INT8_FREQ, padding)
    np.testing.assert_allclose(act.numpy(), np.asarray(jprep.act_scale),
                               rtol=1e-6)
    own = p.prepare_weights(torch.from_numpy(w), act_scale=act)
    for prep in (prepared_from_jax(jprep, device="cpu"), own):
        got = p.apply(xt, prep)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("path", ["fused", "staged", "fp", "depthwise"])
def test_cuda_backend_hands_the_kernels_contiguous_inputs(path, monkeypatch):
    """A strided view (here a crop, as a padded output's slice) reaches the
    kernels' entry points contiguous, whose CUDA wrappers refuse anything
    else, and gives the output of its contiguous copy."""
    from repro_torch.kernels import ops, sfc_fused
    seen = []
    for module, name in ((sfc_fused, "sfc_fused_conv2d"),
                         (ops, "quantized_fastconv2d"),
                         (ops, "quantized_fastconv2d_depthwise"),
                         (ops, "fastconv2d_fp_transformed")):
        entry = getattr(module, name)

        def observed(x, *args, _entry=entry, **kwargs):
            seen.append(x.is_contiguous())
            return _entry(x, *args, **kwargs)
        monkeypatch.setattr(module, name, observed)
    rng = np.random.RandomState(8)
    big = torch.from_numpy(_snapped(rng, (2, 13, 12, 6)))
    x = big[:, :11, :9]
    assert not x.is_contiguous()
    depthwise = path == "depthwise"
    w = torch.from_numpy(rng.randn(3, 3, 1 if depthwise else 6, 6).astype(
        np.float32))
    make = ConvSpec.for_conv2d_depthwise if depthwise \
        else ConvSpec.for_conv2d
    spec = make(x.shape, w.shape, quant=FP32 if path == "fp" else INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    if path == "fp":
        prep = p.prepare_weights(w)
    else:
        p = p.with_config(CONFIGS["staged" if path == "staged" else "fused"])
        prep = p.prepare_weights(w, act_scale=tuning.calibrate_act_scale(
            x.contiguous(), p.algorithm, INT8_FREQ))
    y = p.apply(x, prep)
    assert seen == [True]
    torch.testing.assert_close(y, p.apply(x.contiguous(), prep), rtol=0,
                               atol=0)


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


@pytest.mark.parametrize("layout,quant", [("depthwise", "int8"),
                                          ("depthwise", "fp32"),
                                          ("dense", "fp32")])
def test_conformance_oracle_on_depthwise_and_fp_specs(layout, quant):
    # the oracle drives the cuda backend's depthwise (B7 and B1 -> B6 ->
    # B3) and fp (B5 -> f32 product -> B3) paths within 1e-4
    rng = np.random.RandomState(10)
    x = torch.from_numpy(_snapped(rng, (2, 13, 11, 12)))
    w_shape = (3, 3, 1, 12) if layout == "depthwise" else (3, 3, 12, 5)
    w = torch.from_numpy((rng.randn(*w_shape) * 0.2).astype(np.float32))
    q = INT8_FREQ if quant == "int8" else FP32
    make = ConvSpec.for_conv2d_depthwise if layout == "depthwise" \
        else ConvSpec.for_conv2d
    y = assert_conv_conformance(x, w, make(x.shape, w.shape, quant=q),
                                "sfc6_6")
    assert y.shape[-1] == w_shape[-1] and torch.isfinite(y).all()


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


def _jax_applied(x, w, quant, act=None, w_scale=None):
    """The JAX reference backend's output of sfc6_6 on numpy operands."""
    jspec = japi.ConvSpec.for_conv2d(x.shape, w.shape, quant=quant)
    jp = japi.plan(jspec, backend="reference", algo="sfc6_6")
    if act is None:
        return np.asarray(jp.apply(jnp.asarray(x), jnp.asarray(w)))
    jprep = jp.prepare_weights(
        jnp.asarray(w), act_scale=jnp.asarray(act),
        w_scale=None if w_scale is None else jnp.asarray(w_scale))
    return np.asarray(jp.apply(jnp.asarray(x), jprep))


# (in-place update, precision): the weights scaled or overwritten, or the
# weight scales scaled, which only a quantized plan takes
INPLACE_CASES = [("mul", "fp32"), ("copy", "fp32"), ("mul", "int8"),
                 ("copy", "int8"), ("w_scale", "int8")]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("update,precision", INPLACE_CASES,
                         ids=["-".join(c) for c in INPLACE_CASES])
def test_inplace_updates_reach_the_prepared_weights(update, precision,
                                                    backend):
    # a plan applied after its weights (or weight scales) were updated in
    # place serves the updated ones, as the JAX package does given the
    # updated array; a PreparedWeights prepared before stays as it was
    rng = np.random.RandomState(21)
    x = _snapped(rng, (1, 12, 12, 4))
    w_np = (rng.randn(3, 3, 4, 5) * 0.3).astype(np.float32)
    w2_np = (rng.randn(3, 3, 4, 5) * 0.3).astype(np.float32)
    int8 = precision == "int8"
    quant, jquant = (INT8_FREQ, JINT8_FREQ) if int8 else (FP32, JFP32)
    p = plan(ConvSpec.for_conv2d(x.shape, w_np.shape, quant=quant),
             backend=backend, algo="sfc6_6")
    xt, w = torch.from_numpy(x), torch.from_numpy(w_np.copy())
    act = tuning.calibrate_act_scale(xt, p.algorithm, INT8_FREQ) \
        if int8 else None
    ws = torch.full((10, 10, 5), 2e-3) if update == "w_scale" else None

    def applied():
        if not int8:
            return p.apply(xt, w)
        return p.apply(xt, p.prepare_weights(w, act_scale=act, w_scale=ws))

    before = applied()
    held = p.prepare_weights(w, act_scale=act, w_scale=ws)
    held_out = p.apply(xt, held)
    if update == "mul":
        w.mul_(2)
    elif update == "copy":
        w.copy_(torch.from_numpy(w2_np))
    else:
        ws.mul_(1.5)
    got = applied()
    want = _jax_applied(x, w.numpy(), jquant,
                        None if act is None else act.numpy(),
                        None if ws is None else ws.numpy())
    assert not torch.equal(got, before)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert torch.equal(p.apply(xt, held), held_out)


def test_prepared_weights_cache_keeps_one_version_per_operands():
    rng = np.random.RandomState(22)
    w = torch.from_numpy(rng.randn(3, 3, 3, 7).astype(np.float32))
    act = torch.full((10, 10), 0.1)
    # plans are cached per spec: count the entries this test adds
    p = plan(ConvSpec.for_conv2d((1, 9, 9, 3), w.shape, quant=INT8_FREQ),
             backend="cuda", algo="sfc6_6")
    first = p.prepare_weights(w, act_scale=act)
    entries = len(p._prep)
    w.add_(1)
    second = p.prepare_weights(w, act_scale=act)
    assert second is not first and len(p._prep) == entries
    assert p.prepare_weights(w, act_scale=act) is second
    act.mul_(2)
    third = p.prepare_weights(w, act_scale=act)
    assert third is not second and len(p._prep) == entries
    assert torch.equal(third.act_scale, act)
    assert not torch.equal(second.act_scale, act)
