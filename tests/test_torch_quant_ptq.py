"""The port's fake quantization (with its straight-through estimator), the
granularity ablation of Tables 4/5 and PTQ calibration, against the JAX
package on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.quant.fake_quant as jfq  # noqa: E402
import repro.quant.ptq as jptq  # noqa: E402
from repro.api import ConvSpec as JConvSpec  # noqa: E402
from repro.api import plan as jplan  # noqa: E402

import repro_torch.quant.fake_quant as fq  # noqa: E402
from repro_torch.api import ConvSpec, plan  # noqa: E402
from repro_torch.quant import (CalibrationState, PTQLayer,  # noqa: E402
                               mse_scale_search)
from repro_torch.testing import DEFAULT_TOL  # noqa: E402

# (operand, granularity): the activation granularities on a transform-domain
# activation (B, nH, nW, t, t, C), the weight ones on (t, t, Cin, Cout)
OPERANDS = [("act", "tensor"), ("act", "frequency"), ("w", "channel"),
            ("w", "frequency"), ("w", "channel+frequency"), ("w", "tensor")]


def _operand(kind, seed):
    rng = np.random.RandomState(seed)
    shape = (2, 3, 3, 10, 10, 8) if kind == "act" else (10, 10, 6, 5)
    return (rng.randn(*shape) * 3).astype(np.float32)


def _fns(kind, bits, gran):
    if kind == "act":
        return (lambda x: jfq.fake_quant_activation(x, bits, gran),
                lambda x: fq.fake_quant_activation(x, bits, gran),
                jfq.activation_reduce_axes(6, gran))
    return (lambda w: jfq.fake_quant_weight(w, bits, gran),
            lambda w: fq.fake_quant_weight(w, bits, gran),
            jfq.weight_reduce_axes(4, gran))


def _absmax_mask(x, axes):
    a = np.abs(x)
    return a == a.max(axis=tuple(axes), keepdims=True)


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("kind,gran", OPERANDS)
def test_fake_quant_bit_for_bit(kind, gran, bits):
    x = _operand(kind, bits)
    jf, tf, axes = _fns(kind, bits, gran)
    mine = tf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(mine, np.asarray(jf(jnp.asarray(x))))
    # the premise of the gradient test: every group's absmax element lands
    # exactly on +-qmax
    q = fq.qmax_for_bits(bits)
    s = fq._absmax_scale(torch.from_numpy(x), axes, bits)
    grid = fq.quantize(torch.from_numpy(x), s, bits).numpy()
    mask = _absmax_mask(x, axes)
    np.testing.assert_array_equal(np.abs(grid[mask]), q)


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("kind,gran", OPERANDS)
def test_fake_quant_gradients_match_jax_grad(kind, gran, bits):
    """The STE gradient against ``jax.grad``, exact.

    (a) An upstream gradient only at each group's absmax element (random
    values there): every element of the gradient equals JAX's, the absmax
    ones (at +-qmax, where the clip halves the gradient and the scale's
    gradient arrives) included; a plain ``torch.clamp`` gives 2x there.
    (b) A random upstream gradient everywhere: every other element equals
    JAX's exactly; at the absmax elements the scale's gradient is a sum
    over the group (14,400 terms at 'tensor'), whose order differs between
    the two libraries, so there the bound is DEFAULT_TOL of the largest
    gradient.
    """
    x = _operand(kind, 10 + bits)
    jf, tf, axes = _fns(kind, bits, gran)
    mask = _absmax_mask(x, axes)
    rng = np.random.RandomState(20 + bits)
    for upstream in ("absmax only", "everywhere"):
        g = rng.randn(*x.shape).astype(np.float32)
        if upstream == "absmax only":
            g = g * mask
        want = np.asarray(jax.grad(
            lambda v: jnp.sum(jf(v) * g))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        (tf(xt) * torch.from_numpy(g)).sum().backward()
        got = xt.grad.numpy()
        if upstream == "absmax only":
            np.testing.assert_array_equal(got, want)
            assert np.all(got[mask] != 0)
        else:
            np.testing.assert_array_equal(got[~mask], want[~mask])
            np.testing.assert_allclose(got[mask], want[mask], rtol=0,
                                       atol=DEFAULT_TOL * np.abs(want).max())


def test_clip_halves_the_gradient_at_the_bounds_as_jnp_clip():
    x = np.array([127., -127., 3., 200., -300.], np.float32)
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.clip(v, -127., 127.)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    fq._clip(xt, -127., 127.).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.5, 0.5, 1., 0., 0.])


def _feature_batch(rng, B=4, H=28, W=28, C=32):
    """benchmarks/table45_granularity.py's low-frequency post-ReLU-like
    activations."""
    base = rng.randn(B, H // 4, W // 4, C)
    up = np.kron(base, np.ones((1, 4, 4, 1)))[:, :H, :W, :]
    return np.maximum(up + 0.3 * rng.randn(B, H, W, C), 0).astype(np.float32)


@pytest.fixture(scope="module")
def layer45():
    """The 28x28x32 layer of Tables 4/5 and its fp32 direct output, in both
    packages."""
    rng = np.random.RandomState(0)
    x = _feature_batch(rng)
    w = (rng.randn(3, 3, 32, 32) * 0.1).astype(np.float32)
    jspec = JConvSpec.for_conv2d(x.shape, w.shape)
    spec = ConvSpec.for_conv2d(x.shape, w.shape)
    jref = jplan(jspec, backend="reference", algo="direct").apply(
        jnp.asarray(x), jnp.asarray(w))
    ref = plan(spec, backend="reference", algo="direct").apply(
        torch.from_numpy(x), torch.from_numpy(w))
    return x, w, jspec, spec, jref, ref


def _rel_errs(layer, algo, bits, act_g, w_g):
    x, w, jspec, spec, jref, ref = layer
    jqc = jfq.QuantConfig(bits, bits, act_g, w_g)
    qc = fq.QuantConfig(bits, bits, act_g, w_g)
    jy = jplan(jspec, backend="reference", algo=algo).apply(
        jnp.asarray(x), jnp.asarray(w), elementwise_hook=jqc.hook())
    y = plan(spec, backend="reference", algo=algo).apply(
        torch.from_numpy(x), torch.from_numpy(w), elementwise_hook=qc.hook())
    between = float((y - torch.from_numpy(np.array(jy))).norm()
                    / ref.norm())
    return (float((y - ref).norm() / ref.norm()),
            float(jnp.linalg.norm(jy - jref) / jnp.linalg.norm(jref)),
            between)


# the rows of benchmarks/table45_granularity.py: Table 4 (8 bits, sfc6_7 and
# wino4, four granularity pairs) and Table 5 (sfc6_7 at 8, 6, 4 bits)
TABLE4 = [(a, 8, ag, wg) for a in ("sfc6_7", "wino4")
          for ag, wg in [("tensor", "channel"), ("frequency", "channel"),
                         ("frequency", "frequency"),
                         ("frequency", "channel+frequency")]]
TABLE5 = [("sfc6_7", b, ag, wg) for b in (8, 6, 4)
          for ag, wg in [("tensor", "channel"), ("frequency", "channel"),
                         ("frequency", "channel+frequency")]]


@pytest.mark.parametrize("algo,bits,act_g,w_g", TABLE4 + TABLE5)
def test_quant_config_hook_gives_the_granularity_rows(layer45, algo, bits,
                                                      act_g, w_g):
    """QuantConfig.hook() through the reference backend: each Table 4/5
    row's rel error (||y - y_fp32|| / ||y_fp32||) within 1e-5 of the JAX
    package's, and the quantized outputs themselves within 1e-5 of each
    other in the same norm.  The two transforms differ in the last bits
    (summation order; Winograd's amplifies it), which moves a rel error of
    0.375 by up to 4e-6: relative to the rel error that is 1.1e-5, so the
    bound is on the difference, in units of ||y_fp32||."""
    mine, theirs, between = _rel_errs(layer45, algo, bits, act_g, w_g)
    assert between <= 1e-5, between
    assert abs(mine - theirs) <= 1e-5, (mine, theirs)


def test_quant_config_hook_keeps_the_papers_claims(layer45):
    """The two qualitative asserts of table45_granularity.py, on the port:
    Winograd is more sensitive than SFC at int8 with tensor/channel scales,
    and frequency-wise scales help at int4."""
    err = {row: _rel_errs(layer45, *row)[0] for row in [
        ("wino4", 8, "tensor", "channel"), ("sfc6_7", 8, "tensor", "channel"),
        ("sfc6_7", 4, "frequency", "channel+frequency"),
        ("sfc6_7", 4, "tensor", "channel")]}
    assert err[("wino4", 8, "tensor", "channel")] > \
        err[("sfc6_7", 8, "tensor", "channel")]
    assert err[("sfc6_7", 4, "frequency", "channel+frequency")] < \
        err[("sfc6_7", 4, "tensor", "channel")]


def test_disabled_config_has_no_hook():
    assert fq.FP32.hook() is None and jfq.FP32.hook() is None


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", ["channel", "frequency",
                                  "channel+frequency"])
def test_mse_scale_search_equals_jax(gran, bits):
    w = _operand("w", 30 + bits)
    axes = jfq.weight_reduce_axes(4, gran)
    mine = mse_scale_search(torch.from_numpy(w), bits, axes).numpy()
    theirs = np.asarray(jptq.mse_scale_search(jnp.asarray(w), bits, axes))
    np.testing.assert_array_equal(mine, theirs)


def test_calibration_state_keeps_the_running_absmax():
    rng = np.random.RandomState(3)
    xs = [rng.randn(2, 5, 5, 4).astype(np.float32) * (i + 1)
          for i in range(3)]
    mine, theirs = CalibrationState(), jptq.CalibrationState()
    for x in xs:
        mine.update(torch.from_numpy(x), (0, 3))
        theirs.update(x, (0, 3))
    assert isinstance(mine.amax, torch.Tensor)
    np.testing.assert_array_equal(mine.scale(8).numpy(), theirs.scale(8))


@pytest.fixture(scope="module")
def calibrated():
    """A PTQLayer(INT8_FREQ) of each package calibrated on the same three
    batches through the reference backend, and a held-out input."""
    rng = np.random.RandomState(7)
    calib = [_feature_batch(rng, B=2, H=20, W=20, C=8) for _ in range(3)]
    held = _feature_batch(rng, B=2, H=20, W=20, C=8)
    w = (rng.randn(3, 3, 8, 12) * 0.2).astype(np.float32)
    jspec = JConvSpec.for_conv2d(held.shape, w.shape, quant=jfq.INT8_FREQ)
    spec = ConvSpec.for_conv2d(held.shape, w.shape, quant=fq.INT8_FREQ)
    jlayer, layer = jptq.PTQLayer(jfq.INT8_FREQ), PTQLayer(fq.INT8_FREQ)
    jref = jplan(jspec, backend="reference", algo="sfc6_6")
    ref = plan(spec, backend="reference", algo="sfc6_6")
    for x in calib:
        jref.apply(jnp.asarray(x), jnp.asarray(w),
                   elementwise_hook=jlayer.calibration_hook())
        ref.apply(torch.from_numpy(x), torch.from_numpy(w),
                  elementwise_hook=layer.calibration_hook())
    jy = jref.apply(jnp.asarray(held), jlayer.prepare(jref, jnp.asarray(w)))
    return dict(held=held, w=w, spec=spec, jspec=jspec, layer=layer,
                jlayer=jlayer, jy=np.asarray(jy))


def test_ptq_static_scales_match_jax(calibrated):
    """The calibrated (t, t) activation scales and the MSE-searched weight
    scales: the transform-domain values they come from differ between the
    libraries in the last bits (summation order), so within 1e-6."""
    act, ws = calibrated["layer"].static_scales(10)
    jact, jws = calibrated["jlayer"].static_scales(10)
    assert act.shape == (10, 10) and act.dtype == torch.float32
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=1e-6)
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-6)


@pytest.mark.parametrize("how", ["quantized_hook", "reference", "cuda",
                                 "cuda staged"])
def test_ptq_deployment_matches_jax(calibrated, how):
    """The port's quantized_hook() simulation and its prepare() on the
    reference and cuda backends (the kernels' plain versions on the CPU),
    within DEFAULT_TOL of the JAX package's PTQLayer.prepare on its
    reference backend."""
    from repro_torch.api import tuning
    c = calibrated
    x, w = torch.from_numpy(c["held"]), torch.from_numpy(c["w"])
    layer = c["layer"]
    if how == "quantized_hook":
        fp = ConvSpec.for_conv2d(x.shape, w.shape)
        y = plan(fp, backend="reference", algo="sfc6_6").apply(
            x, w, elementwise_hook=layer.quantized_hook())
    else:
        backend = "reference" if how == "reference" else "cuda"
        p = plan(c["spec"], backend=backend, algo="sfc6_6")
        if how == "cuda staged":
            p = p.with_config(tuning.DEFAULT_STAGED)
        prep = layer.prepare(p, w)
        assert prep.quantized
        y = p.apply(x, prep)
    scale = np.abs(c["jy"]).max()
    np.testing.assert_allclose(y.numpy(), c["jy"], rtol=0,
                               atol=DEFAULT_TOL * scale)


def test_ptq_prepare_passes_direct_and_rejects_lowered():
    rng = np.random.RandomState(11)
    w1 = rng.randn(1, 1, 8, 8).astype(np.float32)
    w3 = rng.randn(3, 3, 8, 8).astype(np.float32)
    x_shape = (1, 16, 16, 8)
    layer, jlayer = PTQLayer(fq.INT8_FREQ), jptq.PTQLayer(jfq.INT8_FREQ)
    p = plan(ConvSpec.for_conv2d(x_shape, w1.shape, quant=fq.INT8_FREQ),
             backend="cuda")
    assert p.path == "direct"
    prep = layer.prepare(p, torch.from_numpy(w1))
    assert not prep.quantized and prep.w is not None
    for lib, lay, spec_t, pl_ in (
            ("port", layer, ConvSpec, plan),
            ("jax", jlayer, JConvSpec, jplan)):
        q = jfq.INT8_FREQ if lib == "jax" else fq.INT8_FREQ
        p = pl_(spec_t.for_conv2d(x_shape, w3.shape, stride=2, quant=q),
                backend="reference", algo="sfc6_6")
        assert p.path == "lowered", lib
        with pytest.raises(NotImplementedError):
            lay.prepare(p, w3 if lib == "jax" else torch.from_numpy(w3))
