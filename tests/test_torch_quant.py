"""The port's quantization, calibration, ranges and BOPs against the JAX
package's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.quant.fake_quant as jfq  # noqa: E402
from repro.analysis import ranges as jranges  # noqa: E402
from repro.api import ConvSpec as JConvSpec  # noqa: E402
from repro.api import plan as jplan  # noqa: E402
from repro.api import registry as jregistry  # noqa: E402
from repro.api import tuning as jtuning  # noqa: E402
from repro.quant import bops as jbops  # noqa: E402

import repro_torch.quant.fake_quant as fq  # noqa: E402
from repro_torch.analysis import ranges  # noqa: E402
from repro_torch.api import ConvSpec, plan, registry, tuning  # noqa: E402
from repro_torch.quant import bops  # noqa: E402

VGG_LAYERS = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
              (56, 128, 256), (56, 256, 256), (28, 256, 512),
              (28, 512, 512), (14, 512, 512)]


def test_round_half_even_ties():
    x = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, 126.5, 127.5, -200.],
                 np.float32)
    s = np.float32(1.0)
    mine = fq.quantize(torch.from_numpy(x), torch.tensor(s), 8).numpy()
    theirs = np.asarray(jfq.quantize(jnp.asarray(x), jnp.asarray(s), 8))
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(
        mine, [0., -0., 2., -2., 2., -2., 4., 126., 127., -127.])


def test_quantize_divides_like_the_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(4096).astype(np.float32) * 50
    s = np.float32(0.1)      # 1/0.1 is inexact: a reciprocal would drift
    mine = fq.quantize(torch.from_numpy(x), torch.tensor(s), 8).numpy()
    theirs = np.asarray(jfq.quantize(jnp.asarray(x), jnp.asarray(s), 8))
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("bits", [8, 6, 4])
def test_quantize_transformed_weights_int8_equal(bits):
    rng = np.random.RandomState(bits)
    tw = (rng.randn(10, 10, 6, 5) * 3).astype(np.float32)
    ws = (np.abs(rng.randn(10, 10, 5)) * 0.05 + 1e-3).astype(np.float32)
    mine = fq.quantize_transformed_weights(torch.from_numpy(tw),
                                           torch.from_numpy(ws), bits)
    theirs = jfq.quantize_transformed_weights(jnp.asarray(tw),
                                              jnp.asarray(ws), bits)
    assert mine.dtype == torch.int8 and mine.shape == (100, 6, 5)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_weight_reduce_axes_equal():
    for g in ("channel", "frequency", "channel+frequency", "tensor"):
        assert fq.weight_reduce_axes(4, g) == jfq.weight_reduce_axes(4, g)


def test_quant_config_constants_equal():
    for name in ("FP32", "INT8_FREQ", "INT8_TENSOR", "INT6_FREQ",
                 "INT4_FREQ"):
        assert dataclasses.astuple(getattr(fq, name)) == \
            dataclasses.astuple(getattr(jfq, name))


def test_hook_waits_for_training_slice():
    with pytest.raises(NotImplementedError, match="training slice"):
        fq.INT8_FREQ.hook()


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("name", ["sfc4_4", "sfc6_6", "sfc6_7"])
def test_calibrate_and_default_w_scale(name, padding):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 13, 11, 5).astype(np.float32)
    w = (rng.randn(3, 3, 5, 7) * 0.2).astype(np.float32)
    algo = registry.get_algorithm(name)
    act = tuning.calibrate_act_scale(torch.from_numpy(x), algo,
                                     fq.INT8_FREQ, padding)
    jact = jtuning.calibrate_act_scale(
        jnp.asarray(x), jregistry.get_algorithm(name), jfq.INT8_FREQ,
        padding)
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=1e-6)
    spec = ConvSpec.for_conv2d(x.shape, w.shape, padding=padding,
                               quant=fq.INT8_FREQ)
    jspec = JConvSpec.for_conv2d(x.shape, w.shape, padding=padding,
                                 quant=jfq.INT8_FREQ)
    prep = plan(spec, backend="cuda", algo=name).prepare_weights(
        torch.from_numpy(w), act_scale=torch.tensor(np.asarray(jact)))
    jprep = jplan(jspec, backend="reference", algo=name).prepare_weights(
        jnp.asarray(w), act_scale=jact)
    np.testing.assert_allclose(prep.w_scale.numpy(),
                               np.asarray(jprep.w_scale), rtol=1e-6)
    mismatched = (prep.wq.numpy() != np.asarray(jprep.wq)).sum()
    assert mismatched <= max(1, prep.wq.numel() // 10000)


def test_safe_cin_bound():
    assert ranges.safe_cin_bound() == 133144
    assert ranges.safe_cin_bound(8, 8) == jranges.safe_cin_bound(8, 8)
    assert ranges.dequant_exact_cin() == jranges.dequant_exact_cin()


def test_certificates_equal():
    mine = {k: c.to_json() for k, c in ranges.all_certificates().items()}
    theirs = {k: c.to_json() for k, c in jranges.all_certificates().items()}
    assert mine == theirs


@pytest.mark.parametrize("hw,cin,cout", VGG_LAYERS)
def test_bops_equal(hw, cin, cout):
    for bits in (8, 4):
        wl = bops.ConvWorkload(hw, hw, cin, cout, 3, bits, bits)
        jwl = jbops.ConvWorkload(hw, hw, cin, cout, 3, bits, bits)
        assert bops.direct_conv_bops(wl) == jbops.direct_conv_bops(jwl)
        for name in registry.list_algorithms(taps=3, include_direct=False):
            assert bops.fastconv_bops(wl, registry.get_algorithm(name)) \
                == jbops.fastconv_bops(jwl, jregistry.get_algorithm(name))
