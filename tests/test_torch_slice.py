"""The slices as a whole: narrow VGG-style stacks (int8 and fp) and a
narrow depthwise stack through both packages, and the rule that the port
imports neither jax nor the JAX package."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.configs.resnet18 import SMOKE_CNN  # noqa: E402
from repro.quant.fake_quant import FP32 as JFP32  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch.api import ConvSpec, plan, tuning  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.quant import FP32, INT8_FREQ  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _init_vgg(rng, cfg):
    """He-normal weights in the ``init_vgg`` layout, from a numpy seed."""
    params, cin = {}, 3
    for si, (n_convs, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for ci in range(n_convs):
            w = rng.randn(3, 3, cin, width) * np.sqrt(2.0 / (9 * cin))
            params[f"s{si}c{ci}"] = {
                "w": w.astype(np.float32),
                "b": (rng.randn(width) * 0.05).astype(np.float32)}
            cin = width
    return params


def _maxpool(h):
    """2x2 stride-2 SAME max-pool on NHWC numpy."""
    B, H, W, C = h.shape
    hp = np.full((B, H + H % 2, W + W % 2, C), -np.inf, np.float32)
    hp[:, :H, :W] = h
    return hp.reshape(B, hp.shape[1] // 2, 2, hp.shape[2] // 2, 2,
                      C).max(axis=(2, 4))


@pytest.mark.parametrize("datapath", ["fused", "staged"])
def test_narrow_vgg_stack_layer_by_layer(datapath):
    cfg = SMOKE_CNN                  # stages (1, 1), widths (8, 16), 16x16
    rng = np.random.RandomState(0)
    params = _init_vgg(rng, cfg)
    tparams = params_from_numpy(params, device="cpu")
    config = tuning.DEFAULT_FUSED if datapath == "fused" \
        else tuning.DEFAULT_STAGED
    h = rng.randn(2, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    for si, n_convs in enumerate(cfg.stages):
        for ci in range(n_convs):
            name = f"s{si}c{ci}"
            w, b = params[name]["w"], params[name]["b"]
            x = (np.round(h * 16) / 16).astype(np.float32)   # snapped input
            jspec = japi.ConvSpec.for_conv2d(x.shape, w.shape,
                                             quant=JINT8_FREQ)
            jp = japi.plan(jspec, backend="reference", algo="sfc6_6")
            jact = japi.tuning.calibrate_act_scale(
                jnp.asarray(x), jp.algorithm, JINT8_FREQ)
            want = np.asarray(jp.apply(
                jnp.asarray(x),
                jp.prepare_weights(jnp.asarray(w), act_scale=jact),
                bias=jnp.asarray(b)))
            spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
            p = plan(spec, backend="cuda", algo="sfc6_6").with_config(config)
            xt = torch.from_numpy(x)
            act = tuning.calibrate_act_scale(xt, p.algorithm, INT8_FREQ)
            np.testing.assert_allclose(act.numpy(), np.asarray(jact),
                                       rtol=1e-6)
            got = p.apply(xt, p.prepare_weights(tparams[name]["w"],
                                                act_scale=act),
                          bias=tparams[name]["b"]).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
            h = np.maximum(got, 0)
        h = _maxpool(h)
    assert h.shape == (2, 4, 4, cfg.widths[-1]) and np.isfinite(h).all()


def test_narrow_vgg_stack_fp_path_layer_by_layer():
    # every layer through the cuda backend's fp path (B5 -> f32 product ->
    # B3) against the JAX reference backend on the same input, within 1e-4
    cfg = SMOKE_CNN
    rng = np.random.RandomState(1)
    params = _init_vgg(rng, cfg)
    tparams = params_from_numpy(params, device="cpu")
    h = rng.randn(2, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    for si, n_convs in enumerate(cfg.stages):
        for ci in range(n_convs):
            name = f"s{si}c{ci}"
            w, b = params[name]["w"], params[name]["b"]
            jspec = japi.ConvSpec.for_conv2d(h.shape, w.shape, quant=JFP32)
            want = np.asarray(japi.plan(jspec, backend="reference",
                                        algo="sfc6_6").apply(
                jnp.asarray(h), jnp.asarray(w), bias=jnp.asarray(b)))
            spec = ConvSpec.for_conv2d(h.shape, w.shape, quant=FP32)
            p = plan(spec, backend="cuda", algo="sfc6_6")
            got = p.apply(torch.from_numpy(h), tparams[name]["w"],
                          bias=tparams[name]["b"]).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
            h = np.maximum(got, 0)
        h = _maxpool(h)
    assert h.shape == (2, 4, 4, cfg.widths[-1]) and np.isfinite(h).all()


# narrow stride-1 depthwise 3x3 layers (H = W, C), MobileNetV2-like in
# shape, not chained: pointwise convs sit between them in the model
DEPTHWISE_LAYERS = ((16, 8), (8, 24), (7, 36), (5, 12))


@pytest.mark.parametrize("path", ["fused", "staged", "fp"])
def test_narrow_depthwise_stack_layer_by_layer(path):
    # each layer through the cuda backend (B7, B1 -> B6 -> B3, or B5 ->
    # broadcast product -> B3) against the JAX reference backend, within
    # 1e-4; int8 layers on snapped inputs, calibrated per layer
    rng = np.random.RandomState(2)
    for hw, c in DEPTHWISE_LAYERS:
        x = rng.randn(2, hw, hw, c).astype(np.float32)
        if path != "fp":
            x = (np.round(x * 16) / 16).astype(np.float32)
        w = (rng.randn(3, 3, 1, c) * np.sqrt(2.0 / 9)).astype(np.float32)
        quant, jquant = (FP32, JFP32) if path == "fp" \
            else (INT8_FREQ, JINT8_FREQ)
        jp = japi.plan(japi.ConvSpec.for_conv2d_depthwise(
            x.shape, w.shape, quant=jquant), backend="reference",
            algo="sfc6_6")
        p = plan(ConvSpec.for_conv2d_depthwise(x.shape, w.shape,
                                               quant=quant),
                 backend="cuda", algo="sfc6_6")
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        if path == "fp":
            want = np.asarray(jp.apply(jnp.asarray(x), jnp.asarray(w)))
            got = p.apply(xt, wt).numpy()
        else:
            jact = japi.tuning.calibrate_act_scale(jnp.asarray(x),
                                                   jp.algorithm, JINT8_FREQ)
            want = np.asarray(jp.apply(jnp.asarray(x), jp.prepare_weights(
                jnp.asarray(w), act_scale=jact)))
            config = tuning.DEFAULT_FUSED if path == "fused" \
                else tuning.DEFAULT_STAGED
            p = p.with_config(config)
            act = tuning.calibrate_act_scale(xt, p.algorithm, INT8_FREQ)
            got = p.apply(xt, p.prepare_weights(wt, act_scale=act)).numpy()
        assert got.shape == want.shape == x.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{hw}x{hw}x{c}")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "examples" / "train_cnn_sfc_torch.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    offenders = {str(f.relative_to(ROOT)): sorted(
        _imported_roots(f) & {"jax", "jaxlib", "repro"}) for f in files}
    assert not any(offenders.values()), offenders
