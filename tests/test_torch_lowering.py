"""The port's lowering pass (``repro_torch.api.lowering``) against the JAX
package's ``repro.api.lowering``.

Plans are compared by path, ``algo_name`` and sub-plans (sub-spec and
resolved sub-algorithm, in order) against the JAX package's ``pallas`` and
``reference`` plans; outputs against the JAX composite's on the reference
backend, on the same numpy inputs.  The port's ``cuda`` backend runs its
kernels' plain versions here (CPU tensors).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.api import lowering as jlowering  # noqa: E402
from repro.quant.fake_quant import FP32 as JFP32  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.api import (CompositePlan, CompositePrepared,  # noqa: E402
                             ConvSpec, lowering, plan, tuning)
from repro_torch.api.plan import ConvPlan  # noqa: E402
from repro_torch.interop import prepared_from_jax  # noqa: E402
from repro_torch.quant import FP32, INT8_FREQ  # noqa: E402
from repro_torch.testing import DEFAULT_TOL  # noqa: E402

QUANTS = {"int8": (INT8_FREQ, JINT8_FREQ), "fp": (FP32, JFP32)}


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
    """Plans consult the port's timing cache: keep it empty and private."""
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    yield
    tuning.set_cache_path(None)


def _specs(quant, **kw):
    """(port spec, JAX spec) with the same fields."""
    q, jq = QUANTS[quant]
    return ConvSpec(quant=q, **kw), japi.ConvSpec(quant=jq, **kw)


def _structure(p):
    """(path, algo_name, [(sub-spec fields, sub-structure)]) of a plan."""
    subs = [(_spec_fields(sp.spec), _structure(sp))
            for sp in getattr(p, "sub_plans", ())]
    return p.path, p.algo_name, subs


def _spec_fields(spec):
    d = dataclasses.asdict(spec)
    d.pop("quant")
    return d


def _assert_same_plan(spec, jspec, algo):
    for backend, jbackend in (("cuda", "pallas"),
                              ("reference", "reference")):
        got = _structure(plan(spec, backend=backend, algo=algo))
        want = _structure(japi.plan(jspec, backend=jbackend, algo=algo))
        assert got == want, (backend, spec, algo)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ----------------------------------------------------------------------
# geometry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_phase_taps_and_strided_lo_out_match_jax(stride):
    for R in range(1, 9):
        for a in range(stride + 1):
            assert lowering.phase_taps(R, a, stride) \
                == jlowering.phase_taps(R, a, stride)
        for size in range(max(R, 1), 20):
            for padding in ("SAME", "VALID"):
                assert lowering.strided_lo_out(size, R, stride, padding) \
                    == jlowering.strided_lo_out(size, R, stride, padding)


# ----------------------------------------------------------------------
# plan agreement
# ----------------------------------------------------------------------
ALGOS = ["auto", "sfc6_6", "sfc4_4_r2", "direct"]


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("R", [2, 3, 5, 7])
def test_strided_plans_match_jax(R, padding, algo, quant):
    for hw, cin, cout in ((15, 4, 8), (28, 64, 128)):
        spec, jspec = _specs(quant, kernel_size=R, stride=2, padding=padding,
                             in_channels=cin, out_channels=cout,
                             spatial=(hw, hw - 2))
        _assert_same_plan(spec, jspec, algo)


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("groups", [2, 4, 32])
def test_grouped_plans_match_jax(groups, algo, quant):
    for stride in (1, 2):
        for padding in ("SAME", "VALID"):
            spec, jspec = _specs(quant, kernel_size=3, stride=stride,
                                 padding=padding, groups=groups,
                                 in_channels=128, out_channels=64,
                                 spatial=(14, 13))
            _assert_same_plan(spec, jspec, algo)


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("algo", ALGOS + ["sfc4_5_r2", "sfc6_7_r2"])
def test_strided_depthwise_plans_match_jax(algo, quant):
    for hw, c in ((112, 96), (15, 8), (14, 576)):
        for padding in ("SAME", "VALID"):
            spec, jspec = _specs(quant, kernel_size=3, stride=2,
                                 padding=padding, depthwise=True,
                                 in_channels=c, out_channels=c,
                                 spatial=(hw, hw))
            _assert_same_plan(spec, jspec, algo)


# the full-width specs the card runs (planning only, which is cheap):
# ResNet-18's stem and 3x3/2 transitions, MobileNetV2's stride-2 depthwise
# convs, and grouped convs, with the plans the JAX package resolves
FULL_WIDTH = [
    (dict(kernel_size=7, stride=2, in_channels=3, out_channels=64,
          spatial=(224, 224)), "int8", "auto",
     "polyphase[sfc6_6_r4+sfc4_4]"),
    (dict(kernel_size=7, stride=2, in_channels=3, out_channels=64,
          spatial=(224, 224)), "int8", "sfc6_6",
     "polyphase[sfc6_6_r4+sfc6_6]"),
    (dict(kernel_size=7, stride=2, in_channels=3, out_channels=64,
          spatial=(224, 224)), "fp", "sfc6_6", None),
] + [
    (dict(kernel_size=3, stride=2, in_channels=ci, out_channels=co,
          spatial=(hw, hw)), quant, algo, "polyphase[sfc6_7_r2+direct]")
    for hw, ci, co in ((56, 64, 128), (28, 128, 256), (14, 256, 512))
    for algo in ("auto", "sfc6_6") for quant in ("int8",)
] + [
    (dict(kernel_size=3, stride=2, depthwise=True, in_channels=c,
          out_channels=c, spatial=(hw, hw)), "int8", algo, want)
    for hw, c in ((112, 96), (56, 144), (28, 192), (14, 576))
    for algo, want in (("auto", "direct"), ("sfc6_6", "direct"),
                       ("sfc4_4_r2", "polyphase[sfc4_4_r2+direct]"),
                       ("sfc4_5_r2", "polyphase[sfc4_5_r2+direct]"),
                       ("sfc6_7_r2", "polyphase[sfc6_7_r2+direct]"))
] + [
    (dict(kernel_size=3, stride=2, depthwise=True, in_channels=c,
          out_channels=c, spatial=(hw, hw)), "fp", "sfc6_6", want)
    for hw, c, want in ((112, 96, "polyphase[sfc4_4_r2+direct]"),
                        (56, 144, "polyphase[sfc4_4_r2+direct]"),
                        (28, 192, "polyphase[sfc4_5_r2+direct]"),
                        (14, 576, "direct"))
] + [
    (dict(kernel_size=3, groups=32, in_channels=128, out_channels=128,
          spatial=(56, 56)), "int8", "auto", "grouped[sfc4_4]"),
    (dict(kernel_size=3, groups=4, in_channels=128, out_channels=128,
          spatial=(56, 56)), "int8", "sfc6_6", "grouped[sfc6_6]"),
]


@pytest.mark.parametrize("fields,quant,algo,want", FULL_WIDTH)
def test_full_width_plans_match_jax(fields, quant, algo, want):
    spec, jspec = _specs(quant, **fields)
    _assert_same_plan(spec, jspec, algo)
    if want is not None:
        assert plan(spec, backend="cuda", algo=algo).algo_name == want


def test_strided_and_grouped_specs_no_longer_raise():
    for fields in (dict(kernel_size=3, stride=2), dict(kernel_size=3,
                                                       groups=2)):
        spec = ConvSpec(in_channels=8, out_channels=8, spatial=(9, 9),
                        quant=INT8_FREQ, **fields)
        assert plan(spec, backend="cuda", algo="sfc6_6").path == "lowered"


def test_disabled_plans_direct_and_restores():
    spec = ConvSpec(kernel_size=3, stride=2, in_channels=64,
                    out_channels=128, spatial=(56, 56), quant=INT8_FREQ)
    with lowering.disabled():
        assert plan(spec, backend="cuda", algo="sfc6_6").path == "direct"
    assert plan(spec, backend="cuda", algo="sfc6_6").path == "lowered"


def test_grouped_sub_plans_are_one_plan():
    spec = ConvSpec(kernel_size=3, groups=4, in_channels=16, out_channels=8,
                    spatial=(12, 12), quant=INT8_FREQ)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    assert isinstance(p, CompositePlan) and p.kind == "grouped"
    assert len({id(sp) for sp in p.sub_plans}) == 1
    assert isinstance(p.sub_plans[0], ConvPlan)


# ----------------------------------------------------------------------
# execution against the JAX composite
# ----------------------------------------------------------------------
def _snapped(rng, shape):
    return (np.round(rng.randn(*shape) * 16) / 16).astype(np.float32)


# (label, x shape, w shape, stride, groups, depthwise, padding, algo)
COMPOSITES = [
    ("s2_3x3", (2, 15, 13, 6), (3, 3, 6, 8), 2, 1, False, "SAME", "sfc6_6"),
    ("s2_3x3_valid", (1, 15, 13, 6), (3, 3, 6, 8), 2, 1, False, "VALID",
     "sfc6_6"),
    ("s2_7x7_stem", (1, 15, 13, 3), (7, 7, 3, 8), 2, 1, False, "SAME",
     "sfc6_6"),
    ("s2_5x5", (1, 15, 13, 4), (5, 5, 4, 6), 2, 1, False, "SAME",
     "sfc6_6"),
    ("grouped_g4", (1, 15, 13, 8), (3, 3, 2, 12), 1, 4, False, "SAME",
     "sfc6_6"),
    ("grouped_g2_s2", (1, 15, 13, 8), (3, 3, 4, 6), 2, 2, False, "SAME",
     "sfc6_6"),
    ("depthwise_s2", (2, 15, 13, 8), (3, 3, 1, 8), 2, 1, True, "SAME",
     "sfc4_4_r2"),
    ("depthwise_s2_valid", (1, 15, 13, 8), (3, 3, 1, 8), 2, 1, True,
     "VALID", "sfc4_5_r2"),
]


def _spec_pair(case, quant):
    _, xs, ws, stride, groups, dw, padding, _ = case
    q, jq = QUANTS[quant]
    if dw:
        return (ConvSpec.for_conv2d_depthwise(xs, ws, stride=stride,
                                              padding=padding, quant=q),
                japi.ConvSpec.for_conv2d_depthwise(
                    xs, ws, stride=stride, padding=padding, quant=jq))
    return (ConvSpec.for_conv2d(xs, ws, stride=stride, padding=padding,
                                groups=groups, quant=q),
            japi.ConvSpec.for_conv2d(xs, ws, stride=stride, padding=padding,
                                     groups=groups, quant=jq))


def _prepared_from_jax(jprep):
    """A JAX (possibly composite) prepared weights -> the port's."""
    if isinstance(jprep, jlowering.CompositePrepared):
        return CompositePrepared(
            w=torch.from_numpy(np.array(jprep.w)),
            subs=tuple(_prepared_from_jax(s) for s in jprep.subs))
    return prepared_from_jax(jprep, device="cpu")


def _case_data(case, seed=0):
    _, xs, ws, *_ = case
    rng = np.random.RandomState(seed)
    x = _snapped(rng, xs)
    w = (rng.randn(*ws) * 0.3).astype(np.float32)
    b = rng.randn(ws[-1]).astype(np.float32)
    return x, w, b


def _jax_composite(case, quant, x, w):
    """(JAX reference composite plan, its prepared weights) for ``x``."""
    _, jspec = _spec_pair(case, quant)
    jp = japi.plan(jspec, backend="reference", algo=case[-1])
    assert jp.path == "lowered", case[0]
    if quant == "int8":
        return jp, jp.prepare_weights(jnp.asarray(w),
                                      act_scale=jp.calibrate(jnp.asarray(x)))
    return jp, jp.prepare_weights(jnp.asarray(w))


def _assert_scales_close(got, want):
    """Per-sub activation scales (nested for nested composites)."""
    if want is None:
        assert got is None
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_scales_close(g, w)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("backend,datapath", [("cuda", "fused"),
                                              ("cuda", "staged"),
                                              ("reference", "fused")])
@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("case", COMPOSITES, ids=[c[0] for c in COMPOSITES])
def test_composite_apply_matches_jax(case, quant, backend, datapath):
    """The port's composite on the JAX composite's prepared weights, and
    on its own calibration and preparation, against the JAX composite's
    output (reference backend), bias included."""
    x, w, b = _case_data(case)
    jp, jprep = _jax_composite(case, quant, x, w)
    want = np.asarray(jp.apply(jnp.asarray(x), jprep, bias=jnp.asarray(b)))
    spec, _ = _spec_pair(case, quant)
    p = plan(spec, backend=backend, algo=case[-1])
    assert _structure(p) == _structure(jp)
    p = p.with_config(tuning.KernelConfig(datapath=datapath))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got = p.apply(xt, _prepared_from_jax(jprep), bias=bt).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= DEFAULT_TOL, case[0]
    if quant == "int8":
        act = p.calibrate(xt)
        _assert_scales_close(act, jp.calibrate(jnp.asarray(x)))
        prep = p.prepare_weights(wt, act_scale=act)
    else:
        prep = p.prepare_weights(wt)
    own = p.apply(xt, prep, bias=bt).numpy()
    assert _rel_l2(own, want) <= DEFAULT_TOL, case[0]


@pytest.mark.parametrize("quant", sorted(QUANTS))
def test_cuda_fused_and_staged_composites_agree(quant):
    """The two int8 datapaths of a lowered plan (each sub-plan's kernels'
    plain versions) agree with each other and the reference backend."""
    case = COMPOSITES[2]                       # the 7x7/2 stem
    x, w, _ = _case_data(case, seed=3)
    spec, _ = _spec_pair(case, quant)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    prep = p.prepare_weights(wt, act_scale=p.calibrate(xt)) \
        if quant == "int8" else p.prepare_weights(wt)
    ref = plan(spec, backend="reference", algo="sfc6_6").apply(xt, prep)
    outs = [p.with_config(cfg).apply(xt, prep).numpy()
            for cfg in (tuning.DEFAULT_FUSED, tuning.DEFAULT_STAGED)]
    for y in outs:
        assert _rel_l2(y, ref.numpy()) <= DEFAULT_TOL
    np.testing.assert_allclose(outs[0], outs[1], rtol=DEFAULT_TOL,
                               atol=DEFAULT_TOL * np.abs(outs[1]).max())


def test_composite_calibrate_length_is_checked():
    case = COMPOSITES[0]
    spec, _ = _spec_pair(case, "int8")
    p = plan(spec, backend="cuda", algo="sfc6_6")
    with pytest.raises(ValueError, match="sub-problems"):
        p.prepare_weights(torch.zeros(3, 3, 6, 8), act_scale=(None,))


# ----------------------------------------------------------------------
# a narrow ResNet-style stack
# ----------------------------------------------------------------------
# (name, R, stride, C_in, C_out): a 7x7/2 stem, a 3x3/2 SAME max-pool,
# one basic block a stage, the later stages opening with a 3x3/2 conv and
# a 1x1/2 projection on the shortcut
NARROW = (("stem", 7, 2, 3, 8),)
NARROW_BLOCKS = ((8, 8, 1), (8, 16, 2), (16, 24, 2))


def _narrow_params(seed=0):
    rng = np.random.RandomState(seed)

    def conv(r, cin, cout):
        return (rng.randn(r, r, cin, cout)
                * np.sqrt(2.0 / (r * r * cin))).astype(np.float32)

    p = {"stem": {"w": conv(7, 3, 8)}}
    for i, (cin, cout, stride) in enumerate(NARROW_BLOCKS):
        blk = {"conv1": {"w": conv(3, cin, cout)},
               "conv2": {"w": conv(3, cout, cout)}}
        if stride != 1 or cin != cout:
            blk["proj"] = {"w": conv(1, cin, cout)}
        p[f"b{i}"] = blk
    return p


def _narrow_forward(params, x, conv, relu, add, maxpool):
    """ReLU, residual adds and a max-pool as ``resnet_forward`` has them,
    normalization and head left out; ``conv(name, h, w, stride)``."""
    h = relu(conv("stem", x, params["stem"]["w"], 2))
    h = maxpool(h)
    for i, (_, _, stride) in enumerate(NARROW_BLOCKS):
        blk = params[f"b{i}"]
        y = relu(conv(f"b{i}.conv1", h, blk["conv1"]["w"], stride))
        y = conv(f"b{i}.conv2", y, blk["conv2"]["w"], 1)
        sc = conv(f"b{i}.proj", h, blk["proj"]["w"], stride) \
            if "proj" in blk else h
        h = relu(add(y, sc))
    return h


def _torch_maxpool(h):
    """3x3/2 SAME max-pool of NHWC ``h`` (the XLA padding convention)."""
    lo_h, _ = lowering.strided_lo_out(h.shape[1], 3, 2, "SAME")
    lo_w, _ = lowering.strided_lo_out(h.shape[2], 3, 2, "SAME")
    out_h, out_w = -(-h.shape[1] // 2), -(-h.shape[2] // 2)
    hi_h = (out_h - 1) * 2 + 3 - h.shape[1] - lo_h
    hi_w = (out_w - 1) * 2 + 3 - h.shape[2] - lo_w
    t = torch.nn.functional.pad(h.permute(0, 3, 1, 2),
                                (lo_w, hi_w, lo_h, hi_h),
                                value=float("-inf"))
    return torch.nn.functional.max_pool2d(t, 3, 2).permute(
        0, 2, 3, 1).contiguous()


def _jax_maxpool(h):
    return jax.lax.reduce_window(h, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_narrow_resnet_stack_fp_matches_jax(backend):
    """fp32 end to end: the stem and the transitions lowered, the 1x1/2
    projections direct, weights carried across as numpy."""
    params = _narrow_params()
    x = np.random.RandomState(1).randn(2, 33, 31, 3).astype(np.float32)
    tparams = interop.params_from_numpy(params, device="cpu")
    paths = {}

    def tconv(name, h, w, stride):
        spec = ConvSpec.for_conv2d(h.shape, w.shape, stride=stride,
                                   quant=FP32)
        p = plan(spec, backend=backend, algo="sfc6_6")
        paths[name] = p.path
        return p.apply(h, w)

    def jconv(name, h, w, stride):
        spec = japi.ConvSpec.for_conv2d(h.shape, w.shape, stride=stride,
                                        quant=JFP32)
        p = japi.plan(spec, backend="reference", algo="sfc6_6")
        assert p.path == paths[name], name
        return p.apply(h, w)

    got = _narrow_forward(tparams, torch.from_numpy(x), tconv, torch.relu,
                          torch.add, _torch_maxpool)
    want = _narrow_forward(jax.tree_util.tree_map(jnp.asarray, params),
                           jnp.asarray(x), jconv,
                           lambda a: jnp.maximum(a, 0), jnp.add,
                           _jax_maxpool)
    assert paths["stem"] == "lowered" and paths["b1.conv1"] == "lowered"
    assert paths["b1.proj"] == "direct" and paths["b0.conv1"] == "fast"
    want = np.asarray(want)
    assert got.shape == want.shape
    assert _rel_l2(got.numpy(), want) <= DEFAULT_TOL


@pytest.mark.parametrize("datapath", ["fused", "staged"])
def test_narrow_resnet_stack_int8_layers_match_jax(datapath):
    """int8 layer by layer along the JAX stack: each layer of the port's
    ``cuda`` backend takes the JAX layer's input and the JAX layer's
    calibrated, prepared weights (per sub-conv on the lowered layers)."""
    params = _narrow_params(seed=2)
    x = np.random.RandomState(3).randn(1, 33, 31, 3).astype(np.float32)
    cfg = tuning.KernelConfig(datapath=datapath)
    checked = []

    def jconv(name, h, w, stride):
        spec = japi.ConvSpec.for_conv2d(h.shape, w.shape, stride=stride,
                                        quant=JINT8_FREQ)
        jp = japi.plan(spec, backend="reference", algo="sfc6_6")
        if jp.path == "lowered":
            jprep = jp.prepare_weights(w, act_scale=jp.calibrate(h))
        elif jp.path == "fast":
            jprep = jp.prepare_weights(w, act_scale=(
                japi.tuning.calibrate_act_scale(h, jp.algorithm,
                                                JINT8_FREQ)))
        else:
            jprep = jp.prepare_weights(w)
        y = jp.apply(h, jprep)
        tspec = ConvSpec.for_conv2d(h.shape, w.shape, stride=stride,
                                    quant=INT8_FREQ)
        p = plan(tspec, backend="cuda", algo="sfc6_6").with_config(cfg)
        assert _structure(p) == _structure(jp), name
        got = p.apply(torch.from_numpy(np.asarray(h)),
                      _prepared_from_jax(jprep)).numpy()
        assert _rel_l2(got, np.asarray(y)) <= DEFAULT_TOL, name
        checked.append((name, p.path))
        return y

    _narrow_forward(jax.tree_util.tree_map(jnp.asarray, params),
                    jnp.asarray(x), jconv, lambda a: jnp.maximum(a, 0),
                    jnp.add, _jax_maxpool)
    assert len(checked) == 1 + 2 * len(NARROW_BLOCKS) + 2
    assert {path for _, path in checked} == {"lowered", "fast", "direct"}


# ----------------------------------------------------------------------
# the prepared-weight cache with nested operands
# ----------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_inplace_updates_reach_composite_prepare_weights(backend):
    """An in-place update of the weights, or of one sub-conv's activation
    scale inside the per-sub tuple, prepares the composite anew."""
    case = COMPOSITES[0]
    x, w, _ = _case_data(case, seed=4)
    spec, _ = _spec_pair(case, "int8")
    p = plan(spec, backend=backend, algo="sfc6_6")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).clone()
    act = p.calibrate(xt)
    first = p.prepare_weights(wt, act_scale=act)
    assert p.prepare_weights(wt, act_scale=act) is first
    y0 = p.apply(xt, p.prepare_weights(wt, act_scale=act))

    act[0].mul_(2.0)
    second = p.prepare_weights(wt, act_scale=act)
    assert second is not first
    assert torch.equal(second.subs[0].act_scale, act[0])
    # another sequence of the same tensors at the same versions hits
    assert p.prepare_weights(wt, act_scale=list(act)) is second

    wt.mul_(0.5)
    third = p.prepare_weights(wt, act_scale=act)
    assert third is not second
    want = p.prepare_weights(wt.clone(), act_scale=tuple(
        None if a is None else a.clone() for a in act))
    for got_sub, want_sub in zip(third.subs, want.subs):
        if want_sub.wq is None:
            assert torch.equal(got_sub.w, want_sub.w)
        else:
            assert torch.equal(got_sub.wq, want_sub.wq)
    assert not torch.equal(p.apply(xt, third), y0)


def test_grouped_apply_with_the_same_weights_prepares_once(monkeypatch):
    spec = ConvSpec.for_conv2d((1, 10, 9, 64), (3, 3, 2, 64), groups=32,
                               quant=FP32)
    p = plan(spec, backend="cuda", algo="sfc6_6")
    assert p.path == "lowered" and len(p.sub_plans) == 32
    calls = []
    original = ConvPlan._prepare_uncached

    def counting(self, *args):
        calls.append(1)
        return original(self, *args)

    monkeypatch.setattr(ConvPlan, "_prepare_uncached", counting)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 10, 9, 64).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 2, 64).astype(np.float32))
    y = p.apply(x, w)
    assert len(calls) == 32
    assert torch.equal(p.apply(x, w), y)
    assert len(calls) == 32
