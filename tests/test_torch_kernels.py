"""The port's kernel wrappers (plain versions on CPU tensors) against the
JAX package's Pallas kernels in interpret mode.

On the card each wrapper launches its CUDA kernel instead; ``chip_smoke.py``
holds those kernels against these same plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.api import ConvSpec as JConvSpec  # noqa: E402
from repro.api import plan as jplan  # noqa: E402
from repro.api import registry as jregistry  # noqa: E402
from repro.api import tuning as jtuning  # noqa: E402
from repro.core import conv2d as jc2d  # noqa: E402
from repro.kernels.sfc_inverse import sfc_inverse as jsfc_inverse  # noqa: E402
from repro.kernels.sfc_tdmm import tdmm_int8 as jtdmm_int8  # noqa: E402
from repro.kernels.sfc_tdmm import \
    tdmm_int8_depthwise as jtdmm_int8_depthwise  # noqa: E402
from repro.kernels.sfc_transform import sfc_transform as jsfc_transform  # noqa: E402
from repro.kernels.sfc_transform import \
    sfc_transform_quantize as jsfc_transform_quantize  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.core import conv2d as c2d  # noqa: E402
from repro_torch.interop import prepared_from_jax  # noqa: E402
from repro_torch.kernels import (ops, quantized_fastconv2d,  # noqa: E402
                                 quantized_fastconv2d_depthwise,
                                 sfc_fused_conv2d, sfc_fused_conv2d_depthwise,
                                 sfc_inverse, sfc_transform,
                                 sfc_transform_quantize,
                                 sfc_transform_quantize_pt, tdmm_int8,
                                 tdmm_int8_depthwise)

ALGOS = ("sfc4_4", "sfc6_6", "sfc6_7")
PADDINGS = ("SAME", "VALID")
# a ragged 13x11 image, batch 2, C_in not a multiple of any block
X_SHAPE = (2, 13, 11, 5)
COUT = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snapped(rng, shape):
    """Multiples of 1/16: B^T X B is exact in f32 in any summation order."""
    return (np.round(rng.randn(*shape) * 16) / 16).astype(np.float32)


def _act_scale(x, name, padding):
    return np.array(jtuning.calibrate_act_scale(
        jnp.asarray(x), jregistry.get_algorithm(name), JINT8_FREQ, padding))


def _b1_pair(x, name, padding, pt=False):
    """(port B1 output, JAX B1 output) on the same input and scales; with
    ``pt``, the port's (P, T, C) entry and the JAX output transposed to
    (P, T, C)."""
    algo, jalgo = registry.get_algorithm(name), jregistry.get_algorithm(name)
    s = _act_scale(x, name, padding)
    bt = c2d.transform_matrices(algo, device="cpu")[0]
    entry = sfc_transform_quantize_pt if pt else sfc_transform_quantize
    mine = entry(torch.from_numpy(x), bt, torch.from_numpy(s), algo.M,
                 padding=padding)
    tiles, _ = jops.extract_tiles(jnp.asarray(x), jalgo, padding)
    jbt = jc2d.transform_matrices(jalgo, "float32")[0]
    theirs = np.asarray(jsfc_transform_quantize(tiles, jbt, jnp.asarray(s),
                                                interpret=True))
    if pt:
        T, t, _, C = theirs.shape
        theirs = theirs.reshape(T, t * t, C).transpose(1, 0, 2)
    return mine.numpy(), theirs


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_b1_exact_on_snapped_inputs(name, padding):
    mine, theirs = _b1_pair(_snapped(np.random.RandomState(0), X_SHAPE),
                            name, padding)
    assert mine.dtype == np.int8 and mine.shape == theirs.shape
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("name", ALGOS)
def test_b1_flips_bounded_on_random_inputs(name):
    x = np.random.RandomState(1).randn(*X_SHAPE).astype(np.float32)
    mine, theirs = _b1_pair(x, name, "SAME")
    diff = mine.astype(np.int32) - theirs.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= max(1, diff.size // 10000)


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_b1_pt_entry_exact_on_snapped_inputs(name, padding):
    # the (P, T, C) entry the staged paths call: the JAX kernel's output,
    # position-major
    mine, theirs = _b1_pair(_snapped(np.random.RandomState(0), X_SHAPE),
                            name, padding, pt=True)
    assert mine.dtype == np.int8 and mine.shape == theirs.shape
    assert mine.shape[0] == registry.get_algorithm(name).t ** 2
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("name", ALGOS)
def test_b1_pt_entry_flips_bounded_on_random_inputs(name):
    x = np.random.RandomState(1).randn(*X_SHAPE).astype(np.float32)
    mine, theirs = _b1_pair(x, name, "SAME", pt=True)
    diff = mine.astype(np.int32) - theirs.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= max(1, diff.size // 10000)


@pytest.mark.parametrize("name", ALGOS)
def test_compiled_bt_tables_are_the_registrys(name):
    # B1 and B5 compile B^T of sfc4_4, sfc6_6 and sfc6_7 into their row
    # pass (csrc/sfc_common.cuh, FixedBt): the tables must be the
    # generator's, and the JAX package's
    import pathlib
    import re
    src = (pathlib.Path(c2d.__file__).resolve().parents[1] / "csrc"
           / "sfc_common.cuh").read_text()
    algo = registry.get_algorithm(name)
    m = re.search(r"struct FixedBt<(\d+), (\d+)> \{\s*// " + name
                  + r"\b.*?= \{(.*?)\};", src, re.S)
    assert m is not None and (int(m[1]), int(m[2])) == (algo.t, algo.L)
    table = np.array([int(v) for v in m[3].replace(",", " ").split()],
                     dtype=np.float32).reshape(algo.t, algo.L)
    np.testing.assert_array_equal(table, np.asarray(algo.bt(), np.float32))
    np.testing.assert_array_equal(
        table, np.asarray(jc2d.transform_matrices(
            jregistry.get_algorithm(name), "float32")[0]))


def _rn32(x):
    """The float32 nearest the rational x, ties to even."""
    from fractions import Fraction
    c = np.float32(float(x))
    cands = [v for v in (np.nextafter(c, np.float32(-np.inf)), c,
                         np.nextafter(c, np.float32(np.inf)))
             if np.isfinite(v)]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.int32)) & 1))


def _quantize_by_reciprocal(tx, s, qmax=127):
    """csrc/sfc_common.cuh's quantize_by_reciprocal, each FP operation
    rounded once, as on the card (an FMA rounds a*b + c once)."""
    from fractions import Fraction as F
    y = np.float32(1) / s
    q0 = _rn32(F(float(tx)) * F(float(y)))

    def step(q):
        r = _rn32(-F(float(s)) * F(float(q)) + F(float(tx)))
        return _rn32(F(float(r)) * F(float(y)) + F(float(q)))
    q2 = step(step(q0))
    q = q2 if abs(q0) < 2.0 ** 64 else q0
    return int(np.clip(np.rint(q), -qmax, qmax))


def test_division_free_quantizer_is_the_ieee_division():
    # B1's compiled kernels quantize by the scale's reciprocal with two
    # correction steps, B4 and the JAX package by IEEE division: the int8
    # must agree everywhere, near the rounding ties above all
    from fractions import Fraction as F
    rng = np.random.RandomState(16)
    cases = []
    for _ in range(400):
        s = np.float32(np.exp(rng.uniform(np.log(1e-4), np.log(1e3))))
        cases += [(np.float32(v), s) for v in rng.randn(4) * 60 * s]
        # quotients within a few ulps of a half-integer
        k = rng.randint(-130, 130)
        mid = _rn32((F(k) + F(1, 2)) * F(float(s)))
        for d in range(-3, 4):
            v = mid
            for _ in range(abs(d)):
                v = np.nextafter(v, np.float32(np.inf if d > 0 else -np.inf))
            cases.append((np.float32(v), s))
        cases += [(np.float32(0.0), s), (np.float32(-0.0), s)]
    for tx, s in cases:
        want = int(np.clip(np.rint(tx / s), -127, 127))
        assert _quantize_by_reciprocal(tx, s) == want, (tx, s)


@pytest.mark.parametrize("k_block", [None, 2, 4])
def test_b2_exact_given_same_int8_operands(k_block):
    rng = np.random.RandomState(2)
    P, T, K, N = 16, 19, 9, 13
    xq = rng.randint(-127, 128, size=(P, T, K)).astype(np.int8)
    wq = rng.randint(-127, 128, size=(P, K, N)).astype(np.int8)
    sx = (rng.rand(P) * 0.1 + 1e-3).astype(np.float32)
    sw = (rng.rand(P, N) * 0.1 + 1e-3).astype(np.float32)
    mine = tdmm_int8(*map(torch.from_numpy, (xq, wq, sx, sw)),
                     k_block=k_block)
    theirs = jtdmm_int8(*map(jnp.asarray, (xq, wq, sx, sw)),
                        interpret=True, k_block=k_block)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("name", ALGOS)
def test_b3_agrees(name):
    algo = registry.get_algorithm(name)
    rng = np.random.RandomState(3)
    ty = rng.randn(11, algo.t, algo.t, 6).astype(np.float32)
    at = c2d.transform_matrices(algo, device="cpu")[2]
    mine = sfc_inverse(torch.from_numpy(ty), at)
    jat = jc2d.transform_matrices(jregistry.get_algorithm(name), "float32")[2]
    theirs = jsfc_inverse(jnp.asarray(ty), jat, interpret=True)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-5)


# B3's NHWC entry on a ragged 13x11 grid: O not a multiple of 32
B3_O = 37


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_b3_nhwc_entry_against_jax_inverse_and_untile(name, padding):
    # the plain version of sfc_inverse_nhwc, from the (P, T, O) layout of
    # B2's and B6's output, against the JAX kernel in interpret mode on
    # the (T, t, t, O) layout followed by the JAX package's untile
    algo, jalgo = registry.get_algorithm(name), jregistry.get_algorithm(name)
    B, H, W = X_SHAPE[:3]
    grid = c2d.tile_grid(H, W, algo.M, algo.R, padding)
    T, P = B * grid.nH * grid.nW, algo.t ** 2
    y = np.random.RandomState(13).randn(P, T, B3_O).astype(np.float32)
    at = c2d.transform_matrices(algo, device="cpu")[2]
    mine = kernels.sfc_inverse_nhwc(torch.from_numpy(y), at, grid)
    ty = np.ascontiguousarray(y.transpose(1, 0, 2)).reshape(
        T, algo.t, algo.t, B3_O)
    jat = jc2d.transform_matrices(jalgo, "float32")[2]
    theirs = jops.untile(jsfc_inverse(jnp.asarray(ty), jat, interpret=True),
                         jalgo, (B, grid.out_h, grid.out_w, grid.nH,
                                 grid.nW))
    assert mine.shape == theirs.shape == (B, grid.out_h, grid.out_w, B3_O)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-5)
    # the (T, t, t, O) layout gives the same values
    np.testing.assert_array_equal(
        kernels.sfc_inverse_nhwc(torch.from_numpy(ty), at, grid).numpy(),
        mine.numpy())


@pytest.mark.parametrize("name", ("wino2", "wino4", "sfc6_6_r4",
                                  "sfc6_7_r2"))
def test_b3_run_time_algorithms_agree(name):
    # algorithms whose (t, M) the kernel takes at run time: both entries'
    # plain versions against the JAX kernel in interpret mode (+ untile)
    algo, jalgo = registry.get_algorithm(name), jregistry.get_algorithm(name)
    B, H, W = X_SHAPE[:3]
    grid = c2d.tile_grid(H, W, algo.M, algo.R, "SAME")
    T = B * grid.nH * grid.nW
    ty = np.random.RandomState(14).randn(T, algo.t, algo.t, B3_O).astype(
        np.float32)
    at = c2d.transform_matrices(algo, device="cpu")[2]
    jat = jc2d.transform_matrices(jalgo, "float32")[2]
    theirs = jsfc_inverse(jnp.asarray(ty), jat, interpret=True)
    np.testing.assert_allclose(sfc_inverse(torch.from_numpy(ty), at).numpy(),
                               np.asarray(theirs), rtol=1e-5, atol=1e-5)
    y = np.ascontiguousarray(ty.reshape(T, -1, B3_O).transpose(1, 0, 2))
    np.testing.assert_allclose(
        kernels.sfc_inverse_nhwc(torch.from_numpy(y), at, grid).numpy(),
        np.asarray(jops.untile(theirs, jalgo, (B, grid.out_h, grid.out_w,
                                               grid.nH, grid.nW))),
        rtol=1e-5, atol=1e-5)


def _jax_prepared(x, w, name, padding):
    spec = JConvSpec.for_conv2d(x.shape, w.shape, padding=padding,
                                quant=JINT8_FREQ)
    p = jplan(spec, backend="reference", algo=name)
    return p.prepare_weights(jnp.asarray(w),
                             act_scale=_act_scale(x, name, padding))


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_b4_and_staged_against_jax_staged(name, padding):
    rng = np.random.RandomState(4)
    x = _snapped(rng, X_SHAPE)
    w = (rng.randn(3, 3, X_SHAPE[-1], COUT) * 0.3).astype(np.float32)
    jprep = _jax_prepared(x, w, name, padding)
    prep = prepared_from_jax(jprep, device="cpu")
    algo = registry.get_algorithm(name)
    want = np.asarray(jops.quantized_fastconv2d(
        jnp.asarray(x), jprep.wq, jprep.act_scale, jprep.w_scale,
        jregistry.get_algorithm(name), padding=padding, interpret=True))
    xt = torch.from_numpy(x)
    fused = sfc_fused_conv2d(xt, prep.wq, prep.act_scale, prep.w_scale, algo,
                             padding=padding)
    staged = quantized_fastconv2d(xt, prep.wq, prep.act_scale, prep.w_scale,
                                  algo, padding=padding, k_block=2)
    for got in (fused, staged):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_extract_tiles_and_untile_match_jax():
    x = np.random.RandomState(5).randn(*X_SHAPE).astype(np.float32)
    algo, jalgo = registry.get_algorithm("sfc6_6"), \
        jregistry.get_algorithm("sfc6_6")
    for padding in PADDINGS:
        tiles, geom = ops.extract_tiles(torch.from_numpy(x), algo, padding)
        jtiles, jgeom = jops.extract_tiles(jnp.asarray(x), jalgo, padding)
        assert geom == jgeom
        np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles))
        y = np.random.RandomState(6).randn(
            tiles.shape[0], algo.M, algo.M, 3).astype(np.float32)
        np.testing.assert_array_equal(
            ops.untile(torch.from_numpy(y), algo, geom).numpy(),
            np.asarray(jops.untile(jnp.asarray(y), jalgo, jgeom)))


def test_cpu_tensors_launch_nothing():
    kernels.reset_launch_counts()
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_snapped(rng, X_SHAPE))
    algo = registry.get_algorithm("sfc6_6")
    wq = torch.from_numpy(rng.randint(-127, 128, size=(
        algo.t ** 2, X_SHAPE[-1], COUT)).astype(np.int8))
    act = torch.full((algo.t, algo.t), 0.05)
    ws = torch.full((algo.t, algo.t, COUT), 0.01)
    quantized_fastconv2d(x, wq, act, ws, algo)
    sfc_fused_conv2d(x, wq, act, ws, algo)
    C = X_SHAPE[-1]
    wq_dw = torch.from_numpy(rng.randint(-127, 128, size=(
        algo.t ** 2, 1, C)).astype(np.int8))
    ws_dw = torch.full((algo.t, algo.t, C), 0.01)
    quantized_fastconv2d_depthwise(x, wq_dw, act, ws_dw, algo)
    sfc_fused_conv2d(x, wq_dw, act, ws_dw, algo, depthwise=True)
    ops.fastconv2d_fp(x, torch.ones(3, 3, C, COUT), algo)
    assert kernels.launch_counts() == {
        "sfc_transform_quantize": 0, "tdmm_int8": 0, "sfc_inverse": 0,
        "sfc_fused_conv2d": 0, "sfc_transform": 0, "tdmm_int8_depthwise": 0,
        "sfc_fused_conv2d_depthwise": 0}


def test_non_cpu_tensor_never_reaches_plain_version():
    # a tensor off the CPU goes to the kernel (which needs the card) or
    # raises; it is never computed by the plain version
    ty = torch.empty((4, 10, 10, 3), device="meta")
    at = torch.empty((6, 10), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        sfc_inverse(ty, at)
    with pytest.raises(ValueError, match="CUDA device"):
        sfc_inverse(ty, torch.zeros(6, 10))


def test_fused_rejects_unported_options_and_bad_blocks():
    algo = registry.get_algorithm("sfc6_6")
    x = torch.zeros(1, 12, 12, 4)
    wq = torch.zeros((100, 4, 8), dtype=torch.int8)
    act, ws = torch.ones(10, 10), torch.ones(10, 10, 8)
    # double_buffer is what B4 always does (its stages are fetched a
    # stage ahead): either value runs the same kernel, with the same bits
    g = torch.Generator().manual_seed(3)
    xr = torch.randn(1, 12, 12, 4, generator=g)
    wr = torch.randint(-127, 128, (100, 4, 8), generator=g,
                       dtype=torch.int8)
    assert torch.equal(
        sfc_fused_conv2d(xr, wr, act, ws, algo, double_buffer=True),
        sfc_fused_conv2d(xr, wr, act, ws, algo))
    with pytest.raises(ValueError, match="k_block must be 32 or 64"):
        sfc_fused_conv2d(x, wq, act, ws, algo, k_block=48)
    with pytest.raises(ValueError, match="cout_block 8 or 16"):
        sfc_fused_conv2d(x, wq, act, ws, algo, cout_block=12)
    with pytest.raises(ValueError, match="k_block must be 32 or 64"):
        sfc_fused_conv2d(x, wq, act, ws, algo, k_block=128, cout_block=128)
    # k_block 64 at cout_block 16 fits one weight stage of 8 tiles; a
    # cluster of 32 blocks fits no geometry
    with pytest.raises(ValueError, match="shared memory"):
        sfc_fused_conv2d(x, wq, act, ws, algo, n_share=16, k_split=2)
    # B4's geometry: C_out blocks sharing a transform and C_in slices are
    # powers of two, and a block holds one or two mma n-tiles of channels
    with pytest.raises(ValueError, match="n_share and k_split must be"):
        sfc_fused_conv2d(x, wq, act, ws, algo, n_share=0)
    with pytest.raises(ValueError, match="cout_block 8 or 16"):
        sfc_fused_conv2d(x, wq, act, ws, algo, cout_block=64)
    # depthwise (B7): the channel block must be positive and fit shared
    # memory; double_buffer runs B7 unchanged there too
    wq_dw, ws_dw = torch.zeros((100, 1, 4), dtype=torch.int8), \
        torch.ones(10, 10, 4)
    assert torch.equal(
        sfc_fused_conv2d(xr, wq_dw, act, ws_dw, algo, depthwise=True,
                         double_buffer=True),
        sfc_fused_conv2d(xr, wq_dw, act, ws_dw, algo, depthwise=True))
    with pytest.raises(ValueError, match="cout_block=0"):
        sfc_fused_conv2d(x, wq_dw, act, ws_dw, algo, depthwise=True,
                         cout_block=0)
    with pytest.raises(ValueError, match="cout_block=512 needs 592000 bytes"):
        sfc_fused_conv2d(x, wq_dw, act, ws_dw, algo, depthwise=True,
                         cout_block=512)
    with pytest.raises(ValueError, match="do not agree"):
        sfc_fused_conv2d(x, wq, act, ws, algo, depthwise=True)


@pytest.mark.parametrize("name", ALGOS)
def test_quantize_weights_and_oracle_match_jax(name):
    rng = np.random.RandomState(8)
    x = _snapped(rng, X_SHAPE)
    w = (rng.randn(3, 3, X_SHAPE[-1], COUT) * 0.3).astype(np.float32)
    algo, jalgo = registry.get_algorithm(name), jregistry.get_algorithm(name)
    act = _act_scale(x, name, "SAME")
    ws = (np.abs(rng.randn(algo.t, algo.t, COUT)) * 0.02 + 1e-3).astype(
        np.float32)
    wq = ops.quantize_weights(torch.from_numpy(w), algo, torch.from_numpy(ws))
    jwq = jops.quantize_weights(jnp.asarray(w), jalgo, jnp.asarray(ws))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    from repro.kernels import ref as jref
    mine = kernels.ref.quantized_fastconv2d_ref(
        torch.from_numpy(x), torch.from_numpy(w), algo, torch.from_numpy(act),
        torch.from_numpy(ws))
    theirs = jref.quantized_fastconv2d_ref(
        jnp.asarray(x), jnp.asarray(w), jalgo, jnp.asarray(act),
        jnp.asarray(ws))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-4,
                               atol=1e-4)


def _b5_pair(x, name, padding):
    """(port B5 output, JAX B5 output in interpret mode) on the same input."""
    algo, jalgo = registry.get_algorithm(name), jregistry.get_algorithm(name)
    bt = c2d.transform_matrices(algo, device="cpu")[0]
    mine = sfc_transform(torch.from_numpy(x), bt, algo.M, padding=padding)
    tiles, _ = jops.extract_tiles(jnp.asarray(x), jalgo, padding)
    jbt = jc2d.transform_matrices(jalgo, "float32")[0]
    return mine.numpy(), np.asarray(jsfc_transform(tiles, jbt,
                                                   interpret=True))


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_b5_exact_on_snapped_inputs(name, padding):
    # B^T X B of multiples of 1/16 is exact in f32 in any summation order
    mine, theirs = _b5_pair(_snapped(np.random.RandomState(9), X_SHAPE),
                            name, padding)
    assert mine.dtype == np.float32 and mine.shape == theirs.shape
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_b5_close_on_random_inputs(name, padding):
    # summation order differs: max |diff| <= 1e-6 of the output's max |value|
    x = np.random.RandomState(10).randn(*X_SHAPE).astype(np.float32)
    mine, theirs = _b5_pair(x, name, padding)
    assert mine.shape == theirs.shape
    assert np.abs(mine - theirs).max() <= 1e-6 * np.abs(theirs).max()


@pytest.mark.parametrize("P,T,C", [(16, 19, 13), (49, 7, 8), (100, 4, 32)])
def test_b6_exact_given_same_int8_operands(P, T, C):
    # int32 products and one dequant order: bit-exact
    rng = np.random.RandomState(11)
    xq = rng.randint(-127, 128, size=(P, T, C)).astype(np.int8)
    wq = rng.randint(-127, 128, size=(P, C)).astype(np.int8)
    sx = (rng.rand(P) * 0.1 + 1e-3).astype(np.float32)
    sw = (rng.rand(P, C) * 0.1 + 1e-3).astype(np.float32)
    mine = tdmm_int8_depthwise(*map(torch.from_numpy, (xq, wq, sx, sw)))
    theirs = jtdmm_int8_depthwise(*map(jnp.asarray, (xq, wq, sx, sw)),
                                  interpret=True)
    assert mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def _jax_prepared_depthwise(x, w, name, padding):
    spec = JConvSpec.for_conv2d_depthwise(x.shape, w.shape, padding=padding,
                                          quant=JINT8_FREQ)
    p = jplan(spec, backend="reference", algo=name)
    return p.prepare_weights(jnp.asarray(w),
                             act_scale=_act_scale(x, name, padding))


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_b7_and_staged_depthwise_against_jax_staged(name, padding):
    # the JAX fused depthwise kernel does not launch on this JAX (ROADMAP
    # C1): B7's plain version and the port's staged B1 -> B6 -> B3 are
    # held to the JAX staged depthwise pipeline, within 1e-4
    rng = np.random.RandomState(12)
    x = _snapped(rng, X_SHAPE)
    w = (rng.randn(3, 3, 1, X_SHAPE[-1]) * 0.3).astype(np.float32)
    jprep = _jax_prepared_depthwise(x, w, name, padding)
    prep = prepared_from_jax(jprep, device="cpu")
    algo = registry.get_algorithm(name)
    assert prep.wq.shape == (algo.t ** 2, 1, X_SHAPE[-1])
    want = np.asarray(jops.quantized_fastconv2d_depthwise(
        jnp.asarray(x), jprep.wq, jprep.act_scale, jprep.w_scale,
        jregistry.get_algorithm(name), padding=padding, interpret=True))
    xt = torch.from_numpy(x)
    args = (xt, prep.wq, prep.act_scale, prep.w_scale, algo)
    fused = sfc_fused_conv2d(*args, padding=padding, depthwise=True)
    staged = quantized_fastconv2d_depthwise(*args, padding=padding)
    assert torch.equal(fused, sfc_fused_conv2d_depthwise(
        *args, padding=padding, cout_block=3))
    for got in (fused, staged):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("name", ALGOS)
def test_fp_ops_path_against_jax(name, padding):
    # B5 -> f32 product -> B3 against the JAX fastconv2d_fp, within 1e-4
    rng = np.random.RandomState(13)
    x = rng.randn(*X_SHAPE).astype(np.float32)
    w = (rng.randn(3, 3, X_SHAPE[-1], COUT) * 0.3).astype(np.float32)
    algo = registry.get_algorithm(name)
    got = ops.fastconv2d_fp(torch.from_numpy(x), torch.from_numpy(w), algo,
                            padding=padding)
    want = np.asarray(jops.fastconv2d_fp(
        jnp.asarray(x), jnp.asarray(w), jregistry.get_algorithm(name),
        padding=padding, interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _cublas_fp32_setting():
    """The name of this PyTorch's cuBLAS float32 setting, and its values
    for TF32 and for IEEE float32."""
    matmul = torch.backends.cuda.matmul
    if hasattr(matmul, "fp32_precision"):
        return "fp32_precision", "tf32", "ieee"
    return "allow_tf32", True, False


@pytest.mark.parametrize("caller_tf32", (False, True))
def test_full_fp32_matmul_restores_the_callers_setting(caller_tf32):
    matmul = torch.backends.cuda.matmul
    name, tf32, ieee = _cublas_fp32_setting()
    before = getattr(matmul, name)
    try:
        setattr(matmul, name, tf32 if caller_tf32 else ieee)
        caller = getattr(matmul, name)
        with ops.full_fp32_matmul():
            assert getattr(matmul, name) == ieee
        assert getattr(matmul, name) == caller
    finally:
        setattr(matmul, name, before)


def _cudnn_fp32_setting():
    """This PyTorch's cuDNN float32 convolution setting: the object that
    holds it, its name, and its values for TF32 and for IEEE float32."""
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if hasattr(conv, "fp32_precision"):
        return conv, "fp32_precision", "tf32", "ieee"
    return cudnn, "allow_tf32", True, False


@pytest.mark.parametrize("caller_tf32", (False, True))
def test_full_fp32_conv_restores_the_callers_setting(caller_tf32):
    from repro_torch.core.precision import full_fp32_conv
    obj, name, tf32, ieee = _cudnn_fp32_setting()
    before = getattr(obj, name)
    try:
        setattr(obj, name, tf32 if caller_tf32 else ieee)
        caller = getattr(obj, name)
        with full_fp32_conv():
            assert getattr(obj, name) == ieee
        assert getattr(obj, name) == caller
        with pytest.raises(KeyError):
            with full_fp32_conv():
                raise KeyError("raised inside the guard")
        assert getattr(obj, name) == caller
    finally:
        setattr(obj, name, before)


@pytest.mark.parametrize("call", ("conv2d_direct", "transform_domain_matmul"))
def test_library_calls_run_inside_their_guards(call, monkeypatch):
    # the direct conv's F.conv2d sees cuDNN in IEEE float32, the reference
    # einsum sees cuBLAS in IEEE float32, whatever the caller set
    if call == "conv2d_direct":
        obj, name, tf32, ieee = _cudnn_fp32_setting()
        target, attr = torch.nn.functional, "conv2d"
    else:
        obj = torch.backends.cuda.matmul
        name, tf32, ieee = _cublas_fp32_setting()
        target, attr = torch, "einsum"
    library = getattr(target, attr)
    seen = []

    def observed(*args, **kwargs):
        seen.append(getattr(obj, name))
        return library(*args, **kwargs)

    monkeypatch.setattr(target, attr, observed)
    rng = np.random.RandomState(23)
    before = getattr(obj, name)
    try:
        setattr(obj, name, tf32)
        if call == "conv2d_direct":
            x = torch.from_numpy(rng.randn(1, 9, 9, 4).astype(np.float32))
            w = torch.from_numpy(rng.randn(3, 3, 4, 5).astype(np.float32))
            y = c2d.conv2d_direct(x, w, "SAME", stride=2)
            assert y.shape == (1, 5, 5, 5)
        else:
            tx = torch.from_numpy(rng.randn(1, 2, 2, 10, 10, 4).astype(
                np.float32))
            tw = torch.from_numpy(rng.randn(10, 10, 4, 5).astype(np.float32))
            y = c2d.transform_domain_matmul(tx, tw)
            assert y.shape == (1, 2, 2, 10, 10, 5)
        assert seen == [ieee]
        assert getattr(obj, name) == tf32
    finally:
        setattr(obj, name, before)


@pytest.mark.parametrize("call", ["conv2d_direct", "fastconv2d"])
def test_backward_library_calls_run_inside_their_guards(call, monkeypatch):
    # autograd enqueues the backward after the forward's guard has closed:
    # the direct conv's data and weight gradients still see cuDNN in IEEE
    # float32, and every einsum of the sfc path's backward (the inverse,
    # the product's two operands, the weight and input transforms) cuBLAS
    if call == "conv2d_direct":
        obj, name, tf32, ieee = _cudnn_fp32_setting()
        target, attr = torch.ops.aten, "convolution_backward"
    else:
        obj = torch.backends.cuda.matmul
        name, tf32, ieee = _cublas_fp32_setting()
        target, attr = torch, "einsum"
    library = getattr(target, attr)
    seen = []

    def observed(*args, **kwargs):
        seen.append(getattr(obj, name))
        return library(*args, **kwargs)

    monkeypatch.setattr(target, attr, observed)
    rng = np.random.RandomState(29)
    x = torch.from_numpy(rng.randn(2, 9, 9, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 4, 5).astype(np.float32))
    x.requires_grad_()
    w.requires_grad_()
    before = getattr(obj, name)
    try:
        setattr(obj, name, tf32)
        if call == "conv2d_direct":
            y = c2d.conv2d_direct(x, w, "SAME", stride=2)
        else:
            y = c2d.fastconv2d(x, w, registry.get_algorithm("sfc6_6"))
        seen.clear()
        y.square().sum().backward()
        assert seen == [ieee] * (1 if call == "conv2d_direct" else 5)
        assert getattr(obj, name) == tf32
        assert x.grad is not None and w.grad is not None
    finally:
        setattr(obj, name, before)


@pytest.mark.parametrize("r,stride,groups", [(1, 1, 1), (3, 1, 1),
                                             (3, 2, 1), (1, 2, 1),
                                             (3, 1, 2)],
                         ids=["1x1", "3x3", "3x3/2", "1x1/2", "groups2"])
def test_conv2d_direct_gradients_match_jax_grad(r, stride, groups):
    """The direct conv's data and weight gradients (its guarded backward)
    within DEFAULT_TOL of the largest of jax.grad's, at batch 4 (where
    PyTorch's CPU weight gradient of a channels-last 1x1/2 conv fails)."""
    import jax
    from repro_torch.testing import DEFAULT_TOL
    rng = np.random.RandomState(31)
    x = rng.randn(4, 16, 16, 8).astype(np.float32)
    w = rng.randn(r, r, 8 // groups, 6).astype(np.float32)
    out = -(-16 // stride)
    gy = rng.randn(4, out, out, 6).astype(np.float32)

    def jloss(xj, wj):
        y = jax.lax.conv_general_dilated(
            xj, wj, (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups)
        return jnp.sum(y * gy)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = c2d.conv2d_direct(xt, wt, "SAME", stride=stride, groups=groups)
    assert y.shape == gy.shape
    (y * torch.from_numpy(gy)).sum().backward()
    for got, want in ((xt.grad, jgx), (wt.grad, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=DEFAULT_TOL * np.abs(want).max())


def test_sfc_reference_plan_gradients_match_jax_grad():
    """A sfc6_6 reference plan's gradients of input, weights and bias (the
    guarded transforms and product) against jax.grad of the JAX plan."""
    import jax

    from repro_torch.api import ConvSpec, plan
    from repro_torch.testing import DEFAULT_TOL
    rng = np.random.RandomState(37)
    x = rng.randn(2, 13, 11, 6).astype(np.float32)
    w = rng.randn(3, 3, 6, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    gy = rng.randn(2, 13, 11, 7).astype(np.float32)
    jp = jplan(JConvSpec.for_conv2d(x.shape, w.shape), algo="sfc6_6")
    want = jax.grad(lambda xj, wj, bj: jnp.sum(jp.apply(xj, wj, bias=bj)
                                               * gy), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    p = plan(ConvSpec.for_conv2d(x.shape, w.shape), backend="reference",
             algo="sfc6_6")
    assert p.path == "fast"
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    (p.apply(ts[0], ts[1], bias=ts[2]) * torch.from_numpy(gy)).sum(
        ).backward()
    for t, jg in zip(ts, want):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0,
                                   atol=DEFAULT_TOL * np.abs(jg).max())


def test_full_fp32_matmul_serialises_threads():
    # a second thread waits at the guard until the first has left it, so
    # neither can restore the caller's TF32 setting inside the other's block
    import threading
    matmul = torch.backends.cuda.matmul
    name, tf32, ieee = _cublas_fp32_setting()
    before = getattr(matmul, name)
    inside, release, second_in = (threading.Event(), threading.Event(),
                                  threading.Event())
    seen = []

    def first():
        with ops.full_fp32_matmul():
            inside.set()
            release.wait(10)
            seen.append(getattr(matmul, name))

    def second():
        inside.wait(10)
        with ops.full_fp32_matmul():
            second_in.set()
            seen.append(getattr(matmul, name))

    try:
        setattr(matmul, name, tf32)
        threads = [threading.Thread(target=f) for f in (first, second)]
        for th in threads:
            th.start()
        assert inside.wait(10)
        assert not second_in.wait(0.2)
        release.set()
        for th in threads:
            th.join(10)
        assert second_in.is_set()
        assert seen == [ieee, ieee]
        assert getattr(matmul, name) == tf32
    finally:
        release.set()
        setattr(matmul, name, before)
