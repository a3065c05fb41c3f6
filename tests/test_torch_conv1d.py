"""The port's rank-1 depthwise causal conv (the Mamba2 short conv) against
the JAX package's.

The same numpy inputs go through ``repro.core.conv2d``'s three rank-1
functions and ``repro_torch.core.conv2d``'s, for the one registered 4-tap
algorithm (``sfc6_6_r4``) and the three 2-tap ones on R = 2 weights, at
ragged lengths: within ``DEFAULT_TOL`` (1e-4, relative and absolute).
Then the API: ``plan -> prepare_weights -> apply`` on the ``reference``,
``cuda`` (CPU tensors) and ``cuda_spmd`` (a forced (2, 1) host mesh)
backends against the JAX ``reference`` backend, the ``cuda_spmd`` result
bit for bit the ``cuda`` one; SFC within 1e-4 of direct; the quantized
rank-1 spec raises as in the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import ConvSpec as JConvSpec  # noqa: E402
from repro.api import plan as jplan  # noqa: E402
from repro.core import conv2d as jc2d  # noqa: E402
from repro.quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch.api import ConvSpec, get_backend, plan, registry  # noqa: E402
from repro_torch.api import tuning  # noqa: E402
from repro_torch.core import conv2d as c2d  # noqa: E402
from repro_torch.launch.mesh import make_forced_host_mesh  # noqa: E402
from repro_torch.quant import INT8_FREQ  # noqa: E402
from repro_torch.testing import DEFAULT_TOL  # noqa: E402

ALGOS = [("sfc6_6_r4", 4), ("sfc4_4_r2", 2), ("sfc4_5_r2", 2),
         ("sfc6_7_r2", 2)]
LENGTHS = [1, 5, 37, 64]


@pytest.fixture(autouse=True)
def _isolated_port_tuning_cache(tmp_path):
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    yield
    tuning.set_cache_path(None)


@pytest.fixture
def spmd_2x1():
    backend = get_backend("cuda_spmd")
    backend.set_mesh(make_forced_host_mesh((2, 1), device="cpu"))
    yield backend
    backend.set_mesh(None)


def _data(T, R, C=24, B=2, seed=0):
    rng = np.random.RandomState(seed + 100 * T + R)
    return (rng.randn(B, T, C).astype(np.float32),
            (rng.randn(R, C) * 0.3).astype(np.float32))


def _close(got, want, tol=DEFAULT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("name,R", ALGOS)
def test_rank1_functions_match_jax(name, R, T):
    x, w = _data(T, R)
    algo = registry.get_algorithm(name)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y = c2d.fastconv1d_depthwise_causal(xt, wt, algo)
    assert y.shape == (2, T, 24)
    _close(y, jc2d.fastconv1d_depthwise_causal(jnp.asarray(x),
                                               jnp.asarray(w), algo))
    # the pretransformed form on the JAX package's own (t, C) weights
    tw = np.array(jnp.einsum("tr,rc->tc", jnp.asarray(algo.g(),
                                                        jnp.float32), w))
    _close(c2d.fastconv1d_depthwise_causal_pretransformed(
        xt, torch.from_numpy(tw), algo),
        jc2d.fastconv1d_depthwise_causal_pretransformed(
            jnp.asarray(x), jnp.asarray(tw), algo))
    direct = c2d.conv1d_depthwise_causal_direct(xt, wt)
    _close(direct, jc2d.conv1d_depthwise_causal_direct(jnp.asarray(x),
                                                       jnp.asarray(w)))
    # SFC against direct
    _close(y, direct)


def test_rank1_shape_mismatch_raises():
    x, w = _data(9, 2)
    algo = registry.get_algorithm("sfc6_6_r4")
    with pytest.raises(ValueError, match="R=4"):
        c2d.fastconv1d_depthwise_causal(torch.from_numpy(x),
                                        torch.from_numpy(w), algo)
    with pytest.raises(ValueError, match="t=12"):
        c2d.fastconv1d_depthwise_causal_pretransformed(
            torch.from_numpy(x), torch.zeros(11, 24), algo)


@pytest.mark.parametrize("algo", ["auto", "sfc6_6_r4", "direct"])
@pytest.mark.parametrize("backend", ["reference", "cuda", "cuda_spmd"])
def test_rank1_plan_apply_matches_jax(backend, algo, spmd_2x1):
    x, w = _data(37, 4, C=16)
    b = np.random.RandomState(5).randn(16).astype(np.float32)
    spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    p = plan(spec, backend=backend, algo=algo)
    assert p.algo_name == ("sfc6_6_r4" if algo == "auto" else algo)
    jspec = JConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    jp = jplan(jspec, algo=algo)
    wt = torch.from_numpy(w)
    prep = p.prepare_weights(wt)
    if p.algorithm is not None:
        _close(prep.tw, jp.prepare_weights(jnp.asarray(w)).tw)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    y = p.apply(xt, prep, bias=bt)
    _close(y, jp.apply(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b)))
    if backend == "cuda_spmd":
        one = plan(spec, backend="cuda", algo=algo)
        assert torch.equal(y, one.apply(xt, one.prepare_weights(wt),
                                        bias=bt))


def test_rank1_parity_port_of_test_api():
    """tests/test_api.py's test_conv1d_depthwise_parity on the port."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 37, 16).astype(np.float32))
    w = torch.from_numpy((rng.randn(4, 16) * 0.3).astype(np.float32))
    spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    p = plan(spec, algo="auto")
    assert p.algo_name == "sfc6_6_r4"
    y = p.apply(x, w)
    np.testing.assert_allclose(
        y.numpy(), c2d.conv1d_depthwise_causal_direct(x, w).numpy(),
        rtol=1e-5, atol=1e-5)
    # the cuda backend runs the same reference path for rank 1
    y_cuda = plan(spec, backend="cuda", algo="auto").apply(x, w)
    np.testing.assert_allclose(y.numpy(), y_cuda.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_rank1_sfc_matches_direct_at_mamba2_width():
    """mamba2-1.3b's conv channels (4352), a ragged length."""
    x, w = _data(37, 4, C=4352)
    spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y = plan(spec, algo="sfc6_6_r4").apply(xt, wt)
    _close(y, plan(spec, algo="direct").apply(xt, wt))


def _raised(fn):
    with pytest.raises(NotImplementedError) as err:
        fn()
    return str(err.value)


def test_quantized_rank1_raises_as_in_jax():
    x, w = _data(16, 4)
    spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape, quant=INT8_FREQ)
    jspec = JConvSpec.for_conv1d_depthwise(x.shape, w.shape,
                                           quant=JINT8_FREQ)
    p = plan(spec, algo="sfc6_6_r4")
    jp = jplan(jspec, algo="sfc6_6_r4")
    msg = _raised(lambda: p.prepare_weights(torch.from_numpy(w)))
    assert msg == _raised(lambda: jp.prepare_weights(jnp.asarray(w)))
    assert "quantized rank-1" in msg


def test_rank1_hook_raises_as_in_jax():
    x, w = _data(16, 4)
    spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    jspec = JConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    hook = lambda tx, tw: (tx, tw)                        # noqa: E731
    msg = _raised(lambda: plan(spec, algo="sfc6_6_r4").apply(
        torch.from_numpy(x), torch.from_numpy(w), elementwise_hook=hook))
    assert msg == _raised(lambda: jplan(jspec, algo="sfc6_6_r4").apply(
        jnp.asarray(x), jnp.asarray(w), elementwise_hook=hook))
