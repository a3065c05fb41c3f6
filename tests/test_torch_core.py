"""The port's core (generators, conv2d) against the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import registry as jregistry  # noqa: E402
from repro.core import conv2d as jc2d  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.core import conv2d as c2d  # noqa: E402

ALGOS = ("sfc4_4", "sfc6_6", "sfc6_7")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _snapped(rng, shape):
    """Multiples of 1/16: the additions-only transforms are exact on them."""
    return (np.round(rng.randn(*shape) * 16) / 16).astype(np.float32)


@pytest.mark.parametrize("name", registry.list_algorithms(
    include_direct=False))
def test_matrices_fraction_equal(name):
    mine, theirs = registry.get_algorithm(name), jregistry.get_algorithm(name)
    assert (mine.BT, mine.G, mine.AT) == (theirs.BT, theirs.G, theirs.AT)
    assert (mine.M, mine.R, mine.t, mine.kind) == \
        (theirs.M, theirs.R, theirs.t, theirs.kind)


def test_registry_names_match():
    assert registry.list_algorithms() == jregistry.list_algorithms()


def test_pad_amounts_equal():
    for size in (1, 3, 7, 11, 13, 14, 56, 224):
        for M, R in ((2, 3), (4, 3), (6, 3), (7, 3), (6, 4), (5, 2)):
            for padding in ("SAME", "VALID"):
                if padding == "VALID" and size < R:
                    continue
                assert c2d.pad_amounts(size, M, R, padding) == \
                    jc2d.pad_amounts(size, M, R, padding)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("name", ALGOS)
def test_conv2d_stages_agree(name, padding):
    rng = np.random.RandomState(0)
    algo, jalgo = registry.get_algorithm(name), jregistry.get_algorithm(name)
    x = _snapped(rng, (2, 13, 11, 5))
    w = (rng.randn(3, 3, 5, 7) * 0.2).astype(np.float32)
    tx, geom = c2d.transform_input_2d(_t(x), algo, padding)
    jtx, jgeom = jc2d.transform_input_2d(jnp.asarray(x), jalgo, padding)
    assert geom == jgeom
    np.testing.assert_allclose(tx.numpy(), np.asarray(jtx), rtol=1e-5,
                               atol=1e-5)
    tw = c2d.transform_weights_2d(_t(w), algo)
    jtw = jc2d.transform_weights_2d(jnp.asarray(w), jalgo)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jtw), rtol=1e-5,
                               atol=1e-5)
    ty = c2d.transform_domain_matmul(tx, tw)
    jty = jc2d.transform_domain_matmul(jtx, jtw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jty), rtol=1e-5,
                               atol=1e-5)
    y = c2d.inverse_transform_2d(ty, algo, geom)
    jy = jc2d.inverse_transform_2d(jty, jalgo, jgeom)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    b = (rng.randn(7) * 0.1).astype(np.float32)
    yf = c2d.fastconv2d(_t(x), _t(w), algo, padding, bias=_t(b))
    jyf = jc2d.fastconv2d(jnp.asarray(x), jnp.asarray(w), jalgo, padding,
                          bias=jnp.asarray(b))
    np.testing.assert_allclose(yf.numpy(), np.asarray(jyf), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_direct_agrees(padding):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 13, 11, 5).astype(np.float32)
    w = rng.randn(3, 3, 5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    y = c2d.conv2d_direct(_t(x), _t(w), padding, bias=_t(b))
    jy = jc2d.conv2d_direct(jnp.asarray(x), jnp.asarray(w), padding,
                            bias=jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_same_pads_matches_lax_strided():
    for size in (7, 8, 13, 224):
        for R, stride in ((3, 1), (3, 2), (7, 2), (1, 2)):
            lo, hi = c2d.same_pads(size, R, stride)
            out = (size + lo + hi - R) // stride + 1
            assert out == -(-size // stride)
