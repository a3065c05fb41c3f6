"""The rest of the port's ``core``: the error analysis of Table 1, the 2-D
Hermitian generator behind the 3.68x claim and iterative SFC for large
kernels (Appendix B), against the JAX package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.error_analysis as jea  # noqa: E402
import repro.core.generator as jgen  # noqa: E402
import repro.core.generator2d as jgen2d  # noqa: E402
import repro.core.iterative as jit  # noqa: E402

import repro_torch.core as core  # noqa: E402
from repro_torch.core import error_analysis as ea  # noqa: E402
from repro_torch.core import generator as gen  # noqa: E402
from repro_torch.core import generator2d as gen2d  # noqa: E402
from repro_torch.core import iterative  # noqa: E402


def test_table1_equals_jax():
    """Every row and column of Table 1 (numpy on both sides, the same
    seeds): equal, the paper's reference values included."""
    mine, theirs = ea.table1(trials=24), jea.table1(trials=24)
    assert mine == theirs
    assert mine["SFC-6(6x6,3x3)"]["mults_2d_hermitian"] == 88


@pytest.mark.parametrize("name", sorted(gen.paper_algorithms()))
def test_conditioning_equals_jax(name):
    algo, jalgo = gen.paper_algorithms()[name], jgen.paper_algorithms()[name]
    for fn in ("kappa_tile", "kappa_square", "amplification"):
        assert getattr(ea, fn)(algo) == getattr(jea, fn)(jalgo), fn


@pytest.mark.parametrize("fmt,per_frequency", [("fp16", False),
                                               ("int8", False),
                                               ("int6", True)])
def test_simulate_mse_equals_jax(fmt, per_frequency):
    algo = gen.paper_algorithms()["SFC-6(6x6,3x3)"]
    jalgo = jgen.paper_algorithms()["SFC-6(6x6,3x3)"]
    assert ea.simulate_mse(algo, fmt=fmt, trials=16,
                           per_frequency=per_frequency) == \
        jea.simulate_mse(jalgo, fmt=fmt, trials=16,
                         per_frequency=per_frequency)


def test_error_bound():
    b, jb = ea.ErrorBound(3.3, 0.01), jea.ErrorBound(3.3, 0.01)
    assert b.rel_output_bound == jb.rel_output_bound == pytest.approx(0.033)


@pytest.mark.parametrize("nmr,expected_t", [
    ((4, 4, 3), 46), ((6, 6, 3), 88), ((6, 7, 3), 132), ((6, 6, 5), 184)])
def test_hermitian_generator_equals_jax(nmr, expected_t):
    """The 2-D Hermitian algorithms: the same exact Fractions."""
    algo, jalgo = gen2d.generate_sfc_2d_hermitian(*nmr), \
        jgen2d.generate_sfc_2d_hermitian(*nmr)
    assert algo.t == jalgo.t == expected_t
    assert (algo.name, algo.M, algo.R, algo.L) == \
        (jalgo.name, jalgo.M, jalgo.R, jalgo.L)
    assert algo.BT == jalgo.BT and algo.G == jalgo.G and algo.AT == jalgo.AT


def test_headline_368x_equals_jax():
    algo = core.generate_sfc_2d_hermitian(6, 6, 3)
    jalgo = jgen2d.generate_sfc_2d_hermitian(6, 6, 3)
    direct = algo.M ** 2 * algo.R ** 2
    assert direct / algo.t == direct / jalgo.t == pytest.approx(3.6818,
                                                                abs=1e-3)


# benchmarks/appendixB_iterative.py's (kernel, inner, outer) pairs
PAIRS = [(30, (6, 5, 5), (6, 6, 6)), (9, (4, 3, 3), (6, 7, 3)),
         (24, (6, 4, 4), (6, 6, 6))]


@pytest.mark.parametrize("ksize,inner,outer", PAIRS)
def test_iterative_matches_jax(ksize, inner, outer):
    """iterative_conv1d within 1e-5 of the JAX package's on the same
    inputs, and within 1e-3 of the direct correlation (the script's
    bound); large_kernel_report and the mult count equal."""
    i, o = gen.generate_sfc(*inner), gen.generate_sfc(*outer)
    ji, jo = jgen.generate_sfc(*inner), jgen.generate_sfc(*outer)
    assert iterative.large_kernel_report(ksize, i, o) == \
        jit.large_kernel_report(ksize, ji, jo)
    for two_d in (True, False):
        assert iterative.iterative_mult_count(o, i, two_d) == \
            jit.iterative_mult_count(jo, ji, two_d)
    rng = np.random.RandomState(0)
    Rw, Mt = i.R * o.R, i.M * o.M
    x = rng.randn(Mt + Rw - 1).astype(np.float32)
    w = rng.randn(Rw).astype(np.float32)
    y = iterative.iterative_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                   i, o)
    jy = np.asarray(jit.iterative_conv1d(jnp.asarray(x), jnp.asarray(w),
                                         ji, jo))
    assert y.shape == (Mt,) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
    ref = np.array([(x[m:m + Rw] * w).sum() for m in range(Mt)])
    assert np.abs(y.numpy() - ref).max() < 1e-3


def test_iterative_needs_aligned_inner_tiles():
    inner, outer = gen.generate_sfc(6, 6, 3), gen.generate_sfc(6, 6, 6)
    with pytest.raises(ValueError, match="inner.R == inner.M"):
        iterative.iterative_conv1d(torch.zeros(1), torch.zeros(1), inner,
                                   outer)
