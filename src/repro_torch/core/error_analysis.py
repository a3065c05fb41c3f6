"""Numerical error analysis of fast convolution algorithms (paper §5).

Reproduces Table 1:
  * condition numbers kappa(A^T) — reported in two documented conventions,
    since the paper does not pin the normalization:
      - 'tile'   : spectral condition number (sigma_max/sigma_min) of the
                   M x t output transform actually applied per tile;
      - 'square' : the overlapped/square form the paper derives Eq. 12-16
                   with (full slot-space inverse operator).
  * empirical MSE of each algorithm under a quantized element-wise product
    (operands rounded to a low-precision format before multiplying, the
    transforms assumed exact — exactly the paper's error model, Eq. 13),
    normalized so that direct convolution == 1.0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.generator import (BilinearAlgorithm, direct_algorithm,
                                  paper_algorithms)


def kappa_tile(algo: BilinearAlgorithm) -> float:
    s = np.linalg.svd(algo.at(), compute_uv=False)
    return float(s.max() / s.min())


def kappa_square(algo: BilinearAlgorithm) -> float:
    """Condition number of the square/overlapped inverse operator.

    For the tile algorithms we use the full component->output operator
    padded to its row space: kappa over nonzero singular values of A^T.
    """
    s = np.linalg.svd(algo.at(), compute_uv=False)
    s = s[s > 1e-12 * s.max()]
    return float(s.max() / s.min())


def amplification(algo: BilinearAlgorithm) -> float:
    """Analytic error-amplification factor of the bilinear algorithm.

    With unit-variance inputs and relative elementwise rounding eps,
    E||dy||^2 ~ eps^2 * sum_m sum_i A[m,i]^2 ||b_i||^2 ||g_i||^2.
    Normalized by the same quantity for direct convolution, this is the
    predictor the paper's kappa(A^T) stands in for (and it is provably
    monotone in the observed MSE — tested).  1-D form; 2-D squares it.
    """
    at, bt, g = algo.at(), algo.bt(), algo.g()
    bn = np.sum(bt ** 2, axis=1)
    gn = np.sum(g ** 2, axis=1)
    amp = np.sum((at ** 2) * bn[None, :] * gn[None, :]) / algo.M
    direct = algo.R  # direct conv: R unit components per output
    return float(np.sqrt(amp / direct))


def _round_to(x: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "fp16":
        return x.astype(np.float16).astype(np.float64)
    if fmt == "fp32":
        return x.astype(np.float32).astype(np.float64)
    if fmt.startswith("int"):
        bits = int(fmt[3:])
        qmax = 2 ** (bits - 1) - 1
        scale = np.max(np.abs(x)) / qmax + 1e-30
        return np.clip(np.round(x / scale), -qmax, qmax) * scale
    raise ValueError(fmt)


def simulate_mse(algo: BilinearAlgorithm, *, fmt: str = "fp16",
                 trials: int = 256, rng: Optional[np.random.RandomState] = None,
                 per_frequency: bool = False) -> float:
    """Empirical 2-D output MSE with a quantized element-wise product.

    Error model of paper Eq. 13: transforms exact (fp64), the two operands
    of the transform-domain product are rounded to ``fmt``; the product error
    is then amplified by A^T.  ``per_frequency=True`` applies one scale per
    transform-domain coordinate (the paper's frequency-wise quantization) —
    only meaningful for intN formats.
    """
    rng = rng or np.random.RandomState(0)
    bt, g, at = algo.bt(), algo.g(), algo.at()
    # Balanced per-component scaling: for floating formats this is
    # scale-invariant (each operand has its own exponent) but prevents fp16
    # overflow for ill-scaled Winograd components; the product is invariant.
    bn = np.linalg.norm(bt, axis=1)
    gn = np.linalg.norm(g, axis=1)
    c = np.sqrt(gn / np.maximum(bn, 1e-30))
    bt = bt * c[:, None]
    g = g / c[:, None]
    errs = []
    tiles_per_trial = 16 if per_frequency else 1
    for _ in range(trials):
        x = rng.randn(tiles_per_trial, algo.L, algo.L)
        w = rng.randn(algo.R, algo.R)
        tx = np.einsum("ti,nij,uj->ntu", bt, x, bt)
        tw = g @ w @ g.T
        exact = np.einsum("mt,ntu,pu->nmp", at, tx * tw[None], at)
        if per_frequency and fmt.startswith("int"):
            # one scale per transform-domain coordinate, shared across the
            # tile batch (paper Eq. 17: s_Tx has shape [T x T])
            bits = int(fmt[3:])
            qmax = 2 ** (bits - 1) - 1
            sx = np.max(np.abs(tx), axis=0) / qmax + 1e-30
            qx = np.clip(np.round(tx / sx), -qmax, qmax) * sx
            sw = np.abs(tw) / qmax + 1e-30
            qw = np.clip(np.round(tw / sw), -qmax, qmax) * sw
        else:
            qx = _round_to(tx, fmt)
            qw = _round_to(tw, fmt)
        approx = np.einsum("mt,ntu,pu->nmp", at, qx * qw[None], at)
        errs.append(np.mean((approx - exact) ** 2))
    return float(np.mean(errs))


def table1(fmt: str = "fp16", trials: int = 256) -> Dict[str, Dict]:
    """Assemble the paper's Table 1 (plus our measured columns)."""
    algos = paper_algorithms()
    # Normalize by direct convolution of the SAME kernel size: the paper's
    # Wino(2x2,5x5) == Wino(4x4,3x3) MSE equality is the fingerprint of this
    # convention (both share N=6 and the same root points).
    base = {R: simulate_mse(direct_algorithm(R), fmt=fmt, trials=trials)
            for R in (3, 5, 7)}
    out = {}
    paper_vals = {   # (MSE, kappa, complexity%) from paper Table 1
        "direct(3x3)": (1.0, 1.0, 100.0),
        "Wino(2x2,3x3)": (2.2, 2.4, 44.4),
        "Wino(3x3,3x3)": (6.4, 14.5, 30.4),
        "Wino(4x4,3x3)": (10.5, 20.1, 25.0),
        "Wino(2x2,5x5)": (10.5, 20.1, 36.0),
        "Wino(2x2,7x7)": (28.1, 31.0, 32.6),
        "SFC-4(4x4,3x3)": (2.4, 2.7, 31.94),
        "SFC-6(6x6,3x3)": (2.4, 3.3, 27.16),
        "SFC-6(7x7,3x3)": (2.6, 3.4, 29.93),
        "SFC-6(6x6,5x5)": (3.6, 3.5, 20.44),
        "SFC-6(4x4,7x7)": (3.6, 3.5, 21.99),
    }
    for name, algo in algos.items():
        mse = simulate_mse(algo, fmt=fmt, trials=trials) / base[algo.R]
        # full-2D-Hermitian multiplication count (paper's second figure:
        # 49->46, 100->88, 144->132, 196->184): each (complex x complex)
        # frequency pair saves 3 mults relative to the separable form.
        ncc = _n_complex_freqs(algo)
        mults_hermitian = algo.mults_2d - 3 * ncc * ncc
        out[name] = {
            "mse": mse,
            "kappa_tile": kappa_tile(algo),
            "amplification": amplification(algo),
            "mults_2d": algo.mults_2d,
            "mults_2d_hermitian": mults_hermitian,
            "complexity_pct": 100.0 * algo.arithmetic_complexity_2d,
            "complexity_pct_hermitian":
                100.0 * mults_hermitian / (algo.M ** 2 * algo.R ** 2),
            "integer_transform": algo.is_integer_transform(),
            "paper": paper_vals.get(name),
        }
    return out


def _n_complex_freqs(algo: BilinearAlgorithm) -> int:
    if algo.kind != "sfc":
        return 0
    meta = dict(algo.meta)
    N = meta["N"]
    return max(0, (N - 1) // 2 if N % 2 else N // 2 - 1)


@dataclasses.dataclass
class ErrorBound:
    """kappa(A^T) * relative elementwise error (paper Eq. 16)."""

    kappa: float
    rel_elementwise: float

    @property
    def rel_output_bound(self) -> float:
        return self.kappa * self.rel_elementwise
