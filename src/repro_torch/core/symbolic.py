"""Symbolic arithmetic for SFC (Symbolic Fourier Convolution).

The paper's key observation: for DFT point counts N whose primitive root of
unity has cyclotomic degree <= 2 (N in {1, 2, 3, 4, 6}), every N-th root of
unity is an *integer* first-order polynomial ``a + b*s`` in one symbol ``s``,
with the quadratic reduction rule ``s^2 = alpha*s + beta`` (integer alpha,
beta). The DFT of a real sequence therefore needs only additions, and the
element-wise product in the transform domain is a polynomial product that
reduces to 3 real multiplications (a Karatsuba step, paper Eqs. 8/10).

Everything here is exact: integer root tables and `fractions.Fraction`
inverse-transform coefficients.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Sequence, Tuple

# N -> (alpha, beta, Re(s)) with s = primitive N-th root of unity e^{2*pi*j/N}
# and reduction s^2 = alpha*s + beta.
_RING_TABLE = {
    1: (0, 1, Fraction(1)),            # s = 1 (degenerate, never used)
    2: (0, 1, Fraction(-1)),           # s = -1: s^2 = 1
    3: (-1, -1, Fraction(-1, 2)),      # s = e^{2pi j/3}: s^2 = -s - 1
    4: (0, -1, Fraction(0)),           # s = j: s^2 = -1
    6: (1, -1, Fraction(1, 2)),        # s = e^{j pi/3}: s^2 = s - 1
}

SUPPORTED_DFT_POINTS = tuple(sorted(_RING_TABLE))


@dataclasses.dataclass(frozen=True)
class CyclotomicRing:
    """Z[s]/(s^2 - alpha*s - beta) with s a primitive N-th root of unity."""

    N: int
    alpha: int
    beta: int
    re_s: Fraction  # real part of s, needed only for the inverse transform

    @classmethod
    def for_points(cls, N: int) -> "CyclotomicRing":
        if N not in _RING_TABLE:
            raise ValueError(
                f"DFT-{N} has irrational-free symbolic form only for "
                f"N in {SUPPORTED_DFT_POINTS}; got N={N}. (Higher N needs "
                "higher-order polynomial terms, see paper App. B.)")
        a, b, re = _RING_TABLE[N]
        return cls(N=N, alpha=a, beta=b, re_s=re)

    def root_power(self, k: int) -> Tuple[int, int]:
        """omega^k = a + b*s with integer a, b (omega = s, the generator)."""
        k = k % self.N
        if self.N <= 2:              # degenerate rings: s is real (+-1)
            return ((-1) ** k if self.N == 2 else 1, 0)
        a, b = 1, 0  # s^0
        for _ in range(k):
            # (a + b s) * s = a s + b s^2 = (b*beta) + (a + b*alpha) s
            a, b = b * self.beta, a + b * self.alpha
        return a, b

    def mul(self, p: Tuple[Fraction, Fraction],
            q: Tuple[Fraction, Fraction]) -> Tuple[Fraction, Fraction]:
        """(p0 + p1 s)(q0 + q1 s) reduced to first order."""
        p0, p1 = p
        q0, q1 = q
        c0 = p0 * q0 + self.beta * p1 * q1
        c1 = p0 * q1 + p1 * q0 + self.alpha * p1 * q1
        return c0, c1

    def real_part(self, p: Tuple[Fraction, Fraction]) -> Fraction:
        return p[0] + p[1] * self.re_s


@dataclasses.dataclass(frozen=True)
class Frequency:
    """One independent frequency of a real-input symbolic DFT.

    ``kind == 'real'``  : X_u is real, 1 component, 1 multiplication.
    ``kind == 'complex'``: X_u = P + Q*s, 3 components via Karatsuba
                           (P, Q, P+Q), 3 multiplications.
    """

    u: int
    kind: str  # 'real' | 'complex'

    @property
    def n_components(self) -> int:
        return 1 if self.kind == "real" else 3


def real_dft_frequencies(N: int) -> List[Frequency]:
    """Independent frequencies of a length-N real DFT (Hermitian symmetry)."""
    freqs = [Frequency(0, "real")]
    for u in range(1, (N + 1) // 2):     # complex freqs: 1 .. ceil(N/2)-1
        freqs.append(Frequency(u, "complex"))
    if N % 2 == 0 and N >= 2:
        freqs.append(Frequency(N // 2, "real"))
    return freqs


def forward_rows(ring: CyclotomicRing, freq: Frequency) -> List[List[int]]:
    """Integer functional rows (length N) producing freq's mult operands.

    For a real frequency: one row r with X_u = sum_i r[i] x_i.
    For a complex frequency: rows (P, Q, P+Q) — the three Karatsuba operands.
    All entries are small integers; for N in {2,3,4,6} they are in
    {-2,-1,0,1,2} (and {-1,0,1} for the plain P,Q rows), i.e. the transform
    is additions only.
    """
    N = ring.N
    a_row = [0] * N
    b_row = [0] * N
    for i in range(N):
        a, b = ring.root_power(freq.u * i)
        a_row[i] = a
        b_row[i] = b
    if freq.kind == "real":
        assert all(v == 0 for v in b_row), (
            f"frequency u={freq.u} of DFT-{N} is not real")
        return [a_row]
    return [a_row, b_row, [x + y for x, y in zip(a_row, b_row)]]


def karatsuba_recombine(ring: CyclotomicRing,
                        ) -> Tuple[List[int], List[int]]:
    """Coefficients turning (m1, m2, m3) into the product components.

    m1 = P*Pw, m2 = Q*Qw, m3 = (P+Q)(Pw+Qw); the reduced product is
    C0 + C1*s with C0 = m1 + beta*m2, C1 = m3 - m1 + (alpha-1)*m2.
    """
    c0 = [1, ring.beta, 0]
    c1 = [-1, ring.alpha - 1, 1]
    return c0, c1


def inverse_slot_coefficients(
        ring: CyclotomicRing,
        freqs: Sequence[Frequency],
        slot: int) -> List[Fraction]:
    """Exact coefficients of circular slot ``k`` over all mult components.

    y_c[k] = (1/N) * sum_{u=0}^{N-1} X''_u omega^{-u k}, where X''_u is the
    transform-domain product.  With Hermitian symmetry the sum over a
    conjugate pair (u, N-u) equals 2*Re(X''_u omega^{-u k}).  Every X''_u is
    linear in that frequency's Karatsuba outputs (m1, m2, m3), so each slot
    is an exact rational functional of the component products.
    """
    N = ring.N
    coeffs: List[Fraction] = []
    c0r, c1r = karatsuba_recombine(ring)
    for f in freqs:
        a, b = ring.root_power((-f.u * slot) % N)
        w = (Fraction(a), Fraction(b))
        if f.kind == "real":
            # Real frequencies (u = 0 and u = N/2) are self-conjugate: they
            # appear exactly once in the full sum.
            coeffs.append(ring.real_part(w) / N)
        else:
            # X''_u = C0 + C1 s, times omega^{-uk} = (a + b s); take 2*Re.
            two = Fraction(2)
            out = []
            for j in range(3):
                prod = ring.mul((Fraction(c0r[j]), Fraction(c1r[j])), w)
                out.append(two * ring.real_part(prod) / N)
            coeffs.extend(out)
    return coeffs
