"""Bilinear fast-convolution algorithm generators.

Every algorithm here is a bilinear triple (B^T, G, A^T) computing M
correlation outputs from L = M + R - 1 inputs and R weights:

    y = A^T @ ((G @ w) * (B^T @ x))          (1-D)
    Y = A^T @ ((G W G^T) * (B^T X B)) @ A    (2-D, by separability)

Generators:
  * ``generate_sfc(N, M, R)``    — the paper's Symbolic Fourier Convolution:
      circular DFT-N part (additions-only integer transforms) plus the
      correction-term mechanism of §4.2 that converts wrapped circular slots
      into extra valid outputs (slots may be *reused* by several outputs).
  * ``generate_winograd(M, R)``  — Toom-Cook/Winograd baseline via exact
      Lagrange interpolation with the standard small root points.
  * ``direct_algorithm(R)``      — direct convolution expressed in the same
      form (B^T = G = A^T = I-ish), for unified error analysis (paper Eq. 12).

All matrices are built with exact `fractions.Fraction` arithmetic and
validated for exactness; float64 copies are exported for numeric use.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import symbolic


# --------------------------------------------------------------------------
# Algorithm container
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BilinearAlgorithm:
    """An (M, R) fast correlation algorithm with t multiplications per dim."""

    name: str
    M: int                      # outputs per tile per dim
    R: int                      # kernel taps per dim
    BT: Tuple[Tuple[Fraction, ...], ...]   # t x L input transform
    G: Tuple[Tuple[Fraction, ...], ...]    # t x R weight transform
    AT: Tuple[Tuple[Fraction, ...], ...]   # M x t output transform
    kind: str = "generic"       # 'sfc' | 'winograd' | 'direct'
    meta: Tuple[Tuple[str, object], ...] = ()

    # ---- derived sizes ----
    @property
    def L(self) -> int:
        return self.M + self.R - 1

    @property
    def t(self) -> int:
        """Multiplications per 1-D tile (rows of B^T)."""
        return len(self.BT)

    @property
    def mults_2d(self) -> int:
        return self.t * self.t

    @property
    def arithmetic_complexity_2d(self) -> float:
        """Transform-domain mults / direct-conv mults, 2-D (paper Table 1)."""
        return self.mults_2d / float(self.M * self.M * self.R * self.R)

    # ---- numeric matrices ----
    # Memoized per instance: the exact->float conversion is pure, and the
    # kernel wrappers fetch these on every trace/apply (the frozen
    # dataclass blocks normal attribute writes, hence object.__setattr__).
    def bt(self) -> np.ndarray:
        return self._f64("BT")

    def g(self) -> np.ndarray:
        return self._f64("G")

    def at(self) -> np.ndarray:
        return self._f64("AT")

    def _f64(self, field: str) -> np.ndarray:
        cache = self.__dict__.get("_f64_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_f64_cache", cache)
        if field not in cache:
            arr = _to_f64(getattr(self, field))
            arr.setflags(write=False)     # shared instance: keep it frozen
            cache[field] = arr
        return cache[field]

    # ---- exact reference (Fractions, python lists) ----
    def conv1d_exact(self, x: Sequence[Fraction],
                     w: Sequence[Fraction]) -> List[Fraction]:
        assert len(x) == self.L and len(w) == self.R
        tx = [sum(r * v for r, v in zip(row, x)) for row in self.BT]
        tw = [sum(r * v for r, v in zip(row, w)) for row in self.G]
        m = [a * b for a, b in zip(tx, tw)]
        return [sum(r * v for r, v in zip(row, m)) for row in self.AT]

    def condition_number_at(self) -> float:
        """kappa(A^T) = sigma_max / sigma_min (paper Table 1)."""
        s = np.linalg.svd(self.at(), compute_uv=False)
        return float(s.max() / s.min())

    def transform_addition_counts(self) -> Dict[str, int]:
        """Nonzero-structure addition counts (BOPs accounting, naive)."""
        def adds(mat_rows):
            total = 0
            for row in mat_rows:
                nz = sum(1 for v in row if v != 0)
                total += max(nz - 1, 0)
            return total
        return {"input": adds(self.BT), "weight": adds(self.G),
                "output": adds(self.AT)}

    def is_integer_transform(self) -> bool:
        """True iff B^T and G are integral (the SFC additions-only claim)."""
        for mat in (self.BT, self.G):
            for row in mat:
                for v in row:
                    if Fraction(v).denominator != 1:
                        return False
        return True


def _to_f64(mat: Tuple[Tuple[Fraction, ...], ...]) -> np.ndarray:
    return np.array([[float(v) for v in row] for row in mat], dtype=np.float64)


def _freeze(mat: List[List[Fraction]]) -> Tuple[Tuple[Fraction, ...], ...]:
    return tuple(tuple(Fraction(v) for v in row) for row in mat)


# --------------------------------------------------------------------------
# SFC generator (paper §4)
# --------------------------------------------------------------------------
def _slot_pairings(N: int, R: int, offset: int, L: int, slot: int
                   ) -> List[Optional[int]]:
    """Global input index paired with tap r in circular slot ``slot``.

    Circular convolution of the windowed inputs x~[i] = x[offset+i]
    (zero when offset+i >= L) with the *folded, reversed* kernel
    f~[j] = sum_{r: (R-1-r) mod N == j} w[r].  Tap r therefore multiplies
    x~[(slot - (R-1-r)) mod N].
    """
    out: List[Optional[int]] = []
    for r in range(R):
        j = (R - 1 - r) % N
        i = (slot - j) % N
        gidx = offset + i
        out.append(gidx if gidx < L else None)
    return out


def generate_sfc(N: int, M: int, R: int,
                 offset: Optional[int] = None) -> BilinearAlgorithm:
    """Construct SFC-N(M, R) per paper §4.1–4.2.

    The circular DFT-N provides N slots; slots whose taps all match a desired
    output window are free; any other output is produced from the cheapest
    slot plus correction components ``(x_a - x_b) * w_r`` (one multiplication
    each, paper Fig. 2) — or from scratch when no slot helps.  One slot may
    serve several outputs (this is how SFC-6(7x7,3x3) reaches 144 = 12^2
    mults instead of 196).  The search over window offsets is exhaustive.
    """
    ring = symbolic.CyclotomicRing.for_points(N)
    freqs = symbolic.real_dft_frequencies(N)
    L = M + R - 1

    def solve(offset: int):
        """Greedy-optimal per-output slot assignment for a given window."""
        assignments = []  # (m, slot|None, corrections=[(r, paired_idx|None)])
        total = 0
        for m in range(M):
            best = None
            for slot in range(N):
                pairing = _slot_pairings(N, R, offset, L, slot)
                corr = [(r, pairing[r]) for r in range(R)
                        if pairing[r] != m + r]
                cost = len(corr)
                if best is None or cost < best[2]:
                    best = (slot, corr, cost)
            # building from scratch costs R multiplications
            if best[2] >= R:
                best = (None, [(r, None) for r in range(R)], R)
            assignments.append((m, best[0], best[1]))
            total += best[2]
        return total, assignments

    if offset is None:
        candidates = range(max(1, L - N + 1)) if L > N else [0]
        offset, (_, assignments) = min(
            ((o, solve(o)) for o in candidates), key=lambda kv: kv[1][0])
    else:
        _, assignments = solve(offset)

    # --- circular (DFT) components ---
    bt_rows: List[List[Fraction]] = []
    g_rows: List[List[Fraction]] = []
    for f in freqs:
        for row in symbolic.forward_rows(ring, f):
            # input side: window positions -> global columns
            brow = [Fraction(0)] * L
            for i, v in enumerate(row):
                gidx = offset + i
                if gidx < L and v:
                    brow[gidx] += v
            bt_rows.append(brow)
        # weight side: G_u[r] from omega^{u * ((R-1-r) mod N)}
        a_row = [Fraction(0)] * R
        b_row = [Fraction(0)] * R
        for r in range(R):
            j = (R - 1 - r) % N
            a, b = ring.root_power(f.u * j)
            a_row[r] += a
            b_row[r] += b
        if f.kind == "real":
            assert all(v == 0 for v in b_row)
            g_rows.append(a_row)
        else:
            g_rows.append(a_row)
            g_rows.append(b_row)
            g_rows.append([x + y for x, y in zip(a_row, b_row)])

    n_dft = len(bt_rows)
    assert n_dft == sum(f.n_components for f in freqs) == len(g_rows)

    # --- correction components (deduplicated) ---
    corr_index: Dict[Tuple[Tuple[Fraction, ...], Tuple[Fraction, ...]], int] = {}
    corr_bt: List[List[Fraction]] = []
    corr_g: List[List[Fraction]] = []
    at_rows: List[List[Fraction]] = []
    for m, slot, corrections in assignments:
        if slot is not None:
            at = list(symbolic.inverse_slot_coefficients(ring, freqs, slot))
        else:
            at = [Fraction(0)] * n_dft
        corr_cols: Dict[int, Fraction] = {}
        for r, paired in corrections:
            brow = [Fraction(0)] * L
            brow[m + r] += 1
            if paired is not None:
                brow[paired] -= 1
            grow = [Fraction(0)] * R
            grow[r] += 1
            key = (tuple(brow), tuple(grow))
            if key not in corr_index:
                corr_index[key] = len(corr_bt)
                corr_bt.append(brow)
                corr_g.append(grow)
            corr_cols[corr_index[key]] = Fraction(1)
        at_rows.append((at, corr_cols))

    t = n_dft + len(corr_bt)
    AT: List[List[Fraction]] = []
    for at, corr_cols in at_rows:
        row = list(at) + [Fraction(0)] * len(corr_bt)
        for ci, v in corr_cols.items():
            row[n_dft + ci] += v
        AT.append(row)

    algo = BilinearAlgorithm(
        name=f"SFC-{N}({M}x{M},{R}x{R})",
        M=M, R=R,
        BT=_freeze(bt_rows + corr_bt),
        G=_freeze(g_rows + corr_g),
        AT=_freeze(AT),
        kind="sfc",
        meta=(("N", N), ("offset", offset),
              ("n_dft_components", n_dft),
              ("n_corrections", len(corr_bt))),
    )
    _validate_exact(algo)
    return algo


# --------------------------------------------------------------------------
# Winograd / Toom-Cook baseline
# --------------------------------------------------------------------------
_DEFAULT_POINTS = [0, 1, -1, 2, -2, Fraction(1, 2), Fraction(-1, 2), 4, -4,
                   Fraction(1, 4), Fraction(-1, 4), 3, -3]

_INF = "inf"


def generate_winograd(M: int, R: int,
                      points: Optional[Sequence] = None) -> BilinearAlgorithm:
    """Winograd F(M, R) via the transposition of Toom-Cook interpolation.

    Linear convolution LC(M, R) evaluates the product polynomial at
    N = M + R - 1 points (last point at infinity) and interpolates; the
    correlation form F(M, R) is its transpose:
        B^T = (V^T)^{-1} (N x L),  G = E_R (N x R),  A^T = E_M^T (M x N).
    """
    N = M + R - 1
    if points is None:
        points = list(_DEFAULT_POINTS[: N - 1]) + [_INF]
    assert len(points) == N

    def eval_matrix(ncols: int) -> List[List[Fraction]]:
        rows = []
        for p in points:
            if p == _INF:
                rows.append([Fraction(0)] * (ncols - 1) + [Fraction(1)])
            else:
                pf = Fraction(p)
                rows.append([pf ** c for c in range(ncols)])
        return rows

    # Full N x N evaluation (degree N-1 product polynomial); at infinity the
    # evaluation picks the leading coefficient.
    V = eval_matrix(N)
    Vinv = _fraction_inverse(V)
    # B^T = (V^{-1})^T : N x N; input length L == N for Winograd.
    BT = [[Vinv[c][i] for c in range(N)] for i in range(N)]
    G = eval_matrix(R)
    EM = eval_matrix(M)
    AT = [[EM[i][m] for i in range(N)] for m in range(M)]

    # Practical (wincnn-style) scaling: make B^T integral by scaling each row
    # by the LCM of its denominators and compensating in the corresponding G
    # row (m_i = (b_i.x)(g_i.w) is invariant under b_i *= c, g_i /= c).  This
    # matches deployed Winograd matrices (integer input transform, fractional
    # weight transform, integral output transform) — the configuration whose
    # numerical behaviour the paper's Table 1 characterizes.
    import math
    for i in range(N):
        lcm = 1
        for v in BT[i]:
            lcm = lcm * v.denominator // math.gcd(lcm, v.denominator)
        if lcm != 1:
            BT[i] = [v * lcm for v in BT[i]]
            G[i] = [v / lcm for v in G[i]]

    algo = BilinearAlgorithm(
        name=f"Winograd({M}x{M},{R}x{R})",
        M=M, R=R,
        BT=_freeze(BT), G=_freeze(G), AT=_freeze(AT),
        kind="winograd",
        meta=(("points", tuple(str(p) for p in points)),),
    )
    _validate_exact(algo)
    return algo


def direct_algorithm(R: int) -> BilinearAlgorithm:
    """Direct convolution as a bilinear algorithm with M = 1 (paper Eq. 12)."""
    eye = [[Fraction(int(i == j)) for j in range(R)] for i in range(R)]
    algo = BilinearAlgorithm(
        name=f"direct({R}x{R})", M=1, R=R,
        BT=_freeze(eye), G=_freeze(eye),
        AT=_freeze([[Fraction(1)] * R]),
        kind="direct")
    _validate_exact(algo)
    return algo


def _fraction_inverse(mat: List[List[Fraction]]) -> List[List[Fraction]]:
    n = len(mat)
    a = [[Fraction(v) for v in row] + [Fraction(int(i == j)) for j in range(n)]
         for i, row in enumerate(mat)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        inv = Fraction(1) / a[col][col]
        a[col] = [v * inv for v in a[col]]
        for r in range(n):
            if r != col and a[r][col] != 0:
                f = a[r][col]
                a[r] = [v - f * u for v, u in zip(a[r], a[col])]
    return [row[n:] for row in a]


# --------------------------------------------------------------------------
# Exactness validation (rational arithmetic, zero tolerance)
# --------------------------------------------------------------------------
def _validate_exact(algo: BilinearAlgorithm, trials: int = 3) -> None:
    rng = np.random.RandomState(0)
    for _ in range(trials):
        x = [Fraction(int(v)) for v in rng.randint(-9, 10, size=algo.L)]
        w = [Fraction(int(v)) for v in rng.randint(-9, 10, size=algo.R)]
        got = algo.conv1d_exact(x, w)
        want = [sum(x[m + r] * w[r] for r in range(algo.R))
                for m in range(algo.M)]
        if got != want:
            raise AssertionError(
                f"{algo.name}: bilinear algorithm is NOT exact.\n"
                f"got  = {[str(v) for v in got]}\n"
                f"want = {[str(v) for v in want]}")


# --------------------------------------------------------------------------
# Registry of paper algorithms
# --------------------------------------------------------------------------
def paper_algorithms() -> Dict[str, BilinearAlgorithm]:
    """All algorithms appearing in paper Table 1 (plus direct conv)."""
    algos = {
        "direct(3x3)": direct_algorithm(3),
        "Wino(2x2,3x3)": generate_winograd(2, 3),
        "Wino(3x3,3x3)": generate_winograd(3, 3),
        "Wino(4x4,3x3)": generate_winograd(4, 3),
        "Wino(2x2,5x5)": generate_winograd(2, 5),
        "Wino(2x2,7x7)": generate_winograd(2, 7),
        "SFC-4(4x4,3x3)": generate_sfc(4, 4, 3),
        "SFC-6(6x6,3x3)": generate_sfc(6, 6, 3),
        "SFC-6(7x7,3x3)": generate_sfc(6, 7, 3),
        "SFC-6(6x6,5x5)": generate_sfc(6, 6, 5),
        "SFC-6(4x4,7x7)": generate_sfc(6, 4, 7),
    }
    return algos
