"""Iterative SFC convolution for very large kernels (paper Appendix B).

Large (depthwise) kernels are handled by a two-level nesting: the kernel is
split into ``Ro`` tiles of ``Ri`` taps and the feature map into overlapping
tiles on a stride-``Mi`` grid; the per-tile correlations are accelerated by
an *inner* SFC algorithm and the accumulation across kernel tiles — itself a
correlation over the tile grid — by an *outer* SFC algorithm.  Total
multiplications per composed tile = t_outer * t_inner (paper: 132*132 for a
29x29 kernel == ~3% of direct).

Exactness requires the tile grid to align: **inner kernel-tile size Ri must
equal the inner output-tile size Mi** (the paper's uneven 5/6 split needs
extra unspecified corrections; we use the aligned variant and report the
achieved ratio — same order as the paper's 3%).  With

    X[p, j] = x[p*Mi + j]        p = 0..(Mo+Ro-2),  j = 0..L_i-1

the large correlation becomes a separable 2-D bilinear form over (p, j),
so the standard SFC flow applies along each axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.generator import BilinearAlgorithm
from repro_torch.core.precision import full_fp32_matmul


def iterative_mult_count(outer: BilinearAlgorithm,
                         inner: BilinearAlgorithm,
                         two_d: bool = True) -> int:
    """Multiplications per composed output tile (App. B accounting)."""
    per_dim = outer.t * inner.t
    return per_dim * per_dim if two_d else per_dim


def iterative_conv1d(x: torch.Tensor, w: torch.Tensor,
                     inner: BilinearAlgorithm,
                     outer: BilinearAlgorithm) -> torch.Tensor:
    """1-D valid correlation with a large kernel via 2-level SFC nesting.

    x: (Mo*Mi + Ro*Ri - 1,), w: (Ro*Ri,) -> y: (Mo*Mi,)
    with the alignment condition inner.R == inner.M.  Runs on ``x``'s
    device, its products in full float32.
    """
    Ri, Mi, Li = inner.R, inner.M, inner.L
    Ro, Mo, Lo = outer.R, outer.M, outer.L
    if Ri != Mi:
        raise ValueError(
            f"nested SFC needs inner.R == inner.M for grid alignment; "
            f"got R={Ri}, M={Mi}")
    Rw, Mtot = Ro * Ri, Mo * Mi
    assert tuple(w.shape) == (Rw,), (tuple(w.shape), Rw)
    assert x.shape[0] == Mtot + Rw - 1, (tuple(x.shape), Mtot + Rw - 1)

    # Overlapping arrangement X[p, j] = x[p*Mi + j]; the last tiles read past
    # the end of x by (Li - Mi) = Ri - 1 elements -> zero-pad.
    P = Lo  # = Mo + Ro - 1 outer positions
    xp = F.pad(x, (0, P * Mi + Li - Mi - x.shape[0]))
    dev = x.device
    idx = torch.arange(P, device=dev)[:, None] * Mi \
        + torch.arange(Li, device=dev)[None, :]
    X = xp[idx]                                     # (P, Li)
    W = w.reshape(Ro, Ri)                           # (Ro, Ri)

    def mat(m):
        return torch.tensor(m, dtype=x.dtype, device=dev)

    bo, bi = mat(outer.bt()), mat(inner.bt())       # (t_o, Lo), (t_i, Li)
    go, gi = mat(outer.g()), mat(inner.g())         # (t_o, Ro), (t_i, Ri)
    ao, ai = mat(outer.at()), mat(inner.at())       # (Mo, t_o), (Mi, t_i)

    with full_fp32_matmul():
        TX = torch.einsum("op,ij,pj->oi", bo, bi, X)    # (t_o, t_i)
        TW = torch.einsum("ok,ir,kr->oi", go, gi, W)    # (t_o, t_i)
        TY = TX * TW                                    # t_o * t_i mults
        Y = torch.einsum("mo,ni,oi->mn", ao, ai, TY)    # (Mo, Mi)
    return Y.reshape(Mtot)


def large_kernel_report(kernel_size: int, inner: BilinearAlgorithm,
                        outer: BilinearAlgorithm) -> dict:
    """Multiplication accounting for one composed 2-D output tile."""
    Mtot = outer.M * inner.M
    direct = (Mtot * kernel_size) ** 2
    nested = iterative_mult_count(outer, inner, two_d=True)
    return {
        "kernel": kernel_size,
        "outputs_2d": Mtot * Mtot,
        "direct_mults": direct,
        "nested_mults": nested,
        "ratio_pct": 100.0 * nested / direct,
    }
