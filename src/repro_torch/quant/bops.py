"""Bit-operations (BOPs) cost model — paper §6 metric.

An n-bit addition costs n BOPs; an n-bit multiplication costs n(n-1) BOPs
(n-1 shifted additions).  We account for all three stages of the fast
convolution (transform costs included, as the paper requires) plus the
direct-convolution baseline.

The workload description covers the planner's full spec space:

  * ``stride``   — direct convolution computes ceil(H/s) x ceil(W/s)
    outputs; fast (bilinear) algorithms are stride-1 constructs, so the
    lowering layer prices a strided workload as the *sum* of its
    polyphase stride-1 sub-workloads and compares against the strided
    direct baseline here (polyphase is only a win when the 4 sub-convs
    beat one strided direct conv);
  * ``groups``   — both paths contract C_in/groups channels per output;
  * ``depthwise``— no channel contraction at all: the element-wise stage
    is t^2 true elementwise mults per channel per tile, and the
    transforms run once per channel (groups == C_in == C_out).

Accumulator width for a dot product of K products of a-bit x w-bit operands:
    acc_bits = a + w + ceil(log2(K))
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.generator import BilinearAlgorithm


def add_bops(bits: int) -> int:
    return bits


def mult_bops(a_bits: int, w_bits: int) -> int:
    n = max(a_bits, w_bits)
    return n * (n - 1)


@dataclasses.dataclass(frozen=True)
class ConvWorkload:
    H: int                      # INPUT spatial extents
    W: int
    C_in: int
    C_out: int
    R: int
    bits_act: int = 8
    bits_weight: int = 8
    stride: int = 1
    groups: int = 1
    depthwise: bool = False
    padding: str = "SAME"       # SAME | VALID — decides the output grid

    @property
    def contraction(self) -> int:
        """Channels contracted per output (the K of one dot product)."""
        if self.depthwise:
            return 1
        return self.C_in // self.groups

    def out_extent(self, size: int) -> int:
        if self.padding == "SAME":
            return math.ceil(size / self.stride)
        return (size - self.R) // self.stride + 1

    @property
    def n_outputs_spatial(self) -> int:
        return self.out_extent(self.H) * self.out_extent(self.W)


def direct_conv_bops(wl: ConvWorkload) -> float:
    """Direct convolution: one length-R^2*(C_in/g) dot product per output.

    Strided workloads produce ceil(H/s)*ceil(W/s) outputs — the baseline
    the polyphase lowering has to beat.
    """
    K = wl.R * wl.R * wl.contraction
    acc_bits = wl.bits_act + wl.bits_weight + math.ceil(math.log2(max(K, 1)))
    per_out = K * mult_bops(wl.bits_act, wl.bits_weight) \
        + (K - 1) * add_bops(acc_bits)
    return wl.n_outputs_spatial * wl.C_out * per_out


def fastconv_bops(wl: ConvWorkload, algo: BilinearAlgorithm,
                  transform_bits: Optional[int] = None) -> float:
    """Fast convolution (SFC / Winograd) under the same cost model.

    * input transform: per tile per C_in, 2-D separable adds at
      ``transform_bits`` (data width grows by log2(||B^T||_1) — SFC rows sum
      to <= N so int8 data stays within int16).
    * element-wise stage: t^2 x (C_in/g) x C_out MACs per tile — or, for
      depthwise workloads, t^2 x C true elementwise mults per tile (no
      contraction; the transform-domain elementwise path).
    * output transform: per tile per C_out adds at accumulator width.
    * weight transform is amortized (precomputed once) — paper assumption.

    Fast algorithms are stride-1 constructs: strided workloads must be
    lowered (the lowering pass) before being priced here.
    """
    if wl.stride != 1:
        raise ValueError(
            f"fast algorithms are stride-1 constructs; lower the stride-"
            f"{wl.stride} workload to polyphase sub-workloads first")
    M, t, L = algo.M, algo.t, algo.L
    # tiles cover the OUTPUT grid (== input for stride-1 SAME; R-1 smaller
    # for VALID, the lowering layer's polyphase sub-problems)
    n_tiles = math.ceil(wl.out_extent(wl.H) / M) \
        * math.ceil(wl.out_extent(wl.W) / M)
    adds = algo.transform_addition_counts()

    if transform_bits is None:
        # single source of truth for transform-domain data width — the
        # same bound repro_torch.analysis.ranges certifies (bit-identical to
        # the historical inline formula)
        from repro_torch.analysis import ranges
        transform_bits = ranges.transform_bits_1d(algo, wl.bits_act)
    # 2-D separable input transform: rows then cols.
    input_adds = (adds["input"] * L + adds["input"] * t)  # per channel per tile
    input_cost = n_tiles * wl.C_in * input_adds * add_bops(transform_bits)

    # element-wise stage: accumulate over the contracted channels at wide
    # accumulator width (depthwise: K == 1, a pure elementwise product).
    K = wl.contraction
    acc_bits = wl.bits_act + wl.bits_weight + math.ceil(math.log2(max(K, 2)))
    ew_cost = n_tiles * t * t * wl.C_out * (
        K * mult_bops(wl.bits_act, wl.bits_weight) + (K - 1) * add_bops(acc_bits))

    # output transform at accumulator width (dequant fused into scales).
    out_adds = adds["output"] * t + adds["output"] * M
    out_cost = n_tiles * wl.C_out * out_adds * add_bops(acc_bits)

    return input_cost + ew_cost + out_cost


def bops_reduction(wl: ConvWorkload, algo: BilinearAlgorithm) -> float:
    """Direct/fast BOPs ratio (paper reports 1.6x-2.5x vs int8 direct)."""
    return direct_conv_bops(wl) / fastconv_bops(wl, algo)
