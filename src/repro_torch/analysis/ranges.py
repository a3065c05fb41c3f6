"""Static interval / bit-width analysis of the int8 SFC datapath.

The paper's headline claim is an *error analysis*: SFC's additions-only
transforms keep int8 accuracy where Winograd's fractional transforms lose
it.  This module makes the matching *overflow* analysis static.  Every
registered algorithm's transform matrices are exact ``Fraction`` values
(``repro_torch.core.generator``), so worst-case value growth through each stage
of the deployed pipeline is derivable without running anything — the same
style of derivation Barabasz et al. ("Error Analysis and Improving the
Accuracy of Winograd Convolution") and Meng & Brothers ("Efficient
Winograd Convolution via Integer Arithmetic") carry out for Winograd.

Stages of the int8 datapath (``repro_torch.kernels``) and their bounds, for
activations quantized to ``bits_act`` and weights to ``bits_weight`` on
the int8 carrier:

  1. forward transform  B^T X B        (fp32; for int-grid inputs
     |x| <= q the result is bounded per frequency (u, v) by
     ||B^T_u||_1 * ||B^T_v||_1 * q — tight: signs can be chosen to
     achieve it, and the 2-D worst case is the worst 1-D row squared);
  2. per-frequency quantization        clip(round(tx / s)) in
     [-qmax_act, qmax_act] — the clip makes this bound *unconditional*,
     whatever the calibrated scales are;
  3. t^2-position int8 x int8 products |xq * wq| <= qmax_act * qmax_weight;
  4. k-blocked int32 accumulation      the fused kernel's VMEM scratch
     (and the staged ``tdmm_int8`` reduction) accumulate the FULL C_in
     contraction in int32 — k-blocking only stages the reduction, it
     never resets the accumulator, so the bound binds C_in itself:
         |acc| <= C_in * qmax_act * qmax_weight <= 2^31 - 1;
  5. dequant + inverse  A^T Y A        (fp32; the int32 -> f32 cast is
     value-exact only while the accumulator fits the 24-bit f32 mantissa
     — ``dequant_exact_cin`` is the C_in up to which that cast is
     lossless).

:func:`certificate` packages the per-algorithm bounds;
:func:`check_spec_accumulator` is the cheap pre-flight ``plan()`` runs
before handing a quantized spec to an integer-datapath backend.

This module deliberately imports only ``repro_torch.core.generator`` (exact
matrices) at module level: ``repro_torch.quant.bops`` shares the transform
bit-growth derivation from here, and the planner pre-flight must stay
import-cycle-free and cheap.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Dict, Optional

from repro_torch.core.generator import BilinearAlgorithm

INT32_MAX = 2 ** 31 - 1
_F32_MANTISSA_BITS = 24          # f32 represents integers exactly to 2^24


def qmax(bits: int) -> int:
    """Largest magnitude of a symmetric ``bits``-wide quantization grid."""
    return 2 ** (bits - 1) - 1


# --------------------------------------------------------------------------
# transform growth (shared with the BOPs cost model)
# --------------------------------------------------------------------------
def bt_row_l1(algo: BilinearAlgorithm) -> int:
    """max_u ||B^T_u||_1 truncated to int — the 1-D transform growth factor
    the BOPs model (``repro_torch.quant.bops``) prices transform adds at.  Kept
    bit-for-bit identical to the expression historically inlined there so
    adopting the shared helper changes no cost-model ranking."""
    return max(int(sum(abs(v) for v in row)) for row in algo.BT)


def bt_row_l1_exact(algo: BilinearAlgorithm) -> Fraction:
    """max_u ||B^T_u||_1 as an exact Fraction (certificate arithmetic)."""
    return max(sum(abs(v) for v in row) for row in algo.BT)


def at_row_l1_exact(algo: BilinearAlgorithm) -> Fraction:
    return max(sum(abs(v) for v in row) for row in algo.AT)


def g_row_l1_exact(algo: BilinearAlgorithm) -> Fraction:
    return max(sum(abs(v) for v in row) for row in algo.G)


def transform_bits_1d(algo: BilinearAlgorithm, bits_act: int) -> int:
    """Bit width of one 1-D B^T pass over ``bits_act``-wide integer data.

    This is the BOPs model's transform-add width (data grows by
    log2(||B^T||_1) bits per pass); SFC rows sum to <= N so int8 data
    stays within int16.
    """
    return bits_act + max(1, math.ceil(math.log2(max(bt_row_l1(algo), 2))))


def _signed_bits(max_abs: int) -> int:
    """Bits of a signed integer type that can hold values in [-m, m]."""
    return int(max_abs).bit_length() + 1


# --------------------------------------------------------------------------
# accumulator safety
# --------------------------------------------------------------------------
def safe_cin_bound(bits_act: int = 8, bits_weight: int = 8) -> int:
    """Max contraction length K with NO int32 overflow possible.

    Worst case per int8 x int8 product is qmax_act * qmax_weight (both
    operands are clipped to their symmetric grids by construction), so
    |acc| <= K * qmax_act * qmax_weight.  int32 overflow is impossible
    iff K <= floor((2^31 - 1) / (qmax_act * qmax_weight)).  Independent
    of ``k_block``: the kernels' int32 scratch persists across k-blocks
    and accumulates the full C_in.
    """
    return INT32_MAX // (qmax(bits_act) * qmax(bits_weight))


def dequant_exact_cin(bits_act: int = 8, bits_weight: int = 8) -> int:
    """Max contraction length for which the int32 -> f32 dequant cast is
    value-exact (accumulator within the 24-bit f32 mantissa)."""
    return (2 ** _F32_MANTISSA_BITS) // (qmax(bits_act) * qmax(bits_weight))


class AccumulatorOverflowError(ValueError):
    """A quantized spec whose int32 accumulator could wrap at runtime."""


def check_contraction(contraction: int, bits_act: int, bits_weight: int,
                      *, context: str = "") -> None:
    """Raise :class:`AccumulatorOverflowError` when a contraction of
    ``contraction`` int8 x int8 products can overflow int32."""
    bound = safe_cin_bound(bits_act, bits_weight)
    if contraction > bound:
        prod = qmax(bits_act) * qmax(bits_weight)
        raise AccumulatorOverflowError(
            f"int32 accumulator overflow risk{context}: contraction length "
            f"{contraction} exceeds the safe bound {bound} for "
            f"int{bits_act} x int{bits_weight} products (worst case "
            f"|acc| = K * {prod} must stay <= {INT32_MAX}; at K = "
            f"{contraction} it reaches {contraction * prod}).  Reduce "
            f"C_in, split the contraction across plans, or run the spec "
            f"unquantized.")


def check_spec_accumulator(spec, algorithm: Optional[BilinearAlgorithm],
                           *, algo_name: str = "") -> None:
    """``plan()`` pre-flight: reject quantized specs whose accumulator
    can wrap on the integer datapath.

    Depthwise contracts K = 1 (a pure elementwise product) and grouped
    specs contract C_in / groups; specs without channel hints pass (the
    planner cannot bound what it cannot see — the kernels' conformance
    tests cover the dynamic envelope).
    """
    if algorithm is None or not spec.quant.enabled:
        return
    if spec.in_channels is None:
        return
    k = 1 if spec.depthwise else spec.in_channels // max(1, spec.groups)
    check_contraction(
        k, spec.quant.bits_act, spec.quant.bits_weight,
        context=(f" (spec C_in={spec.in_channels}, "
                 f"algo {algo_name or algorithm.name})"))


# --------------------------------------------------------------------------
# per-algorithm certificates
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Certificate:
    """Statically derived worst-case bounds for one registered algorithm.

    All integer fields are exact (derived in Fraction arithmetic and
    ceil'd); ``None`` bounds mean "unbounded by this stage" (e.g. the
    depthwise accumulator, which contracts a single product).
    """

    algo: str                     # registry name
    kind: str                     # 'sfc' | 'winograd' | ...
    M: int
    R: int
    t: int
    bits_act: int
    bits_weight: int
    integer_transform: bool       # B^T, G integral (additions-only claim)
    bt_row_l1: float              # max 1-D input-transform row L1
    transform_growth_2d: float    # worst |tx| / |x| over frequencies (2-D)
    transform_hi: int             # |tx| bound for int-grid |x| <= qmax_act
    transform_bits: int           # signed bits holding transform_hi
    g_row_l1: float               # weight-transform growth (offline stage)
    at_row_l1: float              # 1-D inverse growth
    inverse_growth_2d: float      # worst |y| / |ty| through A^T Y A
    product_hi: int               # qmax_act * qmax_weight
    product_bits: int
    safe_cin: int                 # max C_in: int32 overflow impossible
    acc_bits_at_safe_cin: int     # accumulator width right at the bound
    dequant_exact_cin: int        # max C_in: int32 -> f32 cast lossless

    def acc_bits(self, c_in: int) -> int:
        """Signed bits the int32 accumulator needs at contraction c_in."""
        return _signed_bits(c_in * self.product_hi)

    def headroom_bits(self, c_in: int) -> int:
        """int32 bits to spare at contraction ``c_in`` (negative: unsafe)."""
        return 32 - self.acc_bits(c_in)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def certificate(algo: BilinearAlgorithm, *, name: Optional[str] = None,
                bits_act: int = 8, bits_weight: int = 8) -> Certificate:
    """Derive the static overflow/bit-width certificate for ``algo``."""
    qa, qw = qmax(bits_act), qmax(bits_weight)
    l1 = bt_row_l1_exact(algo)
    growth_2d = l1 * l1                       # separable: worst row squared
    transform_hi = math.ceil(growth_2d * qa)
    at_l1 = at_row_l1_exact(algo)
    prod = qa * qw
    safe = INT32_MAX // prod
    return Certificate(
        algo=name or algo.name, kind=algo.kind, M=algo.M, R=algo.R,
        t=algo.t, bits_act=bits_act, bits_weight=bits_weight,
        integer_transform=algo.is_integer_transform(),
        bt_row_l1=float(l1), transform_growth_2d=float(growth_2d),
        transform_hi=transform_hi,
        transform_bits=_signed_bits(transform_hi),
        g_row_l1=float(g_row_l1_exact(algo)),
        at_row_l1=float(at_l1), inverse_growth_2d=float(at_l1 * at_l1),
        product_hi=prod, product_bits=_signed_bits(prod),
        safe_cin=safe, acc_bits_at_safe_cin=_signed_bits(safe * prod),
        dequant_exact_cin=(2 ** _F32_MANTISSA_BITS) // prod,
    )


def all_certificates(*, bits_act: int = 8, bits_weight: int = 8
                     ) -> Dict[str, Certificate]:
    """One certificate per registered algorithm (registry order)."""
    from repro_torch.api import registry       # late: keep this module cycle-free
    out = {}
    for entry in registry.entries():
        out[entry.name] = certificate(
            registry.get_algorithm(entry.name), name=entry.name,
            bits_act=bits_act, bits_weight=bits_weight)
    return out


def transform_interval_hi(algo: BilinearAlgorithm, in_hi: float) -> float:
    """|B^T X B| bound per frequency for inputs bounded by ``in_hi`` —
    what the conformance fuzz layer asserts observed transform-domain
    values against."""
    return float(bt_row_l1_exact(algo) ** 2) * in_hi
