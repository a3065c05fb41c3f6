"""Kernel configurations of the ``cuda`` int8 datapaths, and calibration.

The JAX package's autotuner and its timing cache are a later slice of the
port; until then a plan carries no measured config and the ``cuda``
backend runs :data:`DEFAULT_FUSED`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One executable configuration of the ``cuda`` int8 datapath.

    ``datapath`` picks the fused kernel (B4; depthwise B7) or the staged
    trio (B1-B3; depthwise B1, B6, B3).  ``k_block``: fused, the C_in
    width of one pipeline stage of B4 (32 or 64, multiples of the mma
    depth; None = 32), whose input patches and weights B4 copies into
    shared memory ahead of use; staged, the width of one reduction stage
    (any width; None = all of C_in); depthwise convs have no reduction
    and ignore it.  ``cout_block``: B4's output channels per block (8 or
    16: one or two mma n-tiles), or None to let
    ``kernels.sfc_fused.fused_geometry`` pick it per layer together with
    the C_out blocks of a cluster that share each input transform and the
    C_in slices that split the reduction; B7's channel block (any positive
    width that fits shared memory; None lets
    ``kernels.sfc_fused.depthwise_geometry`` pick it per layer).  Every B4
    and B7 geometry gives the same bits.  The JAX package's
    ``rows_per_step`` and ``double_buffer`` describe its TPU geometry and
    have no counterpart.
    """

    datapath: str = "fused"       # 'fused' | 'staged'
    k_block: Optional[int] = 32
    cout_block: Optional[int] = None

    def __post_init__(self):
        if self.datapath not in ("fused", "staged"):
            raise ValueError(f"datapath must be 'fused' or 'staged', got "
                             f"{self.datapath!r}")


DEFAULT_FUSED = KernelConfig()
DEFAULT_STAGED = KernelConfig(datapath="staged", k_block=None)


def calibrate_act_scale(x: torch.Tensor, algo, quant,
                        padding: str = "SAME") -> torch.Tensor:
    """Absmax per-frequency activation scales (t, t) from one batch.

    Single-batch stand-in for PTQ calibration; respects ``quant.bits_act``.
    """
    from repro_torch.core import conv2d as c2d
    from repro_torch.quant.fake_quant import qmax_for_bits
    tx, _ = c2d.transform_input_2d(x, algo, padding)
    return torch.amax(torch.abs(tx), dim=(0, 1, 2, 5)) \
        / qmax_for_bits(quant.bits_act) + 1e-9
