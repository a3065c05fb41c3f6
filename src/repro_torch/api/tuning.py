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
    trio (B1-B3; depthwise B1, B6, B3).  ``k_block`` is the C_in width of
    one reduction stage (fused: a multiple of 32, bounded by shared memory;
    staged: any width; None = all of C_in; depthwise convs have no
    reduction and ignore it).  ``cout_block`` is the fused kernels'
    channels per block, as in the JAX package, which uses it for both:
    B4's output channels (a multiple of 8) and B7's channel block (any
    positive width that fits shared memory).  The defaults run every
    registered algorithm on both layouts.  The JAX package's
    ``rows_per_step`` and ``double_buffer`` describe its TPU geometry and
    have no counterpart.
    """

    datapath: str = "fused"       # 'fused' | 'staged'
    k_block: Optional[int] = 32
    cout_block: int = 16

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
