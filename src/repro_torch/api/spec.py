"""``ConvSpec`` — the frozen, hashable description of one convolution.

A spec captures everything the planner needs to pick an algorithm and an
execution path: spatial rank, kernel taps, stride, padding, dense vs
grouped vs depthwise, dtype, and the quantization policy.  Channel counts
and spatial extents are optional *cost-model hints* — planning works
without them but auto-selection degrades to arithmetic-complexity ranking.

A spec need not be *natively* servable by a fast algorithm to reach the
fast path: the planner's lowering pass (``repro_torch.api.lowering``)
rewrites stride-2 specs into polyphase stride-1 sub-specs and grouped
specs into per-group dense sub-specs before algorithm selection, so
:attr:`fast_eligible` describes only the native stride-1 construct.

Specs are frozen dataclasses so ``plan()`` can memoize on them directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.quant.fake_quant import FP32, QuantConfig

PADDINGS_2D = ("SAME", "VALID")
PADDING_CAUSAL = "CAUSAL"


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One convolution workload, independent of backend and algorithm."""

    rank: int = 2                    # spatial rank: 1 (sequence) | 2 (image)
    kernel_size: int = 3             # taps R per spatial dim
    stride: int = 1
    padding: str = "SAME"            # SAME | VALID | CAUSAL (rank-1 only)
    depthwise: bool = False          # groups == channels (rank 1 or 2)
    groups: int = 1                  # grouped conv: C_in/g -> C_out/g each
    in_channels: Optional[int] = None
    out_channels: Optional[int] = None
    spatial: Optional[Tuple[int, ...]] = None   # (H, W) / (T,) hint
    dtype: str = "float32"
    quant: QuantConfig = FP32

    def __post_init__(self):
        if self.rank not in (1, 2):
            raise ValueError(f"rank must be 1 or 2, got {self.rank}")
        if self.kernel_size < 1:
            raise ValueError(f"kernel_size must be >= 1: {self.kernel_size}")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1: {self.stride}")
        if self.rank == 2 and self.padding not in PADDINGS_2D:
            raise ValueError(
                f"rank-2 padding must be one of {PADDINGS_2D}: {self.padding}")
        if self.rank == 1:
            if not self.depthwise or self.padding != PADDING_CAUSAL \
                    or self.stride != 1:
                raise ValueError(
                    "rank-1 convs are supported as stride-1 depthwise "
                    f"CAUSAL only (got depthwise={self.depthwise}, "
                    f"padding={self.padding!r}, stride={self.stride})")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1: {self.groups}")
        if self.groups > 1:
            if self.rank != 2:
                raise ValueError("grouped convolution is rank-2 only "
                                 f"(got rank={self.rank})")
            if self.depthwise:
                raise ValueError(
                    "depthwise=True already means groups == channels; "
                    f"do not also set groups={self.groups}")
            for label, c in (("in_channels", self.in_channels),
                             ("out_channels", self.out_channels)):
                if c is not None and c % self.groups:
                    raise ValueError(
                        f"{label}={c} not divisible by groups={self.groups}")
        if self.rank == 2 and self.depthwise \
                and self.in_channels is not None \
                and self.out_channels is not None \
                and self.in_channels != self.out_channels:
            raise ValueError(
                "2-D depthwise requires out_channels == in_channels "
                f"(got {self.in_channels} -> {self.out_channels})")
        if self.spatial is not None and len(self.spatial) != self.rank:
            raise ValueError(
                f"spatial hint {self.spatial} does not match rank {self.rank}")

    # ---- planner predicates ----
    @property
    def fast_eligible(self) -> bool:
        """Whether a bilinear fast algorithm applies *natively*.

        Fast algorithms are stride-1 constructs over >=2-tap kernels
        (dense or depthwise — 2-D depthwise runs the transform-domain
        elementwise path).  Shapes outside this set are not lost causes:
        the planner first tries the lowering pass
        (``repro_torch.api.lowering``: polyphase stride-2 decomposition,
        per-group splitting) and only then degrades to the direct path —
        this property and that pass are the two places the branch lives,
        instead of every call site.
        """
        return self.stride == 1 and self.kernel_size > 1 and self.groups == 1

    @classmethod
    def for_conv2d(cls, x_shape, w_shape, *, stride: int = 1,
                   padding: str = "SAME", groups: int = 1,
                   dtype: str = "float32",
                   quant: QuantConfig = FP32) -> "ConvSpec":
        """Spec from concrete NHWC input / HWIO weight shapes.

        Grouped convs follow the ``lax`` convention: weights are
        (R, R, C_in/groups, C_out), so ``in_channels`` is recovered as
        ``w_shape[2] * groups``.
        """
        return cls(rank=2, kernel_size=int(w_shape[0]), stride=stride,
                   padding=padding, groups=groups,
                   in_channels=int(w_shape[2]) * groups,
                   out_channels=int(w_shape[3]),
                   spatial=(int(x_shape[1]), int(x_shape[2])),
                   dtype=dtype, quant=quant)

    @classmethod
    def for_conv2d_depthwise(cls, x_shape, w_shape, *, stride: int = 1,
                             padding: str = "SAME", dtype: str = "float32",
                             quant: QuantConfig = FP32) -> "ConvSpec":
        """Spec from (B, H, W, C) input / (R, R, 1, C) weight shapes."""
        return cls(rank=2, kernel_size=int(w_shape[0]), stride=stride,
                   padding=padding, depthwise=True,
                   in_channels=int(w_shape[3]), out_channels=int(w_shape[3]),
                   spatial=(int(x_shape[1]), int(x_shape[2])),
                   dtype=dtype, quant=quant)

    @classmethod
    def for_conv1d_depthwise(cls, x_shape, w_shape, *,
                             dtype: str = "float32",
                             quant: QuantConfig = FP32) -> "ConvSpec":
        """Spec from (B, T, C) input / (R, C) weight shapes (causal)."""
        return cls(rank=1, kernel_size=int(w_shape[0]), depthwise=True,
                   padding=PADDING_CAUSAL, in_channels=int(w_shape[1]),
                   out_channels=int(w_shape[1]), spatial=(int(x_shape[1]),),
                   dtype=dtype, quant=quant)
