"""Shape bucketing: heterogeneous request shapes onto warm ``ConvSpec`` s
(the JAX package's ``repro.serve.bucketing`` on torch tensors).

A serving deployment cannot afford a cold ``plan()`` (lowering pass +
algorithm selection + weight transform + int8 quantization) on the request
path — and it cannot hold a warm plan per distinct ``(h, w)`` either,
because open traffic has unbounded shape diversity.  The bucket table is
the standard resolution: a small fixed set of spatial buckets, each with
one pre-planned ``ConvSpec`` and pre-prepared weights, and every request
padded up to the smallest bucket that contains it.

Zero-padding to a bucket is *output-exact* for the stride-1 SAME/VALID
convs served here: the conv itself zero-pads its borders, so the extra
rows/columns a smaller image borrows from the bucket are the same zeros
the unpadded conv would have synthesized — cropping the output back to
the request's own output extent recovers the unbucketed answer exactly
(asserted in tests/test_torch_serve.py, bit-wise on the int8 path).
The cost is *waste*: padded pixels are computed and thrown away, so the
table accounts ``waste(h, w)`` per request and the benchmark reports the
aggregate fraction — the knob that trades bucket-count (warm memory,
compile count) against wasted FLOPs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch.nn.functional as F

from repro_torch.api.spec import ConvSpec
from repro_torch.quant.fake_quant import FP32, QuantConfig


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One warm serving shape: a name, the padded extent, and its spec."""

    name: str
    h: int
    w: int
    spec: ConvSpec

    def fits(self, h: int, w: int) -> bool:
        return h <= self.h and w <= self.w

    def waste(self, h: int, w: int) -> float:
        """Fraction of the bucket's pixels a (h, w) request pads away."""
        return 1.0 - (h * w) / float(self.h * self.w)


class BucketTable:
    """Ordered (smallest-area-first) buckets over one conv workload.

    All buckets share kernel/channels/quant — they are spatial variants of
    ONE layer workload, so one weight tensor (and per-bucket activation
    scales) serves the whole table.
    """

    def __init__(self, buckets: Sequence[Bucket]):
        if not buckets:
            raise ValueError("bucket table needs at least one bucket")
        self.buckets: List[Bucket] = sorted(
            buckets, key=lambda b: (b.h * b.w, b.h))
        names = [b.name for b in self.buckets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate bucket names: {names}")

    @classmethod
    def for_workload(cls, shapes: Sequence[Tuple[int, int]], *,
                     kernel_size: int, in_channels: int, out_channels: int,
                     stride: int = 1, padding: str = "SAME",
                     quant: QuantConfig = FP32) -> "BucketTable":
        """Table of spatial buckets over one (R, C_in, C_out) workload."""
        return cls([
            Bucket(name=f"b{h}x{w}", h=h, w=w,
                   spec=ConvSpec(rank=2, kernel_size=kernel_size,
                                 stride=stride, padding=padding,
                                 in_channels=in_channels,
                                 out_channels=out_channels,
                                 spatial=(h, w), quant=quant))
            for h, w in dict.fromkeys((int(h), int(w)) for h, w in shapes)])

    def bucket_for(self, h: int, w: int) -> Optional[Bucket]:
        """Smallest bucket containing (h, w); None = no bucket fits
        (admission control rejects rather than silently truncating)."""
        for b in self.buckets:               # sorted by area: first fit wins
            if b.fits(h, w):
                return b
        return None

    def by_name(self, name: str) -> Bucket:
        for b in self.buckets:
            if b.name == name:
                return b
        raise KeyError(name)

    @staticmethod
    def pad_to(x, bucket: Bucket):
        """Zero-pad one (h, w, C) image tensor to the bucket extent
        (bottom/right, matching the conv's own zero border)."""
        h, w = int(x.shape[0]), int(x.shape[1])
        if not bucket.fits(h, w):
            raise ValueError(
                f"image ({h}, {w}) exceeds bucket {bucket.name}")
        if (h, w) == (bucket.h, bucket.w):
            return x
        return F.pad(x, (0, 0, 0, bucket.w - w, 0, bucket.h - h))

    @staticmethod
    def crop_output(y, h: int, w: int, bucket: Bucket):
        """Crop one bucket-shaped output back to the request's own output
        extent (stride-aware: the bucketed grid is a superset).

        Raises instead of returning an empty tensor: a sub-kernel VALID
        request has *no* output rows (``(h - r)//s + 1 <= 0``), and
        silently serving a 0-row crop is data loss the caller cannot
        distinguish from success — admission (``AdmissionPolicy``)
        rejects such shapes up front, so reaching this is a bug.
        """
        s = bucket.spec.stride
        if bucket.spec.padding == "SAME":
            oh, ow = -(-h // s), -(-w // s)
        else:                                 # VALID
            r = bucket.spec.kernel_size
            oh, ow = (h - r) // s + 1, (w - r) // s + 1
        if oh <= 0 or ow <= 0:
            raise ValueError(
                f"empty output crop for request ({h}, {w}) under bucket "
                f"{bucket.name}: {bucket.spec.padding} {bucket.spec.kernel_size}"
                f"x{bucket.spec.kernel_size} stride {s} yields ({oh}, {ow}) "
                f"— admission should have rejected this shape")
        return y[:oh, :ow, :]
