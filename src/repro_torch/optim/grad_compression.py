"""Gradient compression with error feedback.

int8 stochastic quantization of gradients before the cross-replica
all-reduce cuts gradient-sync bytes 4x (f32) / 2x (bf16); the residual is
fed back into the next step so the *accumulated* update is unbiased
(error-feedback SGD, Seide et al. / Karimireddy et al.).

The rounding noise comes from an explicit ``torch.Generator``, so a run is
reproducible from its seed; it cannot match ``jax.random``'s draws, so the
port is held to the JAX package statistically.  ``compressed_psum`` is
the all-reduce itself, over a ``torch.distributed`` process group (NCCL
on the card, gloo on the CPU).  The train step's int8 round trip
(:func:`int8_roundtrip`) draws its noise from a counter instead: a hash
of each element's flat index in the whole leaf, the same on any device
and however the leaf is cut into blocks, so a sharded step compresses
each block alone and gets the unsharded step's bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding symmetric int8; returns (q, scale).  The noise is
    drawn from ``generator`` on its own device."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    y = x / scale
    noise = torch.rand(x.shape, generator=generator,
                       device=generator.device).to(x.device) - 0.5
    q = torch.clamp(torch.round(y + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (int64 tensors of values below 2**32; the
    products stay below 2**59)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def rounding_noise(index: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Uniform noise in [-0.5, 0.5), float32, for each int64 ``index``
    (an element's flat index in its whole leaf): 24 bits of a hash of the
    index and ``seed``, exact in float32, so every device draws the same
    bits."""
    hi = _mix32((index >> 32) ^ (seed & _M32))
    h = _mix32((index & _M32) ^ hi)
    return (h >> 8).to(torch.float32) * 2.0 ** -24 - 0.5


def _flat_index(offsets, shape, whole, device) -> torch.Tensor:
    """The flat indices in a tensor of shape ``whole`` of its block of
    ``shape`` at ``offsets`` (int64, broadcast over the block)."""
    strides = [1] * len(whole)
    for d in range(len(whole) - 2, -1, -1):
        strides[d] = strides[d + 1] * whole[d + 1]
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for d, (o, n, st) in enumerate(zip(offsets, shape, strides)):
        ar = (torch.arange(n, dtype=torch.int64, device=device) + o) * st
        idx = idx + ar.view([-1 if e == d else 1 for e in range(len(shape))])
    return idx


def int8_roundtrip(g: torch.Tensor, scale: torch.Tensor, offsets=None,
                   whole=None, seed: int = 0,
                   chunk: int = 1 << 24) -> torch.Tensor:
    """``dequantize_int8(*quantize_int8(g))`` at ``scale`` (the whole
    leaf's ``max |g| / 127 + 1e-12``) with :func:`rounding_noise` keyed
    by each element's flat index in the whole leaf (of shape ``whole``,
    ``g`` its block at ``offsets``; by default ``g`` is the leaf):
    float32, computed ``chunk`` elements at a time along the first
    dimension, so no index tensor of the leaf's size is made."""
    x = g.to(torch.float32)
    if x.dim() == 0:
        # a scalar is the one element of its leaf, index 0
        return int8_roundtrip(x[None], scale, (0,), (1,), seed, chunk)[0]
    offsets = (0,) * x.dim() if offsets is None else tuple(offsets)
    whole = tuple(x.shape) if whole is None else tuple(whole)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    per_row = max(1, x[0].numel())
    rows = max(1, chunk // per_row)
    for r in range(0, x.shape[0], rows):
        part = x[r:r + rows]
        noise = rounding_noise(_flat_index(
            (offsets[0] + r,) + offsets[1:], part.shape, whole, x.device),
            seed)
        q = torch.clamp(torch.round(part / scale + noise), -127, 127)
        out[r:r + rows] = q.to(torch.int8).to(torch.float32) * scale
    return out


def roundtrip_leaf(g: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """A whole leaf through :func:`int8_roundtrip` at its own scale, in
    its dtype (the train step's int8 bottleneck)."""
    x = g.to(torch.float32)
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    return int8_roundtrip(x, scale, seed=seed).to(g.dtype)


@torch.no_grad()
def compress_with_feedback(grads, residuals, generator: torch.Generator):
    """grads+residual -> (int8-roundtripped grads, new residuals).

    The returned grads have passed through the int8 bottleneck; residuals
    carry the quantization error to the next step.  Each leaf's noise is
    the generator's next draw, leaf by leaf in tree order.
    """
    new_g, new_r = [], []
    for g, r in zip(leaves(grads), leaves(residuals)):
        target = g.to(torch.float32) + r
        q, s = quantize_int8(target, generator)
        deq = dequantize_int8(q, s)
        new_g.append(deq.to(g.dtype))
        new_r.append(target - deq)
    return unflatten(grads, new_g), unflatten(grads, new_r)


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(x: torch.Tensor, generator: torch.Generator,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """int8 quantize -> all-reduce -> dequant, across ``group`` (default:
    the world).

    Each rank quantizes its ``x`` stochastically (``quantize_int8``); the
    int32 codes are summed and the scales maxed across the ranks, and the
    sum is dequantized by the largest scale, as the JAX package's
    ``psum``/``pmax`` pair does inside ``shard_map``.  Every rank gets the
    same result.
    """
    q, s = quantize_int8(x, generator)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    smax = s.reshape(1).clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    return total.to(torch.float32) * smax[0]
