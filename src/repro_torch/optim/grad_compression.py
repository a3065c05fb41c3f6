"""Gradient compression with error feedback.

int8 stochastic quantization of gradients before the cross-replica
all-reduce cuts gradient-sync bytes 4x (f32) / 2x (bf16); the residual is
fed back into the next step so the *accumulated* update is unbiased
(error-feedback SGD, Seide et al. / Karimireddy et al.).

The rounding noise comes from an explicit ``torch.Generator``, so a run is
reproducible from its seed; it cannot match ``jax.random``'s draws, so the
port is held to the JAX package statistically.  ``compressed_psum`` (the
all-reduce itself) needs a process group and comes with the distributed
slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
