"""Shared building blocks of the LM zoo (functional, parameter trees).

The counterpart of the JAX package's ``repro.models.layers``:

  * parameters are nested dicts of tensors in the JAX package's layout;
    layer stacks carry a leading ``n_layers`` axis, and the models loop
    over it in Python where the JAX package scans;
  * the ``init_*`` functions draw from an explicit ``torch.Generator``, on
    the generator's device;
  * compute runs in ``compute_dtype`` (bf16 by default), parameters are
    stored in ``param_dtype``; norms, logits and losses in f32.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def version(t: torch.Tensor) -> Optional[int]:
    """A tensor's in-place version counter; None for an inference tensor,
    which keeps none."""
    try:
        return t._version
    except RuntimeError:
        return None


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------
class AbstractGenerator:
    """Stands in for a ``torch.Generator`` where only a tree's shapes and
    dtypes are wanted (``Model.init_abstract``): every draw is an empty
    tensor on the meta device, which allocates nothing."""

    device = torch.device("meta")


ABSTRACT = AbstractGenerator()


def normal(generator: torch.Generator, shape, std: float,
           dtype) -> torch.Tensor:
    """f32 normal draws times ``std`` on the generator's device, cast to
    ``dtype``; an empty meta tensor from :data:`ABSTRACT`."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0) -> torch.Tensor:
    return normal(generator, (d_in, d_out), scale / np.sqrt(d_in), dtype)


def embed_init(generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return normal(generator, (vocab, d), 0.02, dtype)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


def init_rmsnorm(d: int, dtype, device="cuda") -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def init_swiglu(generator, d: int, f: int, dtype) -> Params:
    return {"w_gate": dense_init(generator, d, f, dtype),
            "w_up": dense_init(generator, d, f, dtype),
            "w_down": dense_init(generator, f, d, dtype)}


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _frequencies(head_dim: int, theta: float, device: str) -> torch.Tensor:
    # once per device: a decode step would otherwise copy them to the card
    # twice a layer
    return torch.tensor(rope_frequencies(head_dim, theta),
                        dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    freqs = _frequencies(x.shape[-1], theta, str(x.device))
    angles = positions[..., :, None].float() * freqs      # (..., S, D/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (..., V) f32; labels (...,) int; mean over valid tokens."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
