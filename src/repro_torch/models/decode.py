"""Single-token decode with per-family caches (the serve step).

The counterpart of the JAX package's ``repro.models.decode`` for the
``dense``, ``ssm`` and ``hybrid`` families.  Cache layouts, stacked over
layers as in the JAX package:

  dense  : ``layers`` {k, v} (L, B, len, Hkv, hd), a ring buffer of the
           window's length for sliding-window archs, else ``max_len``
  ssm    : ``layers`` {state (L, B, H, P, N) f32, conv (L, B, R-1, C)}:
           O(1) memory in the context length
  hybrid : the ssm caches and ``shared`` {k, v} (n_inv, B, len, Hkv, hd),
           one per invocation of the shared attention block

``decode_step`` writes each layer's new entries into the cache in place
(the JAX launcher donates its cache to the step) and returns the cache.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import full_fp32_matmul
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models.layers import Params, dtype_of
from repro_torch.models.transformer import (_compute, cast_compute,
                                            check_family, layer, lm_logits)


def _stack_map(fn, n: int) -> Params:
    return tree_util.tree_map(lambda *xs: torch.stack(xs),
                              *[fn() for _ in range(n)])


def init_cache(params: Params, cfg: ModelConfig, batch: int, max_len: int,
               memory: Optional[torch.Tensor] = None) -> Params:
    """Zero caches for ``batch`` sequences of up to ``max_len`` tokens, on
    the parameters' device.  ``memory`` is the JAX signature's (the
    vlm/encdec cross-attention memory); it has no use in this slice."""
    check_family(cfg)
    dtype = dtype_of(cfg.compute_dtype)
    device = params["embed"].device
    cache: Params = {}
    if cfg.family == "dense":
        cache["layers"] = _stack_map(
            lambda: attn.init_kv_cache(cfg, batch, max_len, dtype, device),
            cfg.n_layers)
    else:
        cache["layers"] = _stack_map(
            lambda: ssm.init_mamba2_cache(cfg, batch, dtype, device),
            cfg.n_layers)
        if cfg.family == "hybrid":
            n_inv = -(-cfg.n_layers // cfg.shared_attn_every)
            cache["shared"] = _stack_map(
                lambda: attn.init_kv_cache(cfg, batch, max_len, dtype,
                                           device), n_inv)
    return cache


def _attn_ffn_decode(bp, cfg, x, cache_l, pos):
    h = layers.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    a, _ = attn.decode_attention(bp["attn"], cfg, h, cache_l, pos)
    x = x + a
    h = layers.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    return x + layers.swiglu(h, **bp["ffn"])


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """tokens (B, 1) int, pos (B,) int -> (logits (B,1,V) f32, cache)."""
    check_family(cfg)
    with full_fp32_matmul():
        params = cast_compute(params, cfg)
        x = _compute(params["embed"][tokens], cfg)
        blocks = params["blocks"]
        if cfg.family == "dense":
            for i in range(cfg.n_layers):
                x = _attn_ffn_decode(layer(blocks, i), cfg, x,
                                     layer(cache["layers"], i), pos)
        else:
            every = cfg.shared_attn_every
            for i in range(cfg.n_layers):
                if cfg.family == "hybrid" and i % every == 0:
                    x = _attn_ffn_decode(params["shared_block"], cfg, x,
                                         layer(cache["shared"], i // every),
                                         pos)
                bp = layer(blocks, i)
                h = layers.rmsnorm(x, bp["ln"], cfg.norm_eps)
                y, _ = ssm.mamba2_decode(bp["mixer"], cfg, h,
                                         layer(cache["layers"], i))
                x = x + y
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return lm_logits(params, cfg, x), cache
