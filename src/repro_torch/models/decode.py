"""Single-token decode with per-family caches (the serve step).

The counterpart of the JAX package's ``repro.models.decode``.  Cache
layouts, stacked over layers as in the JAX package:

  dense/moe : ``layers`` {k, v} (L, B, len, Hkv, hd), a ring buffer of the
              window's length for sliding-window archs, else ``max_len``;
              MLA archs keep the latent {c_kv (L, B, len, kr), k_rope (L,
              B, len, dr)} instead; ``dense_layers`` for the first-k dense
              layers
  ssm       : ``layers`` {state (L, B, H, P, N) f32, conv (L, B, R-1, C)}:
              O(1) memory in the context length
  hybrid    : the ssm caches and ``shared`` {k, v} (n_inv, B, len, Hkv,
              hd), one per invocation of the shared attention block
  vlm/encdec: self-attention caches and ``cross_k``/``cross_v`` (n, B, Sm,
              Hkv, hd), computed once from the memory at cache init

``decode_step`` writes each layer's new entries into the cache in place
(the JAX launcher donates its cache to the step) and returns the cache.
The MoE FFN decodes losslessly (capacity = T: no token dropped).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import full_fp32_matmul
from repro_torch.models import attention as attn
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.layers import Params, dtype_of
from repro_torch.models.transformer import (_compute, cast_compute,
                                            encoder_forward, layer,
                                            lm_logits)


def _stack_map(fn, n: int) -> Params:
    return tree_util.tree_map(lambda *xs: torch.stack(xs),
                              *[fn() for _ in range(n)])


def _cross_kv(xattn_params, cfg, memory):
    return (attn._heads(memory, xattn_params["wk"]),
            attn._heads(memory, xattn_params["wv"]))


def _cross_caches(cache: Params, cross_blocks: Params, cfg, memory,
                  n: int) -> None:
    ks, vs = zip(*(_cross_kv(layer(cross_blocks, i)["xattn"], cfg, memory)
                   for i in range(n)))
    cache["cross_k"] = torch.stack(ks)
    cache["cross_v"] = torch.stack(vs)


def init_cache(params: Params, cfg: ModelConfig, batch: int, max_len: int,
               memory: Optional[torch.Tensor] = None) -> Params:
    """Zero caches for ``batch`` sequences of up to ``max_len`` tokens, on
    the parameters' device; the vlm's and encdec's cross-attention K/V from
    ``memory`` (the vision embeddings, or the encoder's input frames)."""
    params = cast_compute(params, cfg)
    dtype = dtype_of(cfg.compute_dtype)
    device = params["embed"].device
    fam = cfg.family

    def kv():
        return attn.init_kv_cache(cfg, batch, max_len, dtype, device)

    cache: Params = {}
    if fam in ("dense", "moe"):
        per_layer = (
            (lambda: mla.init_mla_cache(cfg, batch, max_len, dtype, device))
            if cfg.use_mla else kv)
        cache["layers"] = _stack_map(per_layer,
                                     cfg.n_layers - cfg.first_dense_layers)
        if cfg.first_dense_layers:
            cache["dense_layers"] = _stack_map(per_layer,
                                               cfg.first_dense_layers)
    elif fam in ("ssm", "hybrid"):
        cache["layers"] = _stack_map(
            lambda: ssm.init_mamba2_cache(cfg, batch, dtype, device),
            cfg.n_layers)
        if fam == "hybrid":
            cache["shared"] = _stack_map(
                kv, -(-cfg.n_layers // cfg.shared_attn_every))
    elif fam in ("vlm", "encdec"):
        if memory is None:
            raise ValueError(f"the {fam} cache needs its memory (the vision "
                             f"embeddings or the encoder frames)")
        cache["layers"] = _stack_map(kv, cfg.n_layers)
        with full_fp32_matmul():
            if fam == "vlm":
                _cross_caches(cache, params["cross_blocks"], cfg,
                              _compute(memory, cfg),
                              cfg.n_layers // cfg.cross_attn_every)
            else:
                _cross_caches(cache, params["cross_blocks"], cfg,
                              encoder_forward(params, cfg, memory),
                              cfg.n_layers)
    else:
        raise ValueError(fam)
    return cache


def _cross_decode(x, ln, xattn, cfg, ck, cv):
    """One-token cross-attention against precomputed memory K/V."""
    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    h = layers.rmsnorm(x, ln, cfg.norm_eps)
    qg = attn._heads(h, xattn["wq"])[:, :, :hq, :].reshape(B, 1, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgk", qg.float(), ck.float()) \
        / np.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(cv.dtype), cv)
    return attn.attention_output(xattn, cfg, o[:, None])


def _attn_ffn_decode(bp, cfg, x, cache_l, pos, use_moe: bool = False):
    h = layers.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, _ = mla.mla_decode(bp["attn"], cfg, h, cache_l, pos)
    else:
        a, _ = attn.decode_attention(bp["attn"], cfg, h, cache_l, pos)
    x = x + a
    h = layers.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    if use_moe:
        # serving must not drop tokens: capacity == T (lossless dispatch)
        f, _ = moe.moe_block(
            bp["ffn"], cfg, h,
            capacity_factor=cfg.n_experts / cfg.n_experts_active)
    else:
        f = layers.swiglu(h, **bp["ffn"])
    return x + f


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """tokens (B, 1) int, pos (B,) int -> (logits (B,1,V) f32, cache)."""
    fam = cfg.family
    with full_fp32_matmul():
        params = cast_compute(params, cfg)
        x = _compute(params["embed"][tokens], cfg)
        blocks = params["blocks"]
        if fam in ("dense", "moe"):
            for i in range(cfg.first_dense_layers):
                x = _attn_ffn_decode(layer(params["dense_blocks"], i), cfg,
                                     x, layer(cache["dense_layers"], i), pos)
            for i in range(cfg.n_layers - cfg.first_dense_layers):
                x = _attn_ffn_decode(layer(blocks, i), cfg, x,
                                     layer(cache["layers"], i), pos,
                                     fam == "moe")
        elif fam in ("ssm", "hybrid"):
            every = cfg.shared_attn_every
            for i in range(cfg.n_layers):
                if fam == "hybrid" and i % every == 0:
                    x = _attn_ffn_decode(params["shared_block"], cfg, x,
                                         layer(cache["shared"], i // every),
                                         pos)
                bp = layer(blocks, i)
                h = layers.rmsnorm(x, bp["ln"], cfg.norm_eps)
                y, _ = ssm.mamba2_decode(bp["mixer"], cfg, h,
                                         layer(cache["layers"], i))
                x = x + y
        elif fam == "vlm":
            k = cfg.cross_attn_every
            for g in range(cfg.n_layers // k):
                xp = layer(params["cross_blocks"], g)
                h = _cross_decode(x, xp["ln"], xp["xattn"], cfg,
                                  cache["cross_k"][g], cache["cross_v"][g])
                x = x + torch.tanh(xp["xattn"]["gate"]) * h
                hh = layers.rmsnorm(x, xp["ln2"], cfg.norm_eps)
                x = x + torch.tanh(xp["ffn_gate"]) * layers.swiglu(
                    hh, **xp["ffn"])
                for i in range(g * k, (g + 1) * k):
                    x = _attn_ffn_decode(layer(blocks, i), cfg, x,
                                         layer(cache["layers"], i), pos)
        elif fam == "encdec":
            for i in range(cfg.n_layers):
                xp = layer(params["cross_blocks"], i)
                x = x + _cross_decode(x, xp["ln"], xp["xattn"], cfg,
                                      cache["cross_k"][i],
                                      cache["cross_v"][i])
                x = _attn_ffn_decode(layer(blocks, i), cfg, x,
                                     layer(cache["layers"], i), pos)
        else:
            raise ValueError(fam)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return lm_logits(params, cfg, x), cache
