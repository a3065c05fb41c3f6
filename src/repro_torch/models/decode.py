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
Parameters and a cache placed on a mesh step through
``distributed/serve_spmd.py``, which runs the same layer walk
(``decode_layers``) with its own operations on the cache (``DecodeOps``).
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
               memory: Optional[torch.Tensor] = None,
               shardings=None) -> Params:
    """Zero caches for ``batch`` sequences of up to ``max_len`` tokens, on
    the parameters' device; the vlm's and encdec's cross-attention K/V from
    ``memory`` (the vision embeddings, or the encoder's input frames).
    With ``shardings`` (``sharding.cache_shardings``), or over parameters
    placed on a mesh, each entry is placed on the mesh as it is made
    (``serve_spmd.init_cache``)."""
    from repro_torch.distributed import serve_spmd
    if shardings is not None or serve_spmd.is_placed(params):
        from repro_torch.models.registry import build
        return serve_spmd.init_cache(build(cfg), params, batch, max_len,
                                     memory, shardings)
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
    h = layers.rmsnorm(x, ln, cfg.norm_eps)
    o = cross_attend(cfg, cross_query(cfg, attn._heads(h, xattn["wq"])),
                     ck, cv)
    return attn.attention_output(xattn, cfg, o[:, None])


def cross_query(cfg, q: torch.Tensor) -> torch.Tensor:
    """q (B, 1, Hq_pad, hd) -> its heads by KV group (B, 1, Hkv, g, hd)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    return q[:, :, :hq, :].reshape(q.shape[0], 1, hkv, hq // hkv,
                                   cfg.head_dim)


def cross_attend(cfg, qg, ck, cv) -> torch.Tensor:
    """qg (B, 1, Hkv, g, hd) over the memory's K/V: o (B, Hkv, g, hd)."""
    s = torch.einsum("bqhgd,bkhd->bhgk", qg.float(), ck.float()) \
        / np.sqrt(cfg.head_dim)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", p.to(cv.dtype), cv)


class DecodeOps:
    """The step's operations on a layer's weights and caches, here over
    plain tensors (the caches updated in place); ``distributed/
    serve_spmd.py`` gives the same operations over weights and a cache
    placed on a mesh."""

    @staticmethod
    def attention(p, cfg, h, cache_l, pos):
        return attn.decode_attention(p, cfg, h, cache_l, pos)[0]

    @staticmethod
    def mla(p, cfg, h, cache_l, pos):
        return mla.mla_decode(p, cfg, h, cache_l, pos)[0]

    @staticmethod
    def mamba(p, cfg, h, cache_l):
        return ssm.mamba2_decode(p, cfg, h, cache_l)[0]

    @staticmethod
    def cross(x, ln, xattn, cfg, ck, cv):
        return _cross_decode(x, ln, xattn, cfg, ck, cv)

    @staticmethod
    def ffn(p, h):
        return layers.swiglu(h, **p)

    @staticmethod
    def moe(p, cfg, h):
        # serving must not drop tokens: capacity == T (lossless dispatch)
        return moe.moe_block(
            p, cfg, h, capacity_factor=cfg.n_experts / cfg.n_experts_active)[0]


LOCAL = DecodeOps()


def _attn_ffn_decode(bp, cfg, x, cache_l, pos, use_moe: bool = False,
                     ops: DecodeOps = LOCAL):
    h = layers.rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a = ops.mla(bp["attn"], cfg, h, cache_l, pos)
    else:
        a = ops.attention(bp["attn"], cfg, h, cache_l, pos)
    x = x + a
    h = layers.rmsnorm(x, bp["ln2"], cfg.norm_eps)
    f = ops.moe(bp["ffn"], cfg, h) if use_moe else ops.ffn(bp["ffn"], h)
    return x + f


def decode_layers(params: Params, cfg: ModelConfig, cache: Params,
                  x: torch.Tensor, pos: torch.Tensor,
                  ops: DecodeOps = LOCAL) -> torch.Tensor:
    """The embedded tokens x (B, 1, d) through every layer, each layer's
    weights taken by ``layer`` where it runs and its caches through
    ``ops``; returns the hidden state before the final norm."""
    fam = cfg.family
    blocks = params["blocks"]
    if fam in ("dense", "moe"):
        for i in range(cfg.first_dense_layers):
            x = _attn_ffn_decode(layer(params["dense_blocks"], i), cfg, x,
                                 layer(cache["dense_layers"], i), pos,
                                 ops=ops)
        for i in range(cfg.n_layers - cfg.first_dense_layers):
            x = _attn_ffn_decode(layer(blocks, i), cfg, x,
                                 layer(cache["layers"], i), pos,
                                 fam == "moe", ops)
    elif fam in ("ssm", "hybrid"):
        every = cfg.shared_attn_every
        for i in range(cfg.n_layers):
            if fam == "hybrid" and i % every == 0:
                x = _attn_ffn_decode(params["shared_block"], cfg, x,
                                     layer(cache["shared"], i // every),
                                     pos, ops=ops)
            bp = layer(blocks, i)
            h = layers.rmsnorm(x, bp["ln"], cfg.norm_eps)
            x = x + ops.mamba(bp["mixer"], cfg, h,
                              layer(cache["layers"], i))
    elif fam == "vlm":
        k = cfg.cross_attn_every
        for g in range(cfg.n_layers // k):
            xp = layer(params["cross_blocks"], g)
            h = ops.cross(x, xp["ln"], xp["xattn"], cfg,
                          cache["cross_k"][g], cache["cross_v"][g])
            x = x + torch.tanh(xp["xattn"]["gate"]) * h
            hh = layers.rmsnorm(x, xp["ln2"], cfg.norm_eps)
            x = x + torch.tanh(xp["ffn_gate"]) * ops.ffn(xp["ffn"], hh)
            for i in range(g * k, (g + 1) * k):
                x = _attn_ffn_decode(layer(blocks, i), cfg, x,
                                     layer(cache["layers"], i), pos,
                                     ops=ops)
    elif fam == "encdec":
        for i in range(cfg.n_layers):
            xp = layer(params["cross_blocks"], i)
            x = x + ops.cross(x, xp["ln"], xp["xattn"], cfg,
                              cache["cross_k"][i], cache["cross_v"][i])
            x = _attn_ffn_decode(layer(blocks, i), cfg, x,
                                 layer(cache["layers"], i), pos, ops=ops)
    else:
        raise ValueError(fam)
    return x


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """tokens (B, 1) int, pos (B,) int -> (logits (B,1,V) f32, cache).
    Parameters and a cache placed on a mesh step through
    ``distributed/serve_spmd.py``, whose logits are a ``Sharded``."""
    from repro_torch.distributed import serve_spmd
    if serve_spmd.is_placed(params) or serve_spmd.is_placed(cache):
        from repro_torch.models.registry import build
        return serve_spmd.decode_step(build(cfg), params, cache, tokens,
                                      pos)
    with full_fp32_matmul():
        params = cast_compute(params, cfg)
        x = _compute(params["embed"][tokens], cfg)
        x = decode_layers(params, cfg, cache, x, pos)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return lm_logits(params, cfg, x), cache
