"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

The counterpart of the JAX package's ``repro.models.mla``; autograd
gives its gradients (held to ``jax.grad``'s in the tests).
Queries and keys/values are projected through low-rank latents; the KV
cache stores only the compressed latent ``c_kv`` (``kv_lora_rank``) and
the decoupled RoPE key (``qk_rope_head_dim``).

  * prefill: K_nope and V are expanded from the latent and run through
    the online-softmax ``attention.flash_attention`` (q/k width
    dn + dr, v width dv);
  * decode: the absorbed form, W_UK folded into the query and W_UV into
    the output, so attention runs against the latent cache itself.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.attention import NEG_INF, flash_attention
from repro_torch.models.layers import Params


def init_mla(generator, cfg, dtype) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    device = generator.device
    return {
        "wq_a": layers.dense_init(generator, d, qr, dtype),
        "q_a_norm": layers.init_rmsnorm(qr, dtype, device),
        "wq_b": layers.dense_init(generator, qr, H * (dn + dr), dtype),
        "wkv_a": layers.dense_init(generator, d, kr + dr, dtype),
        "kv_a_norm": layers.init_rmsnorm(kr, dtype, device),
        "wkv_b": layers.dense_init(generator, kr, H * (dn + dv), dtype),
        "wo": layers.dense_init(generator, H * dv, d, dtype),
    }


def _mla_q(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    q_lat = layers.rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    return q_heads(cfg, q_lat @ p["wq_b"], positions)


def q_heads(cfg, q: torch.Tensor, positions: torch.Tensor):
    """The query's product (B, S, n * (dn + dr)) -> q_nope, q_rope (RoPE
    applied), for the n heads it holds (all H, or a block's)."""
    B, S, _ = q.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = q.reshape(B, S, -1, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(p: Params, cfg, x: torch.Tensor,
                   positions: torch.Tensor):
    return kv_latent(p, cfg, x @ p["wkv_a"], positions)


def kv_latent(p: Params, cfg, kv_a: torch.Tensor, positions: torch.Tensor):
    """The latent's product (B, S, kr + dr) -> c_kv (normed), k_rope."""
    c_kv = layers.rmsnorm(kv_a[..., :cfg.kv_lora_rank], p["kv_a_norm"],
                          cfg.norm_eps)
    k_rope = layers.apply_rope(
        kv_a[..., cfg.kv_lora_rank:][:, :, None, :], positions,
        cfg.rope_theta)[:, :, 0, :]                   # (B, S, dr)
    return c_kv, k_rope


def _split_wkv_b(p: Params, cfg):
    H = cfg.n_heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    w = p["wkv_b"].reshape(cfg.kv_lora_rank, H, dn + dv)
    return w[..., :dn], w[..., dn:]                  # (kr,H,dn), (kr,H,dv)


def _expand_kv(p: Params, cfg, c_kv: torch.Tensor):
    """Latent -> per-head K_nope / V."""
    w_uk, w_uv = _split_wkv_b(p, cfg)
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, w_uk)
    v = torch.einsum("bsr,rhd->bshd", c_kv, w_uv)
    return k_nope, v


def mla_block(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor
              ) -> torch.Tensor:
    """Causal MLA (prefill): K/V expanded from the latent per layer."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dr = cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    k_nope, v = _expand_kv(p, cfg, c_kv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    o = flash_attention(q[:, :, :, None, :], k, v, causal=True)
    return o.reshape(B, S, -1) @ p["wo"]


def init_mla_cache(cfg, batch: int, max_len: int, dtype,
                   device="cuda") -> Params:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Params,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Absorbed one-token MLA decode against the latent cache: x (B, 1, d),
    pos (B,).  Writes this step's latent and RoPE key into ``cache`` in
    place and returns it."""
    B, H, dv = x.shape[0], cfg.n_heads, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None])      # (B,1,H,*)
    c_new, r_new = _mla_kv_latent(p, cfg, x, pos[:, None])
    w_uk, w_uv = _split_wkv_b(p, cfg)
    # absorb W_UK into the query: q_eff (B, H, kr)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    o_lat = latent_attend(cfg, q_eff, q_rope[:, 0], c_new, r_new, cache,
                          pos)
    # absorb W_UV on the way out
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)           # (B, H, dv)
    out = o.reshape(B, 1, H * dv) @ p["wo"]
    return out, cache


def latent_attend(cfg, q_eff: torch.Tensor, q_rope: torch.Tensor,
                  c_new: torch.Tensor, r_new: torch.Tensor, cache: Params,
                  pos: torch.Tensor) -> torch.Tensor:
    """The step's latent and RoPE key (B, 1, *) written into ``cache`` at
    ``pos``, then the absorbed query's (q_eff (B, H, kr), q_rope (B, H,
    dr)) attention in latent space: o_lat (B, H, kr)."""
    B = q_eff.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    L = c_cache.shape[1]
    # a start past the end clamps, as lax.dynamic_update_slice's does
    slot = torch.clamp(pos, max=L - 1).long()
    rows = torch.arange(B, device=q_eff.device)
    c_cache[rows, slot] = c_new[:, 0].to(c_cache.dtype)
    r_cache[rows, slot] = r_new[:, 0].to(r_cache.dtype)
    s = (torch.einsum("bhr,bkr->bhk", q_eff.float(), c_cache.float())
         + torch.einsum("bhd,bkd->bhk", q_rope.float(),
                        r_cache.float())) / np.sqrt(dn + dr)
    valid = torch.arange(L, device=q_eff.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    attn = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkr->bhr", attn.to(c_cache.dtype), c_cache)
