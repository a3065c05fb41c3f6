"""Attention: GQA with an online-softmax loop over KV chunks, sliding
window, KV cache.

The counterpart of the JAX package's ``repro.models.attention``.  Prefill
and training run the online softmax over KV chunks (the JAX package's
``lax.scan``, here a Python loop with the same chunking, masks and
``NEG_INF``), so the (S x S) score matrix is never formed, and its
backward recomputes the scores chunk by chunk, as the JAX package's
custom VJP does.  Decode attends one query against the cache, a ring
buffer for sliding-window archs.

Products whose JAX form asks for f32 results from bf16 operands
(``preferred_element_type``) upcast the operands first: the products of
two bf16 numbers are exact in f32, so this is the same arithmetic.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.precision import full_fp32_matmul
from repro_torch.models import layers
from repro_torch.models.layers import Params

NEG_INF = -1e30


def padded_heads(cfg, n: int, pad_to: int = 16) -> int:
    """Head count padded up to a multiple of 16 (a 16-way model axis): dead
    heads start at zero, receive zero signal through the zero ``wo`` rows,
    and cost Hq_pad/Hq extra attention flops.  The port keeps the padded
    layout so weights carry across from the JAX package unchanged."""
    if n % pad_to == 0 or n < pad_to:
        return n
    return -(-n // pad_to) * pad_to


def init_attention(generator, cfg, dtype) -> Params:
    """Per-head QKV layout: wq (d, Hq_pad, hd), wk/wv (d, Hkv, hd), wo
    (Hq_pad, hd, d)."""
    d = cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hq_p = padded_heads(cfg, hq)
    device = generator.device

    def heads(n, n_pad):
        w = layers.dense_init(generator, d, n * hd, dtype).reshape(d, n, hd)
        if n_pad > n:
            w = torch.cat([w, torch.zeros((d, n_pad - n, hd), dtype=dtype,
                                          device=device)], dim=1)
        return w

    p = {"wq": heads(hq, hq_p), "wk": heads(hkv, hkv),
         "wv": heads(hkv, hkv)}
    wo = layers.dense_init(generator, hq * hd, d, dtype).reshape(hq, hd, d)
    if hq_p > hq:
        wo = torch.cat([wo, torch.zeros((hq_p - hq, hd, d), dtype=dtype,
                                        device=device)], dim=0)
    p["wo"] = wo
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq_p, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(hd, dtype, device)
        p["k_norm"] = layers.init_rmsnorm(hd, dtype, device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, n, hd) -> (B, S, n, hd)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                 rope: bool = True):
    """Returns q (B,S,Hq_pad,hd), k (B,S,Hkv,hd), v (B,S,Hkv,hd)."""
    return finish_qkv(p, cfg, _heads(x, p["wq"]), _heads(x, p["wk"]),
                      _heads(x, p["wv"]), positions, rope)


def finish_qkv(p: Params, cfg, q, k, v, positions: torch.Tensor,
               rope: bool = True):
    """The projected heads' bias, norm and RoPE (per head, so a step that
    projects the heads block by block finishes them joined)."""
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def expand_kv_padded(k: torch.Tensor, cfg) -> torch.Tensor:
    """(B,S,Hkv,hd) -> (B,S,Hq_pad,hd): per-q-head KV copies.  Padded head
    slots reuse kv head 0 (their outputs meet zero ``wo`` rows)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    hq_p = padded_heads(cfg, hq)
    g = hq // hkv
    out = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    if hq_p > hq:
        pad = out[:, :, :1, :].expand(*out.shape[:2], hq_p - hq,
                                      out.shape[-1])
        out = torch.cat([out, pad], dim=2)
    return out


def attention_output(p: Params, cfg, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,n,1,hd) or (B,S,n,hd) -> (B,S,d); n may be Hq or Hq_pad
    (``wo`` rows are sliced to match; padded rows are zero anyway)."""
    B, S = o.shape[:2]
    o = o.reshape(B, S, -1, cfg.head_dim)
    wo = p["wo"][:o.shape[2]]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _chunk_mask(Sq, Sk, chunk, cidx, causal, window, q_offset, device):
    q_pos = q_offset + torch.arange(Sq, device=device)
    k_pos = cidx * chunk + torch.arange(chunk, device=device)
    mask = (k_pos[None, :] <= q_pos[:, None]) if causal else \
        torch.ones((Sq, chunk), dtype=torch.bool, device=device)
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask & (k_pos < Sk)[None, :]


def _flash_prep(k, v, chunk):
    """Chunk length and count, and k, v zero-padded to whole chunks."""
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, chunk, n_chunks


def _flash_fwd_scan(qg, kp, vp, Sq, Sk, chunk, n_chunks, causal, window,
                    q_offset, scale):
    """The online softmax over the KV chunks: (m, l, acc) in f32."""
    B, _, Hkv, groups, _ = qg.shape
    Dv = vp.shape[-1]
    q32 = qg.float()
    m = torch.full((B, Sq, Hkv, groups), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((B, Sq, Hkv, groups), dtype=torch.float32,
                    device=qg.device)
    acc = torch.zeros((B, Sq, Hkv, groups, Dv), dtype=torch.float32,
                      device=qg.device)
    for c in range(n_chunks):
        kb = kp[:, c * chunk:(c + 1) * chunk]
        vb = vp[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", q32, kb.float()) * scale
        mask = _chunk_mask(Sq, Sk, chunk, c, causal, window, q_offset,
                           qg.device)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    return m, l, acc


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``_flash_core`` and its memory-lean VJP.

    The forward saves q, k, v, the softmax's running max ``m`` and sum
    ``l`` and the f32 output before its cast (JAX's residuals: ``delta``
    reads the uncast output); the backward recomputes each chunk's scores
    from them, so no (Sq x Sk) probability tensor is ever saved.  Its
    products run in IEEE float32 on cuBLAS (``full_fp32_matmul``)."""

    @staticmethod
    def forward(ctx, qg, k, v, causal, window, q_offset, chunk):
        Sq, D = qg.shape[1], qg.shape[-1]
        Sk = k.shape[1]
        kp, vp, chunk_, n_chunks = _flash_prep(k, v, chunk)
        m, l, acc = _flash_fwd_scan(qg, kp, vp, Sq, Sk, chunk_, n_chunks,
                                    causal, window, q_offset,
                                    1.0 / np.sqrt(D))
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        ctx.save_for_backward(qg, k, v, m, l, out)
        ctx.opts = (causal, window, q_offset, chunk)
        return out.to(qg.dtype)

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, m, l, out = ctx.saved_tensors
        causal, window, q_offset, chunk = ctx.opts
        B, Sq, Hkv, groups, D = qg.shape
        Sk = k.shape[1]
        scale = 1.0 / np.sqrt(D)
        kp, vp, chunk_, n_chunks = _flash_prep(k, v, chunk)
        dout_g = dout.float()
        # D_i = sum_d dout_i * out_i (the softmax normalization's term)
        delta = torch.sum(dout_g * out, dim=-1)           # (B,Sq,Hkv,g)
        l_safe = torch.clamp_min(l, 1e-30)
        q32 = qg.float()
        dq = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
        dk, dv = [], []
        with full_fp32_matmul():
            for c in range(n_chunks):
                kb = kp[:, c * chunk_:(c + 1) * chunk_].float()
                vb = vp[:, c * chunk_:(c + 1) * chunk_].float()
                s = torch.einsum("bqhgd,bkhd->bqhgk", q32, kb) * scale
                mask = _chunk_mask(Sq, Sk, chunk_, c, causal, window,
                                   q_offset, qg.device)
                s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
                p = torch.exp(s - m[..., None]) / l_safe[..., None]
                dv.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dout_g))
                dp = torch.einsum("bqhgd,bkhd->bqhgk", dout_g, vb)
                ds = p * (dp - delta[..., None]) * scale
                dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
                dk.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, q32))
        dk = torch.cat(dk, dim=1)[:, :Sk]
        dv = torch.cat(dv, dim=1)[:, :Sk]
        return (dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def flash_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention with a memory-lean backward
    (``_FlashAttention``).

    qg: (B, Sq, Hkv, g, D) grouped queries; k/v: (B, Sk, Hkv, Dv); MLA
    passes Dv != D (g = 1).  ``window > 0`` restricts attention to the
    last ``window`` keys (sliding window).  ``q_offset`` is the absolute
    position of q[0] relative to k[0].  Returns (B, Sq, Hkv, g, Dv) in q's
    dtype.
    """
    return _FlashAttention.apply(qg, k, v, causal, window, q_offset, chunk)


def attention_block(p: Params, cfg, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Prefill self-attention (causal)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = flash_attention(q[:, :, :, None, :], expand_kv_padded(k, cfg),
                        expand_kv_padded(v, cfg), causal=True,
                        window=cfg.sliding_window)
    return attention_output(p, cfg, o)


# --------------------------------------------------------------------------
# KV cache (decode)
# --------------------------------------------------------------------------
def init_kv_cache(cfg, batch: int, max_len: int, dtype,
                  device="cuda") -> Params:
    """Ring buffer when sliding-window, else full-length cache."""
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Params, cfg, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One-token decode: x (B, 1, d), pos (B,) absolute positions.

    Writes this step's K and V into ``cache`` in place (the JAX launcher
    donates its cache to the step) and returns it.
    """
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    o = decode_attend(cfg, q, k, v, cache, pos)
    return attention_output(p, cfg, o[:, None]), cache


def decode_attend(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache: Params, pos: torch.Tensor) -> torch.Tensor:
    """The step's k, v (B, 1, Hkv, hd) written into ``cache`` at ``pos``,
    then q's (B, 1, Hq_pad, hd) attention over it: o (B, Hkv, g, hd)."""
    B = q.shape[0]
    length = cache["k"].shape[1]
    slot = (pos % length) if cfg.sliding_window else pos
    # a start past the end clamps, as lax.dynamic_update_slice's does
    slot = torch.clamp(slot, max=length - 1).long()
    rows = torch.arange(B, device=q.device)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    k_cache, v_cache = cache["k"], cache["v"]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    groups = hq // hkv
    qg = q[:, :, :hq, :].reshape(B, 1, hkv, groups, hd)
    s = torch.einsum("bqhgd,bkhd->bhgk", qg.float(),
                     k_cache.float()) / np.sqrt(hd)
    idx = torch.arange(length, device=q.device)[None, :]
    if cfg.sliding_window:
        # ring buffer: once pos >= length every slot holds a key from the
        # window; before that only slots [0, pos] have been written
        valid = (idx <= (pos % length)[:, None]) | (pos[:, None] >= length)
    else:
        valid = idx <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", pattn.to(v_cache.dtype), v_cache)


# --------------------------------------------------------------------------
# Cross-attention (whisper decoder, llama-vision gated layers)
# --------------------------------------------------------------------------
def init_cross_attention(generator, cfg, dtype) -> Params:
    p = init_attention(generator, cfg, dtype)
    p["gate"] = torch.zeros((), dtype=dtype, device=generator.device)
    return p


def cross_attention_block(p: Params, cfg, x: torch.Tensor,
                          memory: torch.Tensor, gated: bool = False
                          ) -> torch.Tensor:
    """x (B,S,d) attends to memory (B,Sm,d); no RoPE, not causal."""
    q = _heads(x, p["wq"])
    k = _heads(memory, p["wk"])
    v = _heads(memory, p["wv"])
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.norm_eps)
    o = flash_attention(q[:, :, :, None, :], expand_kv_padded(k, cfg),
                        expand_kv_padded(v, cfg), causal=False)
    out = attention_output(p, cfg, o)
    if gated:
        out = torch.tanh(p["gate"]) * out
    return out
