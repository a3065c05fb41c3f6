"""Decoder-LM assembly for every architecture family of the zoo.

The counterpart of the JAX package's ``repro.models.transformer``,
forward only.  Families map to block stacks over stacked layer
parameters (a leading ``n_layers`` axis, the JAX package's layout); the
JAX package scans them, the port loops over the layer index:

  dense   : [norm->attn->res ; norm->swiglu->res] x L
  moe     : the same with the grouped-dispatch MoE FFN (``models.moe``),
            first-k dense layers, MLA attention (``models.mla``) and the
            MTP head for deepseek-v3
  ssm     : [norm->mamba2->res] x L
  hybrid  : the ssm stack with one weight-shared attention block invoked
            every ``shared_attn_every`` layers (zamba2)
  vlm     : groups of [gated cross-attn block ; k self-attn blocks]
  encdec  : bidirectional encoder stack + causal decoder w/ cross-attention

The vision and audio front ends are stubs, as in the JAX package: the
caller passes their embeddings as ``memory``.  On one device the JAX
package's ``remat`` and batch-sharding constraints have nothing to do, and
the port has neither.

Float32 products run in IEEE float32 on the card whatever TF32 the caller
allowed cuBLAS (``repro_torch.core.precision``): ``lm_hidden`` and
``lm_logits`` hold the guard.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import full_fp32_matmul
from repro_torch.models import attention as attn
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.layers import Params, dtype_of


# --------------------------------------------------------------------------
# block init/apply
# --------------------------------------------------------------------------
def init_decoder_block(generator, cfg: ModelConfig, dtype,
                       use_moe: bool) -> Params:
    device = generator.device
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": (mla.init_mla(generator, cfg, dtype) if cfg.use_mla
                 else attn.init_attention(generator, cfg, dtype)),
        "ffn": (moe.init_moe(generator, cfg, dtype) if use_moe
                else layers.init_swiglu(generator, cfg.d_model, cfg.d_ff,
                                        dtype)),
    }


def decoder_block(p: Params, cfg: ModelConfig, x, positions, use_moe: bool):
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a = mla.mla_block(p["attn"], cfg, h, positions)
    else:
        a = attn.attention_block(p["attn"], cfg, h, positions)
    x = x + a
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if use_moe:
        f, aux = moe.moe_block(p["ffn"], cfg, h)
    else:
        f = layers.swiglu(h, **p["ffn"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def init_mamba_layer(generator, cfg, dtype) -> Params:
    return {
        "ln": layers.init_rmsnorm(cfg.d_model, dtype, generator.device),
        "mixer": ssm.init_mamba2(generator, cfg, dtype),
    }


def mamba_layer(p: Params, cfg, x, conv_key: Optional[tuple] = None):
    h = layers.rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + ssm.mamba2_block(p["mixer"], cfg, h, conv_key)


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------
def _stack_init(fn, n: int):
    """Initialize n layers and stack their leaves along a leading axis.
    Each layer is drawn and copied into the stacked tensors in turn, so
    only one layer's tree is ever held beside them; one layer is its own
    tree with a leading axis of 1, copied nowhere (deepseek-v3's one MoE
    layer holds 45 GB in fp32)."""
    first = fn()
    if n == 1:
        return tree_util.tree_map(lambda a: a[None], first)
    stacked = tree_util.tree_map(
        lambda a: torch.empty((n,) + tuple(a.shape), dtype=a.dtype,
                              device=a.device), first)
    for i in range(n):
        layer = first if i == 0 else fn()
        tree_util.tree_map(lambda s, a: s[i].copy_(a), stacked, layer)
    return stacked


def layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views of the stacked tensors)."""
    return tree_util.tree_map(lambda a: a[i], stacked)


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """The JAX package's ``init_lm`` tree, drawn from ``generator`` on its
    device."""
    dtype = dtype_of(cfg.param_dtype)
    V, d = cfg.padded_vocab, cfg.d_model
    device = generator.device
    p: Params = {
        "embed": layers.embed_init(generator, V, d, dtype),
        "final_norm": layers.init_rmsnorm(d, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(generator, d, V, dtype)

    def block(use_moe):
        return lambda: init_decoder_block(generator, cfg, dtype, use_moe)

    fam = cfg.family
    if fam in ("dense", "moe"):
        if cfg.first_dense_layers:
            p["dense_blocks"] = _stack_init(block(False),
                                            cfg.first_dense_layers)
        p["blocks"] = _stack_init(block(fam == "moe"),
                                  cfg.n_layers - cfg.first_dense_layers)
        if cfg.mtp_depth:
            p["mtp"] = {
                "proj": layers.dense_init(generator, 2 * d, d, dtype),
                "block": block(fam == "moe")(),
                "norm": layers.init_rmsnorm(d, dtype, device),
            }
    elif fam in ("ssm", "hybrid"):
        p["blocks"] = _stack_init(
            lambda: init_mamba_layer(generator, cfg, dtype), cfg.n_layers)
        if fam == "hybrid":
            p["shared_block"] = block(False)()
    elif fam == "vlm":
        p["blocks"] = _stack_init(block(False), cfg.n_layers)
        p["cross_blocks"] = _stack_init(
            lambda: {
                "ln": layers.init_rmsnorm(d, dtype, device),
                "xattn": attn.init_cross_attention(generator, cfg, dtype),
                "ln2": layers.init_rmsnorm(d, dtype, device),
                "ffn": layers.init_swiglu(generator, d, cfg.d_ff, dtype),
                "ffn_gate": torch.zeros((), dtype=dtype, device=device),
            }, cfg.n_layers // cfg.cross_attn_every)
    elif fam == "encdec":
        p["enc_blocks"] = _stack_init(block(False), cfg.encoder_layers)
        p["enc_norm"] = layers.init_rmsnorm(d, dtype, device)
        p["blocks"] = _stack_init(block(False), cfg.n_layers)
        p["cross_blocks"] = _stack_init(
            lambda: {
                "ln": layers.init_rmsnorm(d, dtype, device),
                "xattn": attn.init_attention(generator, cfg, dtype),
            }, cfg.n_layers)
    else:
        raise ValueError(fam)
    return p


# --------------------------------------------------------------------------
# the compute copy
# --------------------------------------------------------------------------
class _CastCache:
    """The compute-dtype copy of a parameter tree, made once per tree
    version.  The JAX package casts the whole tree on every call and XLA
    fuses the cast away under jit; eagerly, a bf16 decode step of
    phi4-mini would read 15.5 GB and write 7.8 GB.  An entry is keyed on
    every leaf's identity and in-place version and pins the leaves, so the
    identities stay valid and an updated tree is cast anew; the copy has
    the same bits as a fresh cast.  Trees that autograd records through
    are cast on every call and never cached."""

    def __init__(self, maxsize: int = 2):
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()

    def get(self, params: Params, dtype: torch.dtype) -> Params:
        leaves = tree_util.leaves(params)
        floating = [a for a in leaves if isinstance(a, torch.Tensor)
                    and a.is_floating_point() and a.dtype != dtype]
        if not floating:
            return params
        cast = lambda a: a.to(dtype) if isinstance(a, torch.Tensor) \
            and a.is_floating_point() else a                  # noqa: E731
        if torch.is_grad_enabled() and any(a.requires_grad for a in floating):
            return tree_util.tree_map(cast, params)
        key = (dtype,) + tuple((id(a), layers.version(a)) for a in leaves)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                return entry[1]
        out = tree_util.tree_map(cast, params)
        with self._lock:
            while len(self._entries) >= self._maxsize:
                self._entries.popitem(last=False)
            self._entries[key] = (leaves, out)
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_CAST = _CastCache()


def cast_compute(params: Params, cfg: ModelConfig) -> Params:
    """Floating parameters in the compute dtype: the tree itself where
    they already are, else a copy made once per tree version
    (``_CastCache``)."""
    return _CAST.get(params, dtype_of(cfg.compute_dtype))


def clear_compute_cache() -> None:
    """Drop the cached compute copies (a served model's bf16 weights)."""
    _CAST.clear()


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------
def _compute(x, cfg):
    return x.to(dtype_of(cfg.compute_dtype))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def lm_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
              memory: Optional[torch.Tensor] = None,
              remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids -> final hidden states. Returns (hidden, aux_loss).
    ``memory`` is the vlm's vision embeddings or the encdec's encoder
    output; ``remat`` is the JAX signature's (rematerialization), with no
    use in a forward."""
    fam = cfg.family
    if fam in ("vlm", "encdec") and memory is None:
        raise ValueError(f"the {fam} family needs its memory (the vision "
                         f"embeddings or the encoder output)")
    with full_fp32_matmul():
        params = cast_compute(params, cfg)
        B, S = tokens.shape
        x = _compute(params["embed"][tokens], cfg)
        positions = _positions(B, S, x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        blocks = params["blocks"]
        if fam in ("dense", "moe"):
            if cfg.first_dense_layers:
                for i in range(cfg.first_dense_layers):
                    x, _ = decoder_block(layer(params["dense_blocks"], i),
                                         cfg, x, positions, False)
            auxes = []
            for i in range(cfg.n_layers - cfg.first_dense_layers):
                x, aux = decoder_block(layer(blocks, i), cfg, x, positions,
                                       fam == "moe")
                auxes.append(aux)
            if auxes:
                aux_total = aux_total + torch.sum(torch.stack(auxes))
        elif fam in ("ssm", "hybrid"):
            shared = params.get("shared_block")
            conv_w = blocks["mixer"]["conv_w"]
            for i in range(cfg.n_layers):
                if shared is not None and i % cfg.shared_attn_every == 0:
                    x, _ = decoder_block(shared, cfg, x, positions, False)
                key = ssm.conv_cache_key(("blocks", "mixer", "conv_w"), i,
                                         conv_w)
                x = mamba_layer(layer(blocks, i), cfg, x, key)
        elif fam == "vlm":
            mem = _compute(memory, cfg)
            k = cfg.cross_attn_every
            for g in range(cfg.n_layers // k):
                cross = layer(params["cross_blocks"], g)
                h = layers.rmsnorm(x, cross["ln"], cfg.norm_eps)
                x = x + attn.cross_attention_block(cross["xattn"], cfg, h,
                                                   mem, gated=True)
                h = layers.rmsnorm(x, cross["ln2"], cfg.norm_eps)
                x = x + torch.tanh(cross["ffn_gate"]) * layers.swiglu(
                    h, **cross["ffn"])
                for i in range(g * k, (g + 1) * k):
                    x, _ = decoder_block(layer(blocks, i), cfg, x,
                                         positions, False)
        elif fam == "encdec":
            for i in range(cfg.n_layers):
                xp = layer(params["cross_blocks"], i)
                h = layers.rmsnorm(x, xp["ln"], cfg.norm_eps)
                x = x + attn.cross_attention_block(xp["xattn"], cfg, h,
                                                   memory)
                x, _ = decoder_block(layer(blocks, i), cfg, x, positions,
                                     False)
        else:
            raise ValueError(fam)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def encoder_forward(params: Params, cfg: ModelConfig,
                    frames: torch.Tensor) -> torch.Tensor:
    """The whisper encoder over stub frame embeddings (B, S_enc, d):
    bidirectional self-attention blocks, then ``enc_norm``."""
    with full_fp32_matmul():
        params = cast_compute(params, cfg)
        x = _compute(frames, cfg)
        B, S, _ = x.shape
        positions = _positions(B, S, x.device)
        enc = params["enc_blocks"]
        for i in range(cfg.encoder_layers):
            bp = layer(enc, i)
            h = layers.rmsnorm(x, bp["ln1"], cfg.norm_eps)
            q, k, v = attn._project_qkv(bp["attn"], cfg, h, positions)
            a = attn.flash_attention(q[:, :, :, None, :],
                                     attn.expand_kv_padded(k, cfg),
                                     attn.expand_kv_padded(v, cfg),
                                     causal=False)
            x = x + attn.attention_output(bp["attn"], cfg, a)
            h = layers.rmsnorm(x, bp["ln2"], cfg.norm_eps)
            x = x + layers.swiglu(h, **bp["ffn"])
        return layers.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    with full_fp32_matmul():
        return (hidden @ head.to(hidden.dtype)).float()


def lm_loss(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss's forward: cross entropy over ``batch["labels"]``,
    the MTP term (deepseek-v3: token t + 2 from the hidden state at t and
    the embedding of t + 1, weighted 0.3) and the router's auxiliary loss.
    ``batch`` carries ``vision`` (vlm) or ``frames`` (encdec) beside the
    tokens."""
    params = cast_compute(params, cfg)
    memory = batch.get("vision", batch.get("frames"))
    if cfg.family == "encdec":
        memory = encoder_forward(params, cfg, batch["frames"])
    hidden, aux = lm_hidden(params, cfg, batch["tokens"], memory)
    logits = lm_logits(params, cfg, hidden)
    loss = layers.cross_entropy_loss(logits, batch["labels"])
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth:
        with full_fp32_matmul():
            emb_next = _compute(params["embed"][batch["tokens"]], cfg)
            h_in = torch.cat([hidden[:, :-1, :], emb_next[:, 1:, :]],
                             dim=-1)
            h_mtp = h_in @ params["mtp"]["proj"]
            B, S1, _ = h_mtp.shape
            h_mtp, _ = decoder_block(params["mtp"]["block"], cfg, h_mtp,
                                     _positions(B, S1, h_mtp.device),
                                     cfg.family == "moe")
            h_mtp = layers.rmsnorm(h_mtp, params["mtp"]["norm"],
                                   cfg.norm_eps)
        mtp_logits = lm_logits(params, cfg, h_mtp)
        mtp_loss = layers.cross_entropy_loss(mtp_logits[:, :-1],
                                             batch["labels"][:, 2:])
        metrics["mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    loss = loss + cfg.router_aux_coef * aux
    metrics["loss"] = loss
    return loss, metrics
