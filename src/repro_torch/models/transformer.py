"""Decoder-LM assembly for the ``dense``, ``ssm`` and ``hybrid`` families.

The counterpart of the JAX package's ``repro.models.transformer``,
forward only.  Families map to block stacks over stacked layer
parameters (a leading ``n_layers`` axis, the JAX package's layout); the
JAX package scans them, the port loops over the layer index:

  dense   : [norm->attn->res ; norm->swiglu->res] x L
  ssm     : [norm->mamba2->res] x L
  hybrid  : the ssm stack with one weight-shared attention block invoked
            every ``shared_attn_every`` layers (zamba2)

The ``moe`` family, MLA attention and the ``vlm`` and ``encdec`` families
raise ``NotImplementedError``: they are the next slice of the port.  On one
device the JAX package's ``remat`` and batch-sharding constraints have
nothing to do, and the port has neither.

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
from repro_torch.models import layers, ssm
from repro_torch.models.layers import Params, dtype_of

# where the next slice of the port brings what raises here
NEXT_SLICE = ("ROADMAP queue A, item A14: models/moe.py, models/mla.py and "
              "the moe, vlm and encdec families")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({NEXT_SLICE})")


def check_family(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise _unported(f"the {cfg.family} family ({cfg.name})")
    if cfg.use_mla:
        raise _unported(f"MLA attention ({cfg.name})")


# --------------------------------------------------------------------------
# block init/apply
# --------------------------------------------------------------------------
def init_decoder_block(generator, cfg: ModelConfig, dtype,
                       use_moe: bool) -> Params:
    if cfg.use_mla:
        raise _unported(f"MLA attention ({cfg.name})")
    if use_moe:
        raise _unported(f"the MoE FFN ({cfg.name})")
    device = generator.device
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": attn.init_attention(generator, cfg, dtype),
        "ffn": layers.init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype),
    }


def decoder_block(p: Params, cfg: ModelConfig, x, positions, use_moe: bool):
    if use_moe or cfg.use_mla:
        raise _unported(f"MoE and MLA blocks ({cfg.name})")
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.attention_block(p["attn"], cfg, h, positions)
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    f = layers.swiglu(h, **p["ffn"])
    return x + f, torch.zeros((), dtype=torch.float32, device=x.device)


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
    only one layer's tree is ever held beside them."""
    first = fn()
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
    check_family(cfg)
    dtype = dtype_of(cfg.param_dtype)
    V, d = cfg.padded_vocab, cfg.d_model
    p: Params = {
        "embed": layers.embed_init(generator, V, d, dtype),
        "final_norm": layers.init_rmsnorm(d, dtype, generator.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(generator, d, V, dtype)
    if cfg.family == "dense":
        p["blocks"] = _stack_init(
            lambda: init_decoder_block(generator, cfg, dtype, use_moe=False),
            cfg.n_layers)
    else:
        p["blocks"] = _stack_init(
            lambda: init_mamba_layer(generator, cfg, dtype), cfg.n_layers)
        if cfg.family == "hybrid":
            p["shared_block"] = init_decoder_block(generator, cfg, dtype,
                                                   use_moe=False)
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
    ``memory`` and ``remat`` are the JAX signature's (the vlm/encdec
    memory and rematerialization); neither has a use in this slice."""
    check_family(cfg)
    with full_fp32_matmul():
        params = cast_compute(params, cfg)
        B, S = tokens.shape
        x = _compute(params["embed"][tokens], cfg)
        positions = _positions(B, S, x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        blocks = params["blocks"]
        if cfg.family == "dense":
            for i in range(cfg.n_layers):
                x, _ = decoder_block(layer(blocks, i), cfg, x, positions,
                                     False)
        else:
            shared = params.get("shared_block")
            conv_w = blocks["mixer"]["conv_w"]
            for i in range(cfg.n_layers):
                if shared is not None and i % cfg.shared_attn_every == 0:
                    x, _ = decoder_block(shared, cfg, x, positions, False)
                key = ssm.conv_cache_key(("blocks", "mixer", "conv_w"), i,
                                         conv_w)
                x = mamba_layer(layer(blocks, i), cfg, x, key)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    with full_fp32_matmul():
        return (hidden @ head.to(hidden.dtype)).float()


def lm_loss(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss's forward: cross entropy over ``batch["labels"]``
    plus the router's auxiliary loss (zero in these families)."""
    params = cast_compute(params, cfg)
    hidden, aux = lm_hidden(params, cfg, batch["tokens"])
    logits = lm_logits(params, cfg, hidden)
    loss = layers.cross_entropy_loss(logits, batch["labels"])
    metrics = {"ce": loss, "aux": aux}
    loss = loss + cfg.router_aux_coef * aux
    metrics["loss"] = loss
    return loss, metrics
