"""Decoder-LM assembly for every architecture family of the zoo.

The counterpart of the JAX package's ``repro.models.transformer``.
Families map to block stacks over stacked layer parameters (a leading
``n_layers`` axis, the JAX package's layout); the JAX package scans them,
the port loops over the layer index:

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
package's batch-sharding constraints have nothing to do.  Its ``remat``
does: where autograd records through the parameters, each layer runs under
``torch.utils.checkpoint`` exactly where the JAX package has
``jax.checkpoint`` (each dense or moe block, each mamba layer with the
hybrid's shared block, each vlm group, each encdec decoder layer; not the
encoder), so a layer's activations are recomputed in the backward instead
of saved.  ``REPRO_TORCH_REMAT_POLICY`` (``full``, the default, or
``dots``: save the products' outputs) mirrors the JAX package's
``REPRO_REMAT_POLICY``.  A layer placed on a mesh, whose blocks run on
several devices, is rematerialised by :func:`checkpoint_threadsafe`
instead (``ForwardOps.checkpoint``).  A forward that records nothing
(serving) is not wrapped.

The forward reaches its attention, MLA, FFN, MoE, SSM, embedding and
head functions through an operations object (:class:`ForwardOps`, the
plain functions over tensors by default); ``distributed/model_split.py``
gives the same operations over weights placed on a mesh, each weight
block computed where it lies, for the sharded train step and prefill.

Float32 products run in IEEE float32 on the card whatever TF32 the caller
allowed cuBLAS (``repro_torch.core.precision``): ``lm_hidden`` and
``lm_logits`` hold the guard, a checkpointed layer enters it again inside
(its recomputation runs in the backward, outside the forward's block),
and the train step runs its backward under ``full_fp32_backward``.
"""
from __future__ import annotations

import functools
import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

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


def decoder_block(p: Params, cfg: ModelConfig, x, positions, use_moe: bool,
                  router_stats: bool = False, ops: "ForwardOps" = None):
    ops = LOCAL if ops is None else ops
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a = ops.mla(p["attn"], cfg, h, positions)
    else:
        a = ops.attention(p["attn"], cfg, h, positions)
    x = x + a
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if use_moe:
        f, aux = ops.moe(p["ffn"], cfg, h, router_stats)
    else:
        f = ops.ffn(p["ffn"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def init_mamba_layer(generator, cfg, dtype) -> Params:
    return {
        "ln": layers.init_rmsnorm(cfg.d_model, dtype, generator.device),
        "mixer": ssm.init_mamba2(generator, cfg, dtype),
    }


def mamba_layer(p: Params, cfg, x, conv_key: Optional[tuple] = None,
                ops: "ForwardOps" = None):
    ops = LOCAL if ops is None else ops
    h = layers.rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + ops.mamba(p["mixer"], cfg, h, conv_key)


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------
def _stack_init(fn, n: int, sink=None):
    """Initialize n layers and stack their leaves along a leading axis.
    Each layer is drawn and copied into the stacked tensors in turn, so
    only one layer's tree is ever held beside them; one layer is its own
    tree with a leading axis of 1, copied nowhere (deepseek-v3's one MoE
    layer holds 45 GB in fp32).  With a ``sink`` (``init_lm``'s placer)
    each layer goes to ``sink.add(i, layer)`` as it is drawn, and the
    stack is ``sink.done()``."""
    if sink is not None:
        for i in range(n):
            sink.add(i, fn())
        return sink.done()
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
    """Layer ``i`` of a stacked tree (views of the stacked tensors; a
    sharded leaf of the sharded train step gathers the layer here)."""
    return tree_util.tree_map(lambda a: a[i], stacked)


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            placer=None) -> Params:
    """The JAX package's ``init_lm`` tree, drawn from ``generator`` on its
    device (``layers.ABSTRACT``: empty meta tensors).

    With a ``placer`` the draws go where it puts them as they are made, in
    the same order: a top-level entry that is not a stack through
    ``placer.put(key, tree)`` when it is drawn, a stack layer by layer
    through ``placer.stack(key, n)``'s ``add`` and ``done``
    (``distributed/lm_spmd.py`` places them on a mesh, so the peak is one
    layer or the largest such entry, not the model)."""
    dtype = dtype_of(cfg.param_dtype)
    V, d = cfg.padded_vocab, cfg.d_model
    device = generator.device

    def put(key, tree):
        return tree if placer is None else placer.put(key, tree)

    def stack(key, fn, n):
        return _stack_init(fn, n, None if placer is None
                           else placer.stack(key, n))

    p: Params = {
        "embed": put("embed", layers.embed_init(generator, V, d, dtype)),
        "final_norm": put("final_norm",
                          layers.init_rmsnorm(d, dtype, device)),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = put("lm_head",
                           layers.dense_init(generator, d, V, dtype))

    def block(use_moe):
        return lambda: init_decoder_block(generator, cfg, dtype, use_moe)

    fam = cfg.family
    if fam in ("dense", "moe"):
        if cfg.first_dense_layers:
            p["dense_blocks"] = stack("dense_blocks", block(False),
                                      cfg.first_dense_layers)
        p["blocks"] = stack("blocks", block(fam == "moe"),
                            cfg.n_layers - cfg.first_dense_layers)
        if cfg.mtp_depth:
            p["mtp"] = put("mtp", {
                "proj": layers.dense_init(generator, 2 * d, d, dtype),
                "block": block(fam == "moe")(),
                "norm": layers.init_rmsnorm(d, dtype, device),
            })
    elif fam in ("ssm", "hybrid"):
        p["blocks"] = stack(
            "blocks", lambda: init_mamba_layer(generator, cfg, dtype),
            cfg.n_layers)
        if fam == "hybrid":
            p["shared_block"] = put("shared_block", block(False)())
    elif fam == "vlm":
        p["blocks"] = stack("blocks", block(False), cfg.n_layers)
        p["cross_blocks"] = stack(
            "cross_blocks", lambda: {
                "ln": layers.init_rmsnorm(d, dtype, device),
                "xattn": attn.init_cross_attention(generator, cfg, dtype),
                "ln2": layers.init_rmsnorm(d, dtype, device),
                "ffn": layers.init_swiglu(generator, d, cfg.d_ff, dtype),
                "ffn_gate": torch.zeros((), dtype=dtype, device=device),
            }, cfg.n_layers // cfg.cross_attn_every)
    elif fam == "encdec":
        p["enc_blocks"] = stack("enc_blocks", block(False),
                                cfg.encoder_layers)
        p["enc_norm"] = put("enc_norm", layers.init_rmsnorm(d, dtype,
                                                            device))
        p["blocks"] = stack("blocks", block(False), cfg.n_layers)
        p["cross_blocks"] = stack(
            "cross_blocks", lambda: {
                "ln": layers.init_rmsnorm(d, dtype, device),
                "xattn": attn.init_attention(generator, cfg, dtype),
            }, cfg.n_layers)
    else:
        raise ValueError(fam)
    return p


# --------------------------------------------------------------------------
# the compute copy
# --------------------------------------------------------------------------
def _recording(params: Params) -> bool:
    """Autograd records through the tree: grad mode on and a leaf that
    requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad
        for a in tree_util.leaves(params))


class _CastCache:
    """The compute-dtype copy of a parameter tree, made once per tree
    version.  The JAX package casts the whole tree on every call and XLA
    fuses the cast away under jit; eagerly, a bf16 decode step of
    phi4-mini would read 15.5 GB and write 7.8 GB.  An entry is keyed on
    every leaf's identity and in-place version and pins the leaves, so the
    identities stay valid and an updated tree is cast anew; the copy has
    the same bits as a fresh cast.  Trees that autograd records through
    are cast on every call and never cached, and so are abstract (meta)
    trees."""

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
        if _recording(params) or floating[0].is_meta:
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
# rematerialization
# --------------------------------------------------------------------------
REMAT_POLICY_ENV = "REPRO_TORCH_REMAT_POLICY"
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def remat_policy() -> str:
    """``full`` recomputes a layer's whole forward in the backward (least
    memory); ``dots`` saves its products' outputs (``mm``, ``bmm``,
    ``addmm``) and recomputes the rest, as the JAX package's
    ``checkpoint_dots``.  Read from ``REPRO_TORCH_REMAT_POLICY`` on every
    call."""
    policy = os.environ.get(REMAT_POLICY_ENV, "full")
    if policy not in ("full", "dots"):
        raise ValueError(f"{REMAT_POLICY_ENV}={policy!r}: full or dots")
    return policy


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _layer_fn(fn, remat: bool, ops: "ForwardOps" = None):
    """``fn`` as one layer of a stack: as it is, or, with ``remat``,
    checkpointed (``ops.checkpoint``) with the float32 guard entered
    inside, where its recomputation in the backward runs too."""
    if not remat:
        return fn

    def guarded(*args):
        with full_fp32_matmul():
            return fn(*args)

    return (LOCAL if ops is None else ops).checkpoint(guarded)


class _Frame:
    """One checkpointed call's saved tensors: dropped in the forward, made
    again by one recomputation in the backward by whichever thread
    unpacks one first, the others waiting on the frame's lock."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args
        self.lock = threading.Lock()
        self.count = 0
        self.saved = None

    def pack(self, x):
        self.count += 1
        return self.count - 1

    def unpack(self, i: int):
        with self.lock:
            if self.saved is None:
                saved = []

                def keep(x):
                    # detached: a node that saves its own output would
                    # otherwise hold it with its graph, a cycle
                    x = x.detach() if x.requires_grad else x
                    saved.append(x)
                    return x
                with torch.autograd.graph.saved_tensors_hooks(
                        keep, lambda x: x), torch.enable_grad():
                    self.fn(*self.args)
                if len(saved) != self.count:
                    raise RuntimeError(
                        f"a checkpointed layer saved {self.count} tensors "
                        f"in its forward and {len(saved)} recomputing it")
                self.saved = saved
            x, self.saved[i] = self.saved[i], None
        return x


def checkpoint_threadsafe(fn, *args):
    """``fn(*args)`` rematerialised as ``torch.utils.checkpoint``'s
    non-reentrant checkpoint does it (nothing saved in the forward, one
    recomputation in the backward), for a layer that runs on several
    devices: autograd runs each device's backward on a thread of its own,
    and two threads that unpack the layer's tensors at once would both
    recompute it under ``torch.utils.checkpoint``, which keeps one counter
    a frame.  Here one thread recomputes and the others wait.  It saves
    no products' outputs under ``REPRO_TORCH_REMAT_POLICY=dots``: the
    recomputation's values are the same."""
    frame = _Frame(fn, args)
    with torch.autograd.graph.saved_tensors_hooks(frame.pack, frame.unpack):
        return fn(*args)


# --------------------------------------------------------------------------
# the forward's operations
# --------------------------------------------------------------------------
class ForwardOps:
    """The forward's operations on a layer's weights, here the plain
    functions over tensors; ``distributed/model_split.py`` gives the same
    operations over weights placed on a mesh (each weight block computed
    on its own coordinate), for the sharded train step and prefill."""

    @staticmethod
    def embed(w, tokens):
        return w[tokens]

    @staticmethod
    def attention(p, cfg, h, positions, causal: bool = True):
        return attn.attention_block(p, cfg, h, positions, causal)

    @staticmethod
    def mla(p, cfg, h, positions):
        return mla.mla_block(p, cfg, h, positions)

    @staticmethod
    def cross(p, cfg, h, memory, gated: bool = False):
        return attn.cross_attention_block(p, cfg, h, memory, gated)

    @staticmethod
    def ffn(p, h):
        return layers.swiglu(h, **p)

    @staticmethod
    def moe(p, cfg, h, router_stats: bool = False):
        if router_stats:
            return moe.moe_block(p, cfg, h, router_stats=True)
        return moe.moe_block(p, cfg, h)

    @staticmethod
    def mamba(p, cfg, h, conv_key=None):
        return ssm.mamba2_block(p, cfg, h, conv_key)

    @staticmethod
    def conv_key(path, i: int, stacked):
        """The serving-cache key of layer ``i``'s conv weights."""
        return ssm.conv_cache_key(path, i, stacked)

    @staticmethod
    def proj(w, x):
        return x @ w

    @staticmethod
    def logits(params, cfg, hidden):
        return lm_logits(params, cfg, hidden)

    @staticmethod
    def checkpoint(fn):
        """``fn`` checkpointed by ``torch.utils.checkpoint`` under the
        remat policy (``remat_policy``)."""
        kwargs = {}
        if remat_policy() == "dots":
            kwargs["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False,
                                             **kwargs)

    @staticmethod
    def share(t, n: int):
        """``t`` for ``n`` uses (the encdec's encoder output, one a decoder
        layer): here the tensor itself each time."""
        return [t] * n


LOCAL = ForwardOps()


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------
def _compute(x, cfg):
    return x.to(dtype_of(cfg.compute_dtype))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def lm_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
              memory: Optional[torch.Tensor] = None,
              remat: bool = True, router_stats: bool = False,
              ops: ForwardOps = LOCAL
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids -> final hidden states. Returns (hidden, aux_loss).
    ``memory`` is the vlm's vision embeddings or the encdec's encoder
    output; with ``remat`` each layer is checkpointed where autograd
    records through ``params`` (the module's docstring).  A layer's
    parameters are taken (``layer``) inside its checkpointed function, so
    a sharded leaf fetches them there and again in the recomputation,
    and the forward keeps no fetched copy.  With ``router_stats`` a moe
    model returns its MoE layers' (2, E) router statistics stacked (L, 2,
    E) in place of the aux loss (``moe.moe_block``).  ``ops`` runs the
    layers' operations (:class:`ForwardOps`)."""
    fam = cfg.family
    if fam in ("vlm", "encdec") and memory is None:
        raise ValueError(f"the {fam} family needs its memory (the vision "
                         f"embeddings or the encoder output)")
    remat = remat and _recording(params)
    with full_fp32_matmul():
        params = cast_compute(params, cfg)
        B, S = tokens.shape
        x = _compute(ops.embed(params["embed"], tokens), cfg)
        positions = _positions(B, S, x.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        blocks = params["blocks"]
        if fam in ("dense", "moe"):
            def block(x, stack, i, use_moe):
                return decoder_block(layer(stack, i), cfg, x, positions,
                                     use_moe, router_stats, ops)

            block = _layer_fn(block, remat, ops)
            if cfg.first_dense_layers:
                for i in range(cfg.first_dense_layers):
                    x, _ = block(x, params["dense_blocks"], i, False)
            auxes = []
            for i in range(cfg.n_layers - cfg.first_dense_layers):
                x, aux = block(x, blocks, i, fam == "moe")
                auxes.append(aux)
            if router_stats and fam == "moe":
                aux_total = torch.stack(auxes)
            elif auxes:
                aux_total = aux_total + torch.sum(torch.stack(auxes))
        elif fam in ("ssm", "hybrid"):
            shared = params.get("shared_block")
            conv_w = blocks["mixer"]["conv_w"]

            def mamba(x, i, key, with_shared):
                # the hybrid's shared block runs inside the layer's
                # checkpoint, as in the JAX package's _scan_mamba
                if with_shared:
                    x, _ = decoder_block(shared, cfg, x, positions, False,
                                         ops=ops)
                return mamba_layer(layer(blocks, i), cfg, x, key, ops)

            mamba = _layer_fn(mamba, remat, ops)
            for i in range(cfg.n_layers):
                key = ops.conv_key(("blocks", "mixer", "conv_w"), i, conv_w)
                x = mamba(x, i, key, shared is not None
                          and i % cfg.shared_attn_every == 0)
        elif fam == "vlm":
            mem = _compute(memory, cfg)
            k = cfg.cross_attn_every
            mems = ops.share(mem, cfg.n_layers // k)

            def group(x, g):
                cross = layer(params["cross_blocks"], g)
                h = layers.rmsnorm(x, cross["ln"], cfg.norm_eps)
                x = x + ops.cross(cross["xattn"], cfg, h, mems[g],
                                  gated=True)
                h = layers.rmsnorm(x, cross["ln2"], cfg.norm_eps)
                x = x + torch.tanh(cross["ffn_gate"]) * ops.ffn(
                    cross["ffn"], h)
                for i in range(g * k, (g + 1) * k):
                    x, _ = decoder_block(layer(blocks, i), cfg, x,
                                         positions, False, ops=ops)
                return x

            group = _layer_fn(group, remat, ops)
            for g in range(cfg.n_layers // k):
                x = group(x, g)
        elif fam == "encdec":
            mems = ops.share(memory, cfg.n_layers)

            def dec(x, i):
                xp = layer(params["cross_blocks"], i)
                h = layers.rmsnorm(x, xp["ln"], cfg.norm_eps)
                x = x + ops.cross(xp["xattn"], cfg, h, mems[i])
                x, _ = decoder_block(layer(blocks, i), cfg, x, positions,
                                     False, ops=ops)
                return x

            dec = _layer_fn(dec, remat, ops)
            for i in range(cfg.n_layers):
                x = dec(x, i)
        else:
            raise ValueError(fam)
        x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def encoder_forward(params: Params, cfg: ModelConfig,
                    frames: torch.Tensor, ops: ForwardOps = LOCAL
                    ) -> torch.Tensor:
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
            x = x + ops.attention(bp["attn"], cfg, h, positions,
                                  causal=False)
            h = layers.rmsnorm(x, bp["ln2"], cfg.norm_eps)
            x = x + ops.ffn(bp["ffn"], h)
        return layers.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def lm_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    with full_fp32_matmul():
        return (hidden @ head.to(hidden.dtype)).float()


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None,
            ops: ForwardOps = LOCAL) -> torch.Tensor:
    """Logits (B, S, V) f32; an encdec's ``memory`` (its frames) runs
    through the encoder here."""
    if cfg.family == "encdec":
        memory = encoder_forward(params, cfg, memory, ops)
    hidden, _ = lm_hidden(params, cfg, tokens, memory, ops=ops)
    return ops.logits(params, cfg, hidden)


def loss_terms(params: Params, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], router_stats: bool = False,
               ops: ForwardOps = LOCAL
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]:
    """``lm_loss``'s terms: (the per-token loss, the aux loss, metrics).
    The per-token loss is the cross entropy plus 0.3 times the MTP term
    (deepseek-v3: token t + 2 from the hidden state at t and the embedding
    of t + 1); with ``router_stats`` the aux loss is a moe model's (L, 2,
    E) router statistics (``lm_hidden``)."""
    params = cast_compute(params, cfg)
    memory = batch.get("vision", batch.get("frames"))
    if cfg.family == "encdec":
        memory = encoder_forward(params, cfg, batch["frames"], ops)
    hidden, aux = lm_hidden(params, cfg, batch["tokens"], memory,
                            router_stats=router_stats, ops=ops)
    logits = ops.logits(params, cfg, hidden)
    loss = layers.cross_entropy_loss(logits, batch["labels"])
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth:
        with full_fp32_matmul():
            emb_next = _compute(ops.embed(params["embed"], batch["tokens"]),
                                cfg)
            h_in = torch.cat([hidden[:, :-1, :], emb_next[:, 1:, :]],
                             dim=-1)
            h_mtp = ops.proj(params["mtp"]["proj"], h_in)
            B, S1, _ = h_mtp.shape
            h_mtp, _ = decoder_block(params["mtp"]["block"], cfg, h_mtp,
                                     _positions(B, S1, h_mtp.device),
                                     cfg.family == "moe", router_stats, ops)
            h_mtp = layers.rmsnorm(h_mtp, params["mtp"]["norm"],
                                   cfg.norm_eps)
        mtp_logits = ops.logits(params, cfg, h_mtp)
        mtp_loss = layers.cross_entropy_loss(mtp_logits[:, :-1],
                                             batch["labels"][:, 2:])
        metrics["mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    return loss, aux, metrics


def lm_loss(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss's forward: cross entropy over ``batch["labels"]``,
    the MTP term (weighted 0.3) and the router's auxiliary loss
    (``loss_terms``).  ``batch`` carries ``vision`` (vlm) or ``frames``
    (encdec) beside the tokens."""
    loss, aux, metrics = loss_terms(params, cfg, batch)
    loss = loss + cfg.router_aux_coef * aux
    metrics["loss"] = loss
    return loss, metrics
