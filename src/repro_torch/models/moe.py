"""Mixture-of-Experts FFN with sort-based grouped dispatch.

The counterpart of the JAX package's ``repro.models.moe``; autograd
gives its gradients (held to ``jax.grad``'s in the tests).
Tokens are routed top-k, sorted by expert, packed into a capacity-bounded
grouped tensor (E, C, d) and processed with grouped products; tokens past
an expert's capacity are dropped (GShard semantics).

The dispatch is data-shard-local, as in the JAX package: the T tokens are
cut into ``act_sharding.data_shards()`` chunks (1 where that does not
divide T), and each chunk is routed, grouped with its own capacity
``C = max(int(T_local * k / E * cf), 1)`` and combined alone; the aux
loss is over all T tokens.  The sharded train step runs each data shard's
tokens as one chunk (``act_sharding.local(1)``), so a shard's dispatch is
the single-device dispatch of its chunk, bit for bit.  With
``router_stats`` the block returns the aux loss's factors, the top-1
density and the mean router probability (2, E), instead of the loss:
the sharded step combines them over its shards before their product.

What the JAX package gets from its primitives, the port asks for:

  * ``jax.lax.top_k`` gives the lower expert first among equal
    probabilities (bf16 router logits tie often among 256 experts):
    ``_top_k`` is a stable descending sort;
  * ``jnp.argsort`` is stable, and the order decides which tokens go over
    capacity: ``torch.argsort(stable=True)``;
  * the combine adds a token's k contributions in a fixed order (the JAX
    scatter-add's: ascending expert), one elementwise add each, never by
    atomics, so a step replays bit for bit on the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import Params


def _experts(generator, shape, std: float, dtype) -> torch.Tensor:
    """(E, *shape) normal draws times ``std``, one expert at a time: each
    is drawn in f32 and cast (JAX's draw of the whole leaf in f32 is 15 GB
    at deepseek-v3's widths)."""
    E = shape[0]
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if out.is_meta:
        return out
    for e in range(E):
        out[e] = layers.normal(generator, shape[1:], std, dtype)
    return out


def init_moe(generator, cfg, dtype) -> Params:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = 1.0 / np.sqrt(d)
    p = {
        "router": layers.dense_init(generator, d, E, dtype, scale=0.1),
        "w_gate": _experts(generator, (E, d, f), std, dtype),
        "w_up": _experts(generator, (E, d, f), std, dtype),
        "w_down": _experts(generator, (E, f, d), 1.0 / np.sqrt(f), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_swiglu(generator, d,
                                         f * cfg.n_shared_experts, dtype)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_local(xt, expert_ids, gate_vals, E: int, k: int, C: int):
    """xt (T, d) -> grouped (E, C, d) + the indices of the combine."""
    idx = dispatch(expert_ids, gate_vals, E, k, C)
    se, st, _, keep, _, _ = idx
    # the dropped rows land in a spare slot C, cut off after: the kept
    # (expert, slot) pairs are distinct, so no row is written twice
    grouped = torch.zeros((E, C + 1, xt.shape[1]), dtype=xt.dtype,
                          device=xt.device)
    grouped[se, torch.where(keep, idx[4], C)] = xt[st]
    return grouped[:, :C], idx


def dispatch(expert_ids, gate_vals, E: int, k: int, C: int):
    """The sorted dispatch of T tokens' top-k experts (T, k): (expert,
    token, gate, kept, slot) of each of the T * k rows in expert order
    (a dropped row's slot is C - 1), and the sort's order."""
    T = expert_ids.shape[0]
    device = expert_ids.device
    flat_expert = expert_ids.reshape(T * k)
    flat_token = torch.arange(T, device=device).repeat_interleave(k)
    flat_gate = gate_vals.reshape(T * k)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    group_start = torch.searchsorted(se, torch.arange(E, device=device))
    slot = torch.arange(T * k, device=device) - group_start[se]
    keep = slot < C
    safe_slot = torch.where(keep, slot, C - 1)
    return se, st, sg, keep, safe_slot, order


def _combine_local(y_grouped, idx, T: int, k: int, d: int, dtype):
    se, _, _, _, safe_slot, _ = idx
    return combine_rows(y_grouped[se, safe_slot], idx, T, k, d, dtype)


def combine_rows(rows, idx, T: int, k: int, d: int, dtype):
    """The experts' outputs at the dispatch's rows (T * k, d), gated, and
    each token's k contributions summed in ascending expert order (the
    order of its rows in the sorted dispatch), one add at a time."""
    sg, keep, order = idx[2], idx[3], idx[5]
    contrib = (rows * sg[:, None].to(dtype) * keep[:, None].to(dtype))
    # sorted position of each (token, j), then each token's in rank order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    by_rank = torch.sort(rank.reshape(T, k), dim=1).values
    parts = contrib[by_rank]                         # (T, k, d)
    out = torch.zeros((T, d), dtype=dtype, device=contrib.device)
    for j in range(k):
        out = out + parts[:, j]
    return out


def moe_block(p: Params, cfg, x: torch.Tensor,
              capacity_factor: float = 1.25, router_stats: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux_loss scalar f32; with
    ``router_stats`` the (2, E) density and mean probability instead)."""
    from repro_torch.distributed import act_sharding as acts

    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    T = B * S
    xt = x.reshape(T, d)

    ds = acts.data_shards()
    ds = ds if T % ds == 0 else 1
    Tl = T // ds
    C = max(int(Tl * k / E * capacity_factor), 1)

    outs, all_probs, top1 = [], [], []
    for s in range(ds):
        xs = xt[s * Tl:(s + 1) * Tl]
        logits = (xs @ p["router"]).float()
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_ids = _top_k(probs, k)             # (Tl, k)
        gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
        grouped, idx = _group_local(xs, expert_ids, gate_vals, E, k, C)
        h_gate = torch.bmm(grouped, p["w_gate"])
        h_up = torch.bmm(grouped, p["w_up"])
        h = F.silu(h_gate) * h_up
        y_grouped = torch.bmm(h, p["w_down"])
        outs.append(_combine_local(y_grouped, idx, Tl, k, d, xt.dtype))
        all_probs.append(probs)
        top1.append(expert_ids[:, 0])
    out = outs[0] if ds == 1 else torch.cat(outs)
    probs = all_probs[0] if ds == 1 else torch.cat(all_probs)
    first = top1[0] if ds == 1 else torch.cat(top1)

    # load-balancing aux loss (Switch/GShard form), over all T tokens
    density = torch.mean(F.one_hot(first, E).float(), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = torch.stack([density, mean_prob]) if router_stats \
        else E * torch.sum(density * mean_prob)

    if cfg.n_shared_experts:
        out = out + layers.swiglu(xt, **p["shared"])
    return out.reshape(B, S, d), aux
