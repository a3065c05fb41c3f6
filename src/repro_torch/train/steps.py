"""Train, prefill and decode steps: gradients by autograd, optional int8
gradient compression, then the optimizer.

``make_train_step`` builds the JAX package's canonical step:
  value and gradient of the model loss (``torch.autograd.grad`` over the
  parameter leaves, the backward in IEEE float32 on cuBLAS,
  ``precision.full_fp32_backward``; an LM rematerialises its layers
  inside it)
  -> optional int8 gradient round trip
  -> the optimizer's update (float32 moments)
  -> a new ``TrainState``.

``make_serve_step`` builds the one-token greedy decode step,
``make_prefill_step`` the forward over a prompt; both record no graph.
Parameters and a cache placed on a mesh serve through
``distributed/serve_spmd.py``: ``Model.decode_step`` routes them, and
the prefill step does.

The model is duck-typed as in the JAX package: ``model.init(generator)``
returns a parameter tree (on the generator's device) and
``model.loss(params, batch)`` returns ``(loss, metrics)``: a CNN adapter,
or an LM ``repro_torch.models.Model`` with batches of ``tokens`` and
``labels`` (and ``vision`` for a vlm, ``frames`` for an encdec).
Training runs where its tensors are: the caller's batches and the
generator's device decide, and nothing moves to the CPU.  A state placed
on a mesh (``init_train_state(..., shardings=...)``, or
``distributed.sharding.place``) steps through the sharded step of
``distributed/lm_spmd.py``, each weight block computed on its own mesh
coordinate, with the same microbatches and int8 gradient compression.
The compression's rounding noise is keyed by each element's flat index
in its leaf (``grad_compression.int8_roundtrip``), so the sharded step's
compressed gradients are this step's.  ``abstract_train_state`` gives
the state's shapes and dtypes on the meta device, without allocating
it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.precision import full_fp32_backward
from repro_torch.optim import grad_compression as gc
from repro_torch.optim.optimizers import AdamW, AdamWState
from repro_torch.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    rng: torch.Tensor           # int64: the seed the run started from


def abstract_train_state(model, optimizer: AdamW) -> TrainState:
    """The LM train state's shapes and dtypes: meta tensors, no
    allocation (``Model.init_abstract``)."""
    params = model.init_abstract()
    return TrainState(params=params, opt=optimizer.init(params),
                      rng=torch.empty((), dtype=torch.int64, device="meta"))


def init_train_state(model, optimizer: AdamW, seed: int,
                     device="cuda", shardings=None) -> TrainState:
    """Parameters drawn by ``model.init`` from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (the JAX package's key), and the
    optimizer's state for them.  With ``shardings`` (a ``TrainState`` of
    ``NamedSharding``, ``lm_spmd.state_shardings``) the same draws, each
    placed on the mesh as it is made."""
    if shardings is not None:
        from repro_torch.distributed import lm_spmd
        return lm_spmd.init_train_state(model, optimizer, seed, shardings,
                                        device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen)
    return TrainState(params=params, opt=optimizer.init(params),
                      rng=torch.tensor(seed, dtype=torch.int64))


def _value_and_grad(model, params, batch):
    """(loss, metrics, gradient tree) of ``model.loss`` at ``params``; a
    parameter the loss does not reach gets a zero gradient, as in JAX."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(live, batch)
    flat = leaves(live)
    with full_fp32_backward():
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, grads)


def make_train_step(model, optimizer: AdamW, grad_compression: bool = False,
                    microbatches: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        from repro_torch.distributed import lm_spmd
        if lm_spmd.is_sharded(state):
            return lm_spmd.train_step(model, optimizer, state, batch,
                                      microbatches, grad_compression)
        if microbatches > 1:
            # gradient accumulation: the batch is split along dim 0 into
            # equal chunks, gradients summed in float32 and averaged
            def chunk(i):
                return tree_map(lambda a: a.reshape(
                    (microbatches, a.shape[0] // microbatches)
                    + tuple(a.shape[1:]))[i], batch)

            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss_sum = None
            for i in range(microbatches):
                loss, _, g = _value_and_grad(model, state.params, chunk(i))
                grads = tree_map(torch.add, grads, g)
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {"loss": loss_sum / microbatches}
        else:
            _, metrics, grads = _value_and_grad(model, state.params, batch)

        if grad_compression:
            # the int8 bottleneck before the gradient reduction, with a
            # fixed seed per leaf as the JAX step's fixed key
            with torch.no_grad():
                grads = tree_map(gc.roundtrip_leaf, grads)

        new_params, new_opt, opt_metrics = optimizer.apply(
            state.params, grads, state.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return TrainState(new_params, new_opt, state.rng), metrics

    return train_step


def make_serve_step(model) -> Callable:
    """Returns serve_step(params, cache, tokens, pos) -> (next tokens
    (B, 1) int32, the argmax of the last position's logits; the logits;
    the new cache)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = model.decode_step(params, cache, tokens, pos)
        next_tokens = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_tokens.to(torch.int32), logits, new_cache
    return serve_step


def make_prefill_step(model) -> Callable:
    """Returns prefill_step(params, tokens, memory=None) -> logits
    (``model.forward``)."""

    @torch.no_grad()
    def prefill_step(params, tokens, memory=None):
        from repro_torch.distributed import serve_spmd
        if serve_spmd.is_placed(params):
            return serve_spmd.prefill_step(model, params, tokens, memory)
        return model.forward(params, tokens, memory)
    return prefill_step
