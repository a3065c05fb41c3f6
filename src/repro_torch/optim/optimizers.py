"""Native optimizers: AdamW and SGD, cosine schedule, global-norm clipping.

The JAX package's optimizers over nested dicts of tensors, functional as
they are there: ``apply`` returns new parameters and a new state, runs
under ``torch.no_grad()`` and writes to nothing it was given.  Moments are
kept in float32 whatever the parameter dtype (bf16-parameter training);
the update math runs in float32 and casts back to the parameter dtype.
``torch.optim.AdamW`` is not used: its decay and epsilon come in another
order, and this state checkpoints in the JAX package's layout
(``repro_torch.checkpoint``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, on the parameters' device
    mu: Any
    nu: Any


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step_counter(params) -> torch.Tensor:
    first = leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=first[0].device if first else "cpu")


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(step=_step_counter(params),
                          mu=tree_map(_zeros_f32, params),
                          nu=tree_map(_zeros_f32, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def apply(self, params, grads, state: AdamWState
              ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1c = 1 - self.b1 ** step.to(torch.float32)
        b2c = 1 - self.b2 ** step.to(torch.float32)
        lr = self._lr(step)

        def upd(p, g, m, v):
            # a leaf on another device than the step (a sharded state's
            # block) takes the step's scalars there
            on = g.device
            g = g * scale.to(on)
            m_new = self.b1 * m + (1 - self.b1) * g
            v_new = self.b2 * v + (1 - self.b2) * g * g
            mhat = m_new / b1c.to(on)
            vhat = v_new / b2c.to(on)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if p.is_floating_point():
                delta = delta + self.weight_decay * p.to(torch.float32)
            rate = lr.to(on) if isinstance(lr, torch.Tensor) else lr
            return (p.to(torch.float32) - rate * delta).to(p.dtype), \
                m_new, v_new

        out = [upd(*t) for t in zip(leaves(params), leaves(grads),
                                    leaves(state.mu), leaves(state.nu))]
        new_params, new_mu, new_nu = (
            unflatten(params, [t[i] for t in out]) for i in range(3))
        return new_params, AdamWState(step, new_mu, new_nu), \
            {"grad_norm": gnorm,
             "lr": torch.as_tensor(lr, dtype=torch.float32,
                                   device=step.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed in
    leaf order on the first leaf's device."""
    total = torch.zeros((), dtype=torch.float32)
    for i, leaf in enumerate(leaves(tree)):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if i == 0 else total + sq.to(total.device)
    return torch.sqrt(total)


def cosine_schedule(peak_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; a function of the step tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * peak_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 0.1
    momentum: float = 0.9

    def init(self, params) -> AdamWState:
        return AdamWState(step=_step_counter(params),
                          mu=tree_map(_zeros_f32, params), nu=())

    @torch.no_grad()
    def apply(self, params, grads, state: AdamWState):
        def upd(p, g, m):
            m_new = self.momentum * m + g.to(torch.float32)
            return (p.to(torch.float32) - self.lr * m_new).to(p.dtype), \
                m_new
        out = [upd(*t) for t in zip(leaves(params), leaves(grads),
                                    leaves(state.mu))]
        new_params, new_mu = (unflatten(params, [t[i] for t in out])
                              for i in range(2))
        return new_params, AdamWState(state.step + 1, new_mu, ()), {}
