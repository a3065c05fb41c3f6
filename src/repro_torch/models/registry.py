"""Model registry: config -> (init, loss, forward, cache, decode) bundle.

The counterpart of the JAX package's ``repro.models.registry`` for the
serving path.  :class:`Model` is functional over a parameter tree in the
JAX package's layout, so ``repro_torch.interop.params_from_numpy``
carries a JAX ``init_lm`` tree across unchanged; :class:`LM` holds the
same tree as an ``nn.Module``.  The dry-run's abstract shapes
(``init_abstract``, ``batch_specs``, ``decode_specs``,
``cache_abstract``) come with the dry-run's slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.cnn import TreeModule
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Params:
        """Parameters drawn from ``generator`` (a fresh one seeded 0 on
        ``device`` when None) on its device, then placed on ``device``."""
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        params = tfm.init_lm(generator, self.cfg)
        device = torch.device(device)
        if params["embed"].device != device:
            params = tree_util.tree_map(lambda a: a.to(device), params)
        return params

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        return tfm.lm_loss(params, self.cfg, batch)

    def forward(self, params: Params, tokens: torch.Tensor,
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, S, V) f32; ``memory`` is the vlm's vision embeddings
        or the encdec's encoder frames (run through the encoder here)."""
        if self.cfg.family == "encdec":
            memory = tfm.encoder_forward(params, self.cfg, memory)
        hidden, _ = tfm.lm_hidden(params, self.cfg, tokens, memory)
        return tfm.lm_logits(params, self.cfg, hidden)

    def init_cache(self, params: Params, batch: int, max_len: int,
                   memory: Optional[torch.Tensor] = None) -> Params:
        return decode_mod.init_cache(params, self.cfg, batch, max_len,
                                     memory)

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor, pos: torch.Tensor):
        return decode_mod.decode_step(params, self.cfg, cache, tokens, pos)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)


class LM(TreeModule):
    """A language model over a parameter tree (``Model.init``'s, or the
    JAX package's through ``params_from_numpy``), its parameters
    frozen (the serving path): ``forward(tokens)`` gives the logits,
    ``init_cache`` and ``decode_step`` serve, over this module's
    parameters."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__(params, requires_grad=False)
        self.cfg = cfg
        self.model = build(cfg)

    def forward(self, tokens, memory=None):
        return self.model.forward(self.tree(), tokens, memory)

    def init_cache(self, batch: int, max_len: int, memory=None) -> Params:
        return self.model.init_cache(self.tree(), batch, max_len, memory)

    def decode_step(self, cache: Params, tokens, pos):
        return self.model.decode_step(self.tree(), cache, tokens, pos)
