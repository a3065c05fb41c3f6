"""Model registry: config -> (init, loss, forward, cache, decode) bundle.

The counterpart of the JAX package's ``repro.models.registry`` for the
serving and training paths.  :class:`Model` is functional over a parameter tree in the
JAX package's layout, so ``repro_torch.interop.params_from_numpy``
carries a JAX ``init_lm`` tree across unchanged; :class:`LM` holds the
same tree as an ``nn.Module``.  The abstract shapes
(``init_abstract``, ``batch_specs``, ``decode_specs``,
``cache_abstract``) are tensors on the meta device: shapes and dtypes,
no allocation, as ``jax.eval_shape`` gives the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import decode as decode_mod
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.cnn import TreeModule
from repro_torch.models.layers import Params, dtype_of


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> Params:
        """Parameters drawn from ``generator`` (a fresh one seeded 0 on
        ``device`` when None) on its device, then placed on ``device``
        (the generator's device when None, the card when both are)."""
        if generator is None:
            generator = torch.Generator(
                device=device or "cuda").manual_seed(0)
        params = tfm.init_lm(generator, self.cfg)
        device = torch.device(device or generator.device)
        if params["embed"].device != device:
            params = tree_util.tree_map(lambda a: a.to(device), params)
        return params

    def init_abstract(self) -> Params:
        """The parameter tree's shapes and dtypes: empty meta tensors, no
        allocation (``layers.ABSTRACT``)."""
        return tfm.init_lm(layers.ABSTRACT, self.cfg)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        return tfm.lm_loss(params, self.cfg, batch)

    def forward(self, params: Params, tokens: torch.Tensor,
                memory: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits (B, S, V) f32; ``memory`` is the vlm's vision embeddings
        or the encdec's encoder frames (run through the encoder here)."""
        return tfm.forward(params, self.cfg, tokens, memory)

    def init_cache(self, params: Params, batch: int, max_len: int,
                   memory: Optional[torch.Tensor] = None,
                   shardings=None) -> Params:
        """The decode cache; placed by ``shardings``
        (``sharding.cache_shardings``), or by ``cache_pspecs`` on the
        parameters' mesh where they are placed."""
        return decode_mod.init_cache(params, self.cfg, batch, max_len,
                                     memory, shardings)

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor, pos: torch.Tensor):
        """A placed tree and cache step through ``serve_spmd``."""
        return decode_mod.decode_step(params, self.cfg, cache, tokens, pos)

    # ------------------------------------------------------------------
    def batch_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Meta stand-ins for one input-shape cell (training / prefill
        inputs; decode uses ``decode_specs``)."""
        B, S = shape.global_batch, shape.seq_len
        specs = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        d = dtype_of(self.cfg.compute_dtype)
        if self.cfg.family == "vlm":
            specs["vision"] = _meta(
                (B, self.cfg.n_vision_tokens, self.cfg.d_model), d)
        if self.cfg.family == "encdec":
            specs["frames"] = _meta(
                (B, S * self.cfg.encoder_seq_ratio, self.cfg.d_model), d)
        return specs

    def decode_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        B = shape.global_batch
        return {"tokens": _meta((B, 1), torch.int32),
                "pos": _meta((B,), torch.int32)}

    def cache_abstract(self, shape: ShapeConfig) -> Params:
        """The decode cache's shapes and dtypes at a context length:
        ``init_cache`` over the abstract parameters, on the meta device."""
        B, S = shape.global_batch, shape.seq_len
        cfg = self.cfg
        d = dtype_of(cfg.compute_dtype)
        memory = None
        if cfg.family == "vlm":
            memory = _meta((B, cfg.n_vision_tokens, cfg.d_model), d)
        elif cfg.family == "encdec":
            memory = _meta((B, S * cfg.encoder_seq_ratio, cfg.d_model), d)
        return decode_mod.init_cache(self.init_abstract(), cfg, B, S,
                                     memory)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


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
