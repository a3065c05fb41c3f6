"""Carry weights and prepared weights across from the JAX package.

The port never imports jax: callers hand over numpy arrays, or objects
whose fields ``np.asarray`` can read (a JAX array converts itself).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.api.plan import PreparedWeights

PREPARED_FIELDS = ("w", "tw", "wq", "w_scale", "act_scale")


def _tensor(value, device) -> torch.Tensor:
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def params_from_numpy(tree: Mapping[str, Any], device="cuda") -> dict:
    """Nested dict of arrays (the ``init_vgg`` layout ``{"s0c0": {"w", "b"},
    ...}``) -> the same nesting of tensors on ``device``."""
    return {k: params_from_numpy(v, device) if isinstance(v, Mapping)
            else _tensor(v, device) for k, v in tree.items()}


def prepared_from_jax(prep, device="cuda") -> PreparedWeights:
    """A JAX ``PreparedWeights`` (or any object or mapping with the fields
    ``w``, ``tw``, ``wq``, ``w_scale``, ``act_scale``) -> the port's
    ``PreparedWeights`` on ``device``.  Missing or None fields stay None."""
    def field(name):
        value = prep.get(name) if isinstance(prep, Mapping) \
            else getattr(prep, name, None)
        return None if value is None else _tensor(value, device)
    return PreparedWeights(**{name: field(name) for name in PREPARED_FIELDS})
