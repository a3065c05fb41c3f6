"""Carry weights, prepared weights and optimizer state across from the JAX
package.

The port never imports jax: callers hand over numpy arrays, or objects
whose fields ``np.asarray`` can read (a JAX array converts itself).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.api.plan import PreparedWeights
from repro_torch.optim.optimizers import AdamWState

PREPARED_FIELDS = ("w", "tw", "wq", "w_scale", "act_scale")


def _tensor(value, device) -> torch.Tensor:
    a = np.array(value, copy=True)
    if a.dtype.name == "bfloat16":
        # numpy holds bf16 as a dtype torch cannot wrap: cross as f32,
        # which holds every bf16 value, and cast back
        return torch.from_numpy(a.astype(np.float32)).to(device).to(
            torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Mapping[str, Any], device="cuda") -> dict:
    """Nested dict of arrays -> the same nesting of tensors on ``device``,
    each leaf's shape and dtype kept: the CNNs' layout (``init_vgg``'s
    ``{"s0c0": {"w", "b"}, ...}``) and the LMs' (``init_lm``'s stacked
    blocks, padded heads and padded vocab), which the port's models read
    as they are."""
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


def adamw_state_from_numpy(state, device="cuda") -> AdamWState:
    """A JAX ``AdamWState`` (or any object with the fields ``step``, ``mu``
    and ``nu``, each readable by ``np.asarray``: ``step`` a scalar, ``mu``
    and ``nu`` nested dicts of arrays, ``nu`` empty for SGD) -> the port's
    ``AdamWState`` on ``device``, so a run resumes mid-training from JAX's
    optimizer state and not only its weights."""
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    nu = params_from_numpy(state.nu, device) \
        if isinstance(state.nu, Mapping) else ()
    return AdamWState(step=step, mu=params_from_numpy(state.mu, device),
                      nu=nu)
