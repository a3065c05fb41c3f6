"""Sharding rules and the single-controller sharded tensor.

The conv and batch half of the JAX package's ``distributed/sharding.py``:

  * batch over ``('pod', 'data')`` (``batch_axes``, ``batch_pspecs``);
  * optimizer moments inherit their parameters' specs
    (``opt_state_pspecs``);
  * ``sanitize_pspec`` drops a mesh axis from a dimension it does not
    divide (batch 1 on a 2-way data axis, a ragged C_out), so that
    dimension is computed replicated instead of raising.

``P`` is the port's PartitionSpec: a tuple with one entry per tensor
dimension, each an axis name, a tuple of axis names or ``None``
(replicated); missing trailing entries are ``None``.

:class:`Sharded` is what ``jax.Array``'s sharding gives the JAX code: a
global tensor cut over a :class:`~repro_torch.launch.mesh.Mesh` by a
spec, one shard per mesh coordinate on that coordinate's device, held by
one process (no ``torch.distributed`` group: the sharded conv backend
drives every shard itself).  The rules keyed on ``ModelConfig`` and the
LM parameter paths (``param_pspec``, ``cache_pspec``, ...) come with the
LM models.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_map


class P(tuple):
    """PartitionSpec: ``P("data", None, ("pod", "model"))``.  A one-axis
    tuple entry is that axis (``P(("data",))`` is ``P("data")``), as
    ``jax.sharding.PartitionSpec`` has it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def sanitize_pspec(spec, shape: Tuple[int, ...], mesh) -> P:
    """Drop mesh axes from dims they do not divide (batch 1 on a data
    axis, a C_out the model axis does not divide, ...): that dimension is
    then replicated.  ``mesh`` needs only a ``shape`` mapping."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        size = 1
        for a in _axes(entry):
            size *= mesh.shape[a]
        out.append(entry if shape[i] % size == 0 else None)
    return P(*out)


def batch_pspecs(batch_specs, mesh):
    """Every leaf (anything with a ``shape``) sharded over the batch axes
    on its leading dimension."""
    b = batch_axes(mesh)

    def spec(leaf):
        return P(b, *([None] * (len(leaf.shape) - 1)))
    return tree_map(spec, batch_specs)


def opt_state_pspecs(abstract_opt_state, pspecs_params):
    """AdamW moments inherit the parameter specs; step is replicated."""
    from repro_torch.optim.optimizers import AdamWState
    return AdamWState(step=P(), mu=pspecs_params, nu=pspecs_params)


def _blocks(spec, ndim: int, mesh: Mesh) -> Tuple[int, ...]:
    """Blocks per dimension: the product of the sizes of its axes."""
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(math.prod(mesh.shape[a] for a in _axes(e))
                 for e in entries[:ndim])


def _block_index(spec, ndim: int, mesh: Mesh, coord) -> Tuple[int, ...]:
    """The block of each dimension that mesh coordinate ``coord`` holds:
    a dimension over axes (a, b) is cut a-major, as JAX cuts it."""
    where = dict(zip(mesh.axis_names, coord))
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    index = []
    for e in entries[:ndim]:
        i = 0
        for a in _axes(e):
            i = i * mesh.shape[a] + where[a]
        index.append(i)
    return tuple(index)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A global tensor of ``shape`` cut over ``mesh`` by ``spec``:
    ``shards[coord]`` is the block mesh coordinate ``coord`` holds, on
    that coordinate's device.  Along a mesh axis that ``spec`` does not
    name, every coordinate holds the same block (replication)."""

    mesh: Mesh
    spec: P
    shape: Tuple[int, ...]
    shards: np.ndarray            # object array of mesh.devices' shape

    @classmethod
    def place(cls, x: torch.Tensor, spec, mesh: Mesh) -> "Sharded":
        """Cut ``x`` by ``spec`` (sanitized against ``x``'s shape) and copy
        each block to its coordinate's device, contiguous.  A block that
        is ``x`` whole on ``x``'s own device is ``x`` itself."""
        spec = sanitize_pspec(spec, tuple(x.shape), mesh)
        blocks = _blocks(spec, x.dim(), mesh)
        shards = np.empty(mesh.devices.shape, dtype=object)
        for coord in mesh.coords():
            index = _block_index(spec, x.dim(), mesh, coord)
            part = x[tuple(slice(i * (n // k), (i + 1) * (n // k))
                           for i, n, k in zip(index, x.shape, blocks))]
            shards[coord] = part.to(mesh.device(coord)).contiguous()
        return cls(mesh, spec, tuple(x.shape), shards)

    @classmethod
    def from_shards(cls, mesh: Mesh, spec, shards: np.ndarray) -> "Sharded":
        """Wrap per-coordinate blocks; the global shape follows from the
        first block and the spec."""
        first = shards.flat[0]
        blocks = _blocks(spec, first.dim(), mesh)
        shape = tuple(n * k for n, k in zip(first.shape, blocks))
        return cls(mesh, P(*spec), shape, shards)

    @property
    def is_fully_replicated(self) -> bool:
        return all(e is None for e in self.spec)

    def shard(self, coord) -> torch.Tensor:
        return self.shards[tuple(coord)]

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first shard's),
        joined by ``torch.cat`` from one replica of each block."""
        ndim = len(self.shape)
        device = torch.device(device) if device is not None \
            else self.shards.flat[0].device
        by_index: Dict[Tuple[int, ...], Any] = {}
        for coord in self.mesh.coords():
            by_index.setdefault(
                _block_index(self.spec, ndim, self.mesh, coord),
                self.shards[coord])
        blocks = _blocks(self.spec, ndim, self.mesh)

        def join(prefix, d):
            if d == ndim:
                return by_index[prefix].to(device)
            parts = [join(prefix + (i,), d + 1) for i in range(blocks[d])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)
        return join((), 0)

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"mesh={self.mesh.shape})")
