"""Sharding rules and the single-controller sharded tensor.

The JAX package's ``distributed/sharding.py``:

  * TP over ``'model'`` on the head, ffn, vocab and expert dims; FSDP over
    ``'data'`` on the other big dim of every matrix (``_base_spec``,
    ``param_pspec``, ``params_pspecs``); a stacked layer leaf (under
    ``_STACK_KEYS``) gets a leading ``None``; EP over ``'model'`` where the
    expert count divides it, TP within an expert otherwise;
  * batch over ``('pod', 'data')`` (``batch_axes``, ``batch_pspecs``);
  * decode caches: batch over the data axes, the sequence of an attention
    cache and the heads of an SSM state over ``'model'``
    (``cache_pspec``, ``cache_pspecs``; ``cache_shardings`` sanitizes them
    for a model's cache, and ``distributed/serve_spmd.py`` serves over the
    placed cache);
  * optimizer moments inherit their parameters' specs
    (``opt_state_pspecs``);
  * ``sanitize_pspec`` drops a mesh axis from a dimension it does not
    divide (batch 1 on a 2-way data axis, 8 KV heads on a 16-way axis, a
    ragged C_out), so that dimension is computed replicated instead of
    raising (``sanitized_shardings``).

The rules read only ``mesh.shape`` and ``mesh.axis_names``, so they run
over a stand-in mesh, and over leaves that only have a ``shape`` (the
meta tensors of ``Model.init_abstract``).  Paths are named as the JAX
package's ``_path_str`` names them: dict keys, sequence indices as
strings, NamedTuple fields as ``.field``.

``P`` is the port's PartitionSpec: a tuple with one entry per tensor
dimension, each an axis name, a tuple of axis names or ``None``
(replicated); missing trailing entries are ``None``.
:class:`NamedSharding` pairs a spec with its mesh, as JAX's does.

:class:`Sharded` is what ``jax.Array``'s sharding gives the JAX code: a
global tensor cut over a :class:`~repro_torch.launch.mesh.Mesh` by a
spec, one shard per mesh coordinate on that coordinate's device, held by
one process (no ``torch.distributed`` group: the sharded conv backend
and the sharded train step, ``distributed/lm_spmd.py``, drive every
shard themselves).  :func:`place` is ``jax.device_put(tree,
shardings)``: each leaf cut into blocks that own their memory, one copy
of a block per device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.tree import _is_namedtuple, tree_map


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


def _model_size(mesh) -> int:
    return mesh.shape["model"]


def _base_spec(name: str, core_shape: Tuple[int, ...], cfg: ModelConfig,
               mesh) -> P:
    """The spec of leaf ``name`` of core shape ``core_shape`` (without the
    stacked leading layer axis)."""
    ndim = len(core_shape)
    fs = "data"          # FSDP axis
    tp = "model"         # tensor-parallel axis

    # ---- embeddings / head ----
    if name == "embed":
        return P(tp, fs)
    if name == "lm_head":
        return P(fs, tp)

    # ---- MoE expert stacks (E, d, f) / (E, f, d) ----
    if (name in ("w_gate", "w_up", "w_down") and ndim == 3
            and cfg.n_experts and core_shape[0] == cfg.n_experts):
        ep_ok = cfg.n_experts % _model_size(mesh) == 0
        if name == "w_down":
            return P(tp, None, fs) if ep_ok else P(None, tp, fs)
        return P(tp, fs, None) if ep_ok else P(None, fs, tp)
    if name == "router":
        return P(fs, None)

    # ---- attention (per-head 3-D layout) ----
    if ndim == 3 and name == "wq":
        return P(fs, tp, None)        # (d, Hq, hd): q-heads over model
    if ndim == 3 and name in ("wk", "wv"):
        return P(fs, None, None)      # K/V replicated over model (small)
    if ndim == 3 and name == "wo":
        return P(tp, None, fs)        # (Hq, hd, d)

    # ---- MLA / dense / ssm projections ----
    if ndim == 2 and name in ("wq", "wk", "wv", "wq_b", "wkv_b", "w_gate",
                              "w_up", "in_proj", "proj", "wq_a", "wkv_a"):
        return P(fs, tp)
    if ndim == 2 and name in ("wo", "w_down", "out_proj"):
        return P(tp, fs)
    if ndim == 2 and name == "conv_w":
        return P(None, tp)

    # everything else (norm scales, biases, gates, A_log, D, dt_bias):
    return P(*([None] * ndim))


_STACK_KEYS = ("blocks", "dense_blocks", "cross_blocks", "enc_blocks")


def param_pspec(path: Tuple[str, ...], leaf, cfg: ModelConfig, mesh) -> P:
    stacked = any(str(k) in _STACK_KEYS for k in path)
    core_shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
    base = _base_spec(path[-1], core_shape, cfg, mesh)
    return P(None, *base) if stacked else base


def _with_paths(tree, prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """Every leaf with its path as the JAX package's ``_path_str`` names
    it: dict keys, sequence indices as strings, NamedTuple fields as
    ``.field``.  A ``P`` and a ``NamedSharding`` are leaves."""
    if isinstance(tree, (P, NamedSharding)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from _with_paths(v, prefix + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _with_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def tree_map_with_path(fn, tree, *rest):
    """``fn(path, leaf, *other_leaves)`` over ``tree``'s leaves (and those
    of trees of the same structure), paths as :func:`_with_paths`."""
    pairs = list(_with_paths(tree))
    others = [[leaf for _, leaf in _with_paths(r)] for r in rest]
    if any(len(o) != len(pairs) for o in others):
        raise ValueError("the trees hold different numbers of leaves")
    return _rebuild(tree, [fn(path, leaf, *(o[i] for o in others))
                           for i, (path, leaf) in enumerate(pairs)])


def _rebuild(like, new_leaves):
    """``like``'s structure with its leaves (``P`` and ``NamedSharding``
    counted as leaves) replaced, in walk order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, (P, NamedSharding)):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)
    return build(like)


def params_pspecs(abstract_params, cfg: ModelConfig, mesh):
    """A tree of ``P`` matching the parameter tree."""
    return tree_map_with_path(
        lambda p, leaf: param_pspec(p, leaf, cfg, mesh), abstract_params)


def params_shardings(abstract_params, cfg: ModelConfig, mesh):
    return to_shardings(params_pspecs(abstract_params, cfg, mesh), mesh)


def cache_pspec(path: Tuple[str, ...], leaf, cfg: ModelConfig, mesh) -> P:
    """KV caches (L?, B, S, H, D), SSM states, cross K/V: the batch over
    the data axes; the *sequence* dim of attention caches over 'model'
    (GQA head counts below the axis cannot shard the head dim; context
    lengths always divide), SSM states over their heads."""
    name = path[-1]
    b = batch_axes(mesh)
    nd = len(leaf.shape)
    stacked = any(str(k) in ("layers", "dense_layers", "shared")
                  for k in path) or name in ("cross_k", "cross_v")
    lead = (None,) if stacked else ()
    if name in ("k", "v", "cross_k", "cross_v"):     # (B, S, Hkv, D)
        return P(*lead, b, "model", None, None)
    if name == "c_kv":                               # (B, S, kr)
        return P(*lead, b, "model", None)
    if name == "k_rope":                             # (B, S, dr)
        return P(*lead, b, "model", None)
    if name == "state":                              # (B, H, P, N)
        return P(*lead, b, "model", None, None)
    if name == "conv":                               # (B, R-1, ch)
        return P(*lead, b, None, "model")
    return P(*([None] * nd))


def cache_pspecs(abstract_cache, cfg: ModelConfig, mesh):
    return tree_map_with_path(
        lambda p, leaf: cache_pspec(p, leaf, cfg, mesh), abstract_cache)


def cache_shardings(model, shape, mesh, abstract=None):
    """The decode cache's ``NamedSharding``s at ``shape`` (a
    ``ShapeConfig``): ``cache_pspecs`` of ``model.cache_abstract(shape)``
    (``abstract``, where the caller has it), sanitized leaf by leaf, as
    the JAX dry run places its cache.  What a mesh axis does not divide is
    replicated: llama-3.2-vision's 1,601 vision tokens on a 2- or 4-way
    ``'model'`` axis, batch 1 on a 2-way data axis."""
    if abstract is None:
        abstract = model.cache_abstract(shape)
    return sanitized_shardings(cache_pspecs(abstract, model.cfg, mesh),
                               abstract, mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: P


def sanitized_shardings(pspecs, abstract_tree, mesh):
    """``NamedSharding``s with non-divisible axes dropped per leaf."""
    return tree_map_with_path(
        lambda _, s, leaf: NamedSharding(
            mesh, sanitize_pspec(s, tuple(leaf.shape), mesh)),
        pspecs, abstract_tree)


def to_shardings(pspecs, mesh):
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), pspecs)


def place(tree, shardings):
    """``jax.device_put(tree, shardings)``: each tensor leaf a
    :class:`Sharded` by its ``NamedSharding`` (a ``Sharded`` leaf is
    gathered and cut anew: elastic re-sharding).  Its blocks own their
    memory (none is a view that keeps ``tree``'s leaf alive) and one
    device holds one copy of a block, whatever replicas its mesh
    coordinates hold."""
    def put(_, leaf, s):
        x = leaf.gather() if isinstance(leaf, Sharded) else leaf
        return Sharded.place(x, s.spec, s.mesh, own=True)
    return tree_map_with_path(put, tree, shardings)


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


def block_of(x: torch.Tensor, spec, mesh: Mesh, index) -> torch.Tensor:
    """The block ``index`` of ``x`` cut by ``spec`` (a view)."""
    blocks = _blocks(spec, x.dim(), mesh)
    return x[tuple(slice(i * (n // k), (i + 1) * (n // k))
                   for i, n, k in zip(index, x.shape, blocks))]


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
    def place(cls, x: torch.Tensor, spec, mesh: Mesh,
              own: bool = False) -> "Sharded":
        """Cut ``x`` by ``spec`` (sanitized against ``x``'s shape) and copy
        each block to its coordinate's device, contiguous.  A block that
        is ``x`` whole on ``x``'s own device is a view of ``x``.  With
        ``own`` (the state of a sharded model), a block that would be a
        view of part of ``x`` is a copy, and the coordinates of one
        device share one copy of a block."""
        spec = sanitize_pspec(spec, tuple(x.shape), mesh)
        shards = np.empty(mesh.devices.shape, dtype=object)
        made: Dict[Any, torch.Tensor] = {}
        block = tuple(n // k for n, k in
                      zip(x.shape, _blocks(spec, x.dim(), mesh)))
        for coord in mesh.coords():
            index = _block_index(spec, x.dim(), mesh, coord)
            device, home = mesh.device(coord), mesh.home(coord)
            if own and (index, home) in made:
                shards[coord] = made[(index, home)]
                continue
            if own and x.is_meta and device.type == "meta":
                # shapes only: a block of its own, as the copy below
                # makes, with no slicing to dispatch
                part = x if home == device and block == tuple(x.shape) \
                    else torch.empty(block, dtype=x.dtype, device="meta")
                shards[coord] = made[(index, home)] = part
                continue
            part = block_of(x, spec, mesh, index).to(device).contiguous()
            if own and (home != device or part.numel() < x.numel()
                        and part.untyped_storage().data_ptr()
                        == x.untyped_storage().data_ptr()):
                # (each coordinate of a meta mesh is a card of its own)
                part = part.clone()
            shards[coord] = made[(index, home)] = part
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
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    def block_index(self, coord) -> Tuple[int, ...]:
        return _block_index(self.spec, len(self.shape), self.mesh, coord)

    def unique(self) -> Dict[Tuple[int, ...], Any]:
        """Block index -> the mesh coordinates that hold that block, in
        row-major order: the first holds the block's one update."""
        out: Dict[Tuple[int, ...], Any] = {}
        for coord in self.mesh.coords():
            out.setdefault(self.block_index(coord), []).append(coord)
        return out

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
