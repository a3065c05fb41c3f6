"""Each weight block computed where it lies: the block arithmetic over a
(data, model) mesh that the sharded decode step (``serve_spmd``), the
sharded train step (``lm_spmd``) and the sharded prefill share.

The JAX package places a model's parameters by ``params_pspecs`` (FSDP
over ``'data'``, TP/EP over ``'model'``) and GSPMD computes each weight
block where it lies, in the forward, in its backward and in the decode
step.  The port has no compiler, so this module does it by hand for one
*data row*: a coordinate of the data axes and its line of ``'model'``
coordinates (:class:`_Row`), in the single-controller design of the
sharded conv backend (one process drives every block on its coordinate's
device; a mesh may repeat one device).

  * **Weights** (:class:`_W`).  A leaf whose sanitized spec keeps
    ``'model'`` runs on each of its model blocks' coordinates, (row, m):
    coordinate (r, m) fetches only its own model block over the data
    axes, from the coordinates (r', m) of the other rows (a stacked leaf
    layer by layer where the model takes the layer, the others once a
    step), so on one data row no weight byte moves.  A leaf that
    ``'model'`` does not cut runs at the row's first coordinate, gathered
    over the data axes there; one that the whole mesh holds alike (a
    norm's scale, a bias) is also taken where a block runs, from that
    coordinate's own copy (:meth:`_Row.replicas`).  No model-split leaf
    is ever gathered whole.
  * **Under autograd** every fetch is an autograd ``Function``
    (:class:`_Fetch`, :class:`_Replicas`) whose backward adds the
    gradient into the gradient blocks it was fetched from (``_Leaf``):
    the reduce-scatter over the data axes only.
  * **Per-token tensors** move between coordinates (:class:`_Cut`): the
    row's input goes to each block's coordinate, column blocks' outputs
    come back joined in order, row blocks' partial sums are added at the
    row in ascending block order, with no atomics.  A tensor that several
    coordinates (or several uses) take goes through one :class:`_Tee`,
    whose backward sums the gradients at the tensor's coordinate in that
    order: autograd runs a card's backward on a thread of its own, and
    three or more gradients added in the order the threads finish would
    change a float32 sum from one run to the next.

:class:`Split` holds the block arithmetic (column and row products, the
heads' output, the embedding's vocab blocks, the head's vocab columns,
SwiGLU, the MoE's experts); :class:`Forward` is
``transformer.ForwardOps`` over it, the training forward's attention
(flash attention per head block where the blocks' edges fall on whole
heads, at the row for a head an edge cuts), MLA, cross-attention, MoE,
SSM (``in_proj`` columns, the conv by channel block, ``out_proj`` rows;
the scan at the row) and MTP projection.  An operation whose leaves are
each one block at the row (the mesh's model axis is 1, or ``'model'``
cuts none of them) runs the plain function, so a mesh of one coordinate
computes the unsharded step's bits.

:func:`copied` counts the bytes moved between mesh coordinates, as
``weights``, ``activations``, ``cache``, ``gradients`` (the fetches'
backward into another coordinate's gradient block) and ``outputs`` (a
step's output copied to the coordinates that hold it beside the one that
computed it: the serve step's next tokens over ``'model'``, logits one
row computed over the data axes).  On a mesh that
repeats one device these are the copies the same mesh would make over
distinct devices.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_util
from repro_torch.core.precision import full_fp32_matmul
from repro_torch.distributed import act_sharding, coords as coords_lib
from repro_torch.distributed.sharding import (P, Sharded, _STACK_KEYS, _axes,
                                              block_of, tree_map_with_path)
from repro_torch.models import attention as attn
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models import transformer as tfm

_COPIED = {"weights": 0, "activations": 0, "cache": 0, "gradients": 0,
           "outputs": 0}
_COUNT_LOCK = threading.Lock()
_GRAD_LOCK = threading.Lock()


def _count(kind: str, t: torch.Tensor, src, dst, src_fixed: bool = False,
           dst_fixed: bool = False) -> None:
    # backward threads count too (a rematerialised layer, the gradients)
    n = t.numel() * t.element_size()
    with _COUNT_LOCK:
        _COPIED[kind] += n
    coords_lib.copied(kind, n, src, dst, src_fixed, dst_fixed)


def copied() -> Dict[str, int]:
    """Bytes moved between mesh coordinates since :func:`reset_copied`."""
    return dict(_COPIED)


def reset_copied() -> None:
    for k in _COPIED:
        _COPIED[k] = 0


# --------------------------------------------------------------------------
# a placed leaf in one step: its blocks and its gradient blocks
# --------------------------------------------------------------------------
def _model_dim(core) -> Optional[int]:
    """The dimension of a leaf's layer (the stack axis dropped) that
    ``'model'`` cuts; None where it cuts none."""
    for d, e in enumerate(core):
        if "model" in _axes(e):
            if e != "model":
                raise ValueError(f"a dimension cut over {e}: the step "
                                 f"splits a dimension over 'model' alone")
            return d
    return None


def _join(parts: Dict[Tuple[int, ...], torch.Tensor]) -> torch.Tensor:
    """Blocks keyed by their block index (the indices of each dimension
    consecutive), joined along each dimension in order."""
    keys = list(parts)
    ndim = len(keys[0])
    lo = [min(k[d] for k in keys) for d in range(ndim)]
    hi = [max(k[d] for k in keys) for d in range(ndim)]

    def join(prefix, d):
        if d == ndim:
            return parts[prefix]
        cut = [join(prefix + (i,), d + 1) for i in range(lo[d], hi[d] + 1)]
        return cut[0] if len(cut) == 1 else torch.cat(cut, dim=d)
    return join((), 0)


class _Leaf:
    """A parameter leaf in one step: its blocks, and float32 gradient
    blocks on the blocks' devices (the first coordinate holding each),
    added into by the fetches' backward."""

    def __init__(self, sh: Sharded, stacked: bool):
        self.sh, self.stacked = sh, stacked
        self.core = P(*tuple(sh.spec)[1:]) if stacked else sh.spec
        self.unique = sh.unique()
        self.grads: Dict[Tuple[int, ...], torch.Tensor] = {}

    @property
    def dim(self) -> Optional[int]:
        """The dimension of a layer that ``'model'`` cuts (None: none)."""
        return _model_dim(self.core)

    @property
    def replicated(self) -> bool:
        """Every coordinate holds the leaf whole."""
        return all(e is None for e in self.core)

    def _source(self, coords, at) -> Tuple[int, ...]:
        """Of the coordinates ``coords`` that hold a block, the one whose
        copy coordinate ``at`` reads: ``at`` itself, else one on its
        device, else the first."""
        if at in coords:
            return at
        home = self.sh.mesh.home(at)
        return next((c for c in coords if self.sh.mesh.home(c) == home),
                    coords[0])

    def gather(self, index, at) -> torch.Tensor:
        """The leaf (layer ``index`` of a stacked one) whole on coordinate
        ``at``."""
        parts = {}
        for idx, coords in self.unique.items():
            src = self._source(coords, at)
            b = self.sh.shards[src]
            b = b if index is None else b[index]
            parts[idx[1:] if self.stacked else idx] = \
                b if src == at else coords_lib.move(b, self.sh.mesh, at)
        return _join(parts)

    @property
    def fixed(self) -> bool:
        """Its gradient blocks lie where no data row moves them: the data
        axes cut none of its dimensions (the dry run's ``coords``)."""
        return not any("data" in _axes(e) for e in self.sh.spec)

    def _buffer(self, idx) -> torch.Tensor:
        # autograd's device threads add into the blocks; each block's
        # adds come from one thread, its first from any
        with _GRAD_LOCK:
            buf = self.grads.get(idx)
            if buf is None:
                c0 = self.unique[idx][0]
                with coords_lib.at(c0, self.fixed):
                    buf = self.grads[idx] = torch.zeros(
                        self.sh.shards[c0].shape, dtype=torch.float32,
                        device=self.sh.mesh.device(c0))
        return buf

    def _add(self, idx, index, part: torch.Tensor, at) -> None:
        c0 = self.unique[idx][0]
        if tuple(c0) != tuple(at):
            _count("gradients", part, at, c0, dst_fixed=self.fixed)
            if coords_lib.TRACKER is not None:
                part = coords_lib.move(part, self.sh.mesh, c0, self.fixed)
        buf = self._buffer(idx)
        dst = buf if index is None else buf[index]
        dst.add_(part.to(device=buf.device, dtype=torch.float32))

    def add_grad(self, index, g: torch.Tensor, at) -> None:
        """The whole leaf's gradient ``g`` (layer ``index``), computed at
        coordinate ``at``, cut by the leaf's spec into its blocks."""
        for idx in self.unique:
            self._add(idx, index, block_of(g, self.core, self.sh.mesh,
                                           idx[1:] if self.stacked
                                           else idx), at)

    def add_block_grad(self, index, m: int, g: torch.Tensor, at) -> None:
        """Model block ``m``'s gradient ``g`` (layer ``index``), computed
        at coordinate ``at``, cut into the blocks over the data axes it
        was joined from."""
        off = 1 if self.stacked else 0
        parts = {idx: coords for idx, coords in self.unique.items()
                 if idx[self.dim + off] == m}
        keys = [idx[off:] for idx in parts]
        lo = [min(k[e] for k in keys) for e in range(len(keys[0]))]
        for idx, coords in parts.items():
            k = idx[off:]
            shape = self.sh.shards[coords[0]].shape[off:]
            cut = tuple(slice((k[e] - lo[e]) * shape[e],
                              (k[e] - lo[e] + 1) * shape[e])
                        for e in range(len(k)))
            self._add(idx, index, g[cut], at)

    def grad(self, idx) -> torch.Tensor:
        """The gradient block ``idx`` (zeros where the loss did not reach
        the leaf, as in JAX)."""
        g = self.grads.get(idx)
        if g is None:
            c0 = self.unique[idx][0]
            with coords_lib.at(c0, self.fixed):
                g = torch.zeros(self.sh.shards[c0].shape,
                                dtype=torch.float32,
                                device=self.sh.mesh.device(c0))
        return g


def param_leaves(params):
    """A placed parameter tree's leaves as :class:`_Leaf` (stacked where
    the path names a layer stack)."""
    return tree_map_with_path(
        lambda path, sh: _Leaf(sh, any(k in _STACK_KEYS for k in path)),
        params)


# --------------------------------------------------------------------------
# the fetches and the fan-out under autograd
# --------------------------------------------------------------------------
class _Fetch(torch.autograd.Function):
    """Forward: a leaf's weight where a row's operation takes it, model
    block ``m`` over the data axes on the row's coordinate ``at(m)``, or
    (``m`` None) a leaf ``'model'`` does not cut whole at the row.
    Backward: its gradient cut by the blocks it was joined from and added
    into their gradient blocks.  ``anchor`` is an empty tensor that
    requires grad, so the output records and the backward runs."""

    @staticmethod
    def forward(ctx, anchor, row, leaf, index, m):
        ctx.row, ctx.leaf, ctx.index, ctx.m = row, leaf, index, m
        if m is None:
            return row._whole_at_row(leaf, index).detach()
        return row._model_block(leaf, index, m).detach()

    @staticmethod
    def backward(ctx, g):
        row = ctx.row
        if ctx.m is None:
            ctx.leaf.add_grad(ctx.index, g, row.coord)
        else:
            ctx.leaf.add_block_grad(ctx.index, ctx.m, g, row.at(ctx.m))
        return None, None, None, None, None


class _Replicas(torch.autograd.Function):
    """Forward: a leaf that every coordinate holds whole (layer ``index``
    of a stacked one) as each of ``coords`` holds it: no byte moves.
    Backward: the gradients summed at the row in the order of ``coords``
    and added into the leaf's gradient once."""

    @staticmethod
    def forward(ctx, anchor, row, leaf, index, coords):
        ctx.row, ctx.leaf, ctx.index, ctx.coords = row, leaf, index, coords
        out = []
        for c in coords:
            t = leaf.sh.shards[c]
            out.append((t if index is None else t[index]).detach())
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        row, total = ctx.row, None
        for g, c in zip(gs, ctx.coords):
            g = row.send(g, c, row.coord, "gradients")
            total = g if total is None else total + g
        ctx.leaf.add_grad(ctx.index, total, row.coord)
        return None, None, None, None, None


class _Tee(torch.autograd.Function):
    """Forward: a per-token tensor at coordinate ``src`` as each of
    ``coords`` takes it, one output a use (one copy a coordinate, views
    of it).  Backward: the outputs' gradients summed on ``src``'s device
    in the order of ``coords``, whatever order autograd's device threads
    finish in."""

    @staticmethod
    def forward(ctx, x, row, src, coords):
        ctx.row, ctx.src, ctx.coords = row, src, coords
        made: Dict[tuple, torch.Tensor] = {}
        out = []
        for c in coords:
            if c not in made:
                made[c] = row.send(x, src, c)
            out.append(made[c].view_as(made[c]))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        total = None
        for g, c in zip(gs, ctx.coords):
            if c != ctx.src:
                g = coords_lib.move(g, ctx.row.mesh, ctx.src)
            total = g if total is None else total + g
        return total, None, None, None


# --------------------------------------------------------------------------
# a data row
# --------------------------------------------------------------------------
class _Row:
    """One data row's compute: its first coordinate and device, the
    coordinates of its line along ``'model'``, the copies to and from
    them (counted in :data:`_COPIED`), and the weights' fetches.  With an
    ``anchor`` (an empty tensor that requires grad) the fetches record
    for autograd."""

    def __init__(self, mesh, coord, index: int, anchor=None):
        self.mesh, self.coord, self.index = mesh, tuple(coord), index
        self.anchor = anchor
        self._once: Dict[tuple, object] = {}
        self._replicated: Dict[int, tuple] = {}
        self.device = mesh.device(coord)
        self.origin = (0,) * len(mesh.axis_names)
        self.model_axis = mesh.axis_names.index("model")
        keep = [i for i, a in enumerate(mesh.axis_names) if a != "model"]
        self.line = {c for c in mesh.coords()
                     if all(c[i] == self.coord[i] for i in keep)}

    @property
    def recording(self) -> bool:
        return self.anchor is not None and torch.is_grad_enabled()

    def once(self, key: tuple, make):
        """``make()``, made once a step (a row lives one step): what every
        layer derives alike from the step's positions."""
        if key not in self._once:
            self._once[key] = make()
        return self._once[key]

    def at(self, m: int) -> Tuple[int, ...]:
        """The row's coordinate at index ``m`` of ``'model'``."""
        c = list(self.coord)
        c[self.model_axis] = m
        return tuple(c)

    def send(self, t, src, dst, kind="activations"):
        src, dst = tuple(src), tuple(dst)
        if src == dst:
            return t.to(self.mesh.device(dst))
        # the mesh's first coordinate holds what a step takes from it
        # (``take``) or joins there, whichever row sends (``coords``:
        # fixed)
        _count(kind, t, src, dst, src == self.origin, dst == self.origin)
        return coords_lib.move(t, self.mesh, dst, dst == self.origin)

    def to(self, t, coord, kind="activations"):
        return self.send(t, self.coord, coord, kind)

    def back(self, ts, coord):
        return tuple(self.send(t, coord, self.coord) for t in ts)

    def take(self, t):
        """An input held at the mesh's first coordinate (the sharded CNN
        step's batch), sent to the row."""
        return self.send(t, self.origin, self.coord)

    def block(self, sh: Sharded, lo: int, hi: int) -> torch.Tensor:
        """Elements lo..hi along the leading (batch) dimension of an input
        placed on the mesh, from the block the row's coordinate holds:
        no byte moves.  Raises where that block does not hold them."""
        t = sh.shards[self.coord]
        a = sh.block_index(self.coord)[0] * t.shape[0]
        if not a <= lo < hi <= a + t.shape[0]:
            raise ValueError(f"the row at {self.coord} holds elements "
                             f"{a}..{a + t.shape[0]} of {sh}, not "
                             f"{lo}..{hi}")
        return t if (lo, hi) == (a, a + t.shape[0]) else t[lo - a:hi - a]

    def fan(self, t, coords, src=None) -> List[torch.Tensor]:
        """``t`` (at ``src``, the row's coordinate by default) for each of
        ``coords``, one entry a use: under autograd one :class:`_Tee`,
        else one copy a coordinate."""
        src = self.coord if src is None else tuple(src)
        coords = tuple(tuple(c) for c in coords)
        if torch.is_grad_enabled() and t.requires_grad:
            return list(_Tee.apply(t, self, src, coords))
        made: Dict[tuple, torch.Tensor] = {}
        for c in coords:
            if c not in made:
                made[c] = self.send(t, src, c)
        return [made[c] for c in coords]

    def at_positions(self, positions, coord) -> torch.Tensor:
        """The forward's positions on ``coord`` (sent once a step)."""
        return self.once(("positions", id(positions), tuple(coord)),
                         lambda: (positions, self.to(positions, coord)))[1]

    # ---- the weights' fetches ---------------------------------------------
    def _whole_at_row(self, leaf: _Leaf, index) -> torch.Tensor:
        for idx, coords in leaf.unique.items():
            if self.coord not in coords:
                b = leaf.sh.shards[coords[0]]
                _count("weights", b if index is None else b[index],
                       leaf._source(coords, self.coord), self.coord)
        return leaf.gather(index, self.coord)

    def _model_block(self, leaf: _Leaf, index, m: int) -> torch.Tensor:
        at = self.at(m)
        d = leaf.dim + (1 if leaf.stacked else 0)
        if all(at in coords for idx, coords in leaf.unique.items()
               if idx[d] == m):
            # the coordinate holds its model block whole
            t = leaf.sh.shards[at]
            return t if index is None else t[index]
        parts = {}
        for idx, coords in leaf.unique.items():
            if idx[d] != m:
                continue
            src = leaf._source(coords, at)
            b = leaf.sh.shards[src]
            b = b if index is None else b[index]
            if at not in coords:
                _count("weights", b, src, at)
            parts[idx[1:] if leaf.stacked else idx] = \
                b if src == at else coords_lib.move(b, self.mesh, at)
        return _join(parts)

    def gather(self, leaf: _Leaf, index, dtype) -> torch.Tensor:
        """The leaf (layer ``index`` of a stacked one) whole on the row's
        device in ``dtype`` (floating leaves): a leaf ``'model'`` does not
        cut, gathered over the data axes."""
        t = _Fetch.apply(self.anchor, self, leaf, index, None) \
            if self.recording else self._whole_at_row(leaf, index)
        return t.to(dtype) if t.is_floating_point() else t

    def model_block(self, leaf: _Leaf, index, m: int, dtype
                    ) -> torch.Tensor:
        """Block ``m`` along ``'model'`` of a model-split leaf (layer
        ``index`` of a stacked one) on coordinate ``at(m)``, in ``dtype``
        (floating leaves): its blocks over the data axes, those the
        coordinate does not hold copied from the coordinates that do."""
        t = _Fetch.apply(self.anchor, self, leaf, index, m) \
            if self.recording else self._model_block(leaf, index, m)
        return t.to(dtype) if t.is_floating_point() else t

    def replicas(self, t, coords) -> List[torch.Tensor]:
        """A leaf every coordinate holds whole, as :meth:`weight` gave it
        at the row (``t``), on each of ``coords`` from that coordinate's
        own copy."""
        coords = tuple(tuple(c) for c in coords)
        leaf, index, ref = self._replicated[id(t)]
        if ref() is not t:
            raise KeyError("a tensor that is no leaf's weight at the row")
        if self.recording:
            out = _Replicas.apply(self.anchor, self, leaf, index, coords)
        else:
            out = [leaf.sh.shards[c] if index is None
                   else leaf.sh.shards[c][index] for c in coords]
        return [o.to(t.dtype) for o in out]

    def blocks(self, w, dim: int) -> List["_Blk"]:
        """A weight's blocks along its dimension ``dim``, each on its
        coordinate: a plain tensor (the row's own) or a leaf that
        ``'model'`` does not cut is one block at the row."""
        if isinstance(w, torch.Tensor):
            return [_Blk(0, w.shape[dim], self.coord, w)]
        if w.dim is None:
            (c, t), = w.blocks()
            return [_Blk(0, t.shape[dim], c, t)]
        if w.dim != dim:
            raise ValueError(f"a leaf cut over 'model' on its dimension "
                             f"{w.dim}, where the step cuts its dimension "
                             f"{dim}")
        out, lo = [], 0
        for c, t in w.blocks():
            out.append(_Blk(lo, lo + t.shape[dim], c, t))
            lo += t.shape[dim]
        return out

    def weight(self, leaf: _Leaf, index, dtype):
        """A leaf (layer ``index`` of a stacked one): the row's own tensor
        where the whole mesh holds it alike, else a :class:`_W`, whose
        blocks are fetched where an operation takes them."""
        if leaf.replicated:
            t = self.gather(leaf, index, dtype)
            # a weak reference: the row must not hold the tensors whose
            # fetch (``_Fetch``'s context) holds the row, a cycle through
            # autograd's graph that Python's collector cannot see
            self._replicated[id(t)] = (leaf, index, weakref.ref(t))
            return t
        return _W(self, leaf, index, dtype)

    def weights(self, leaves, dtype, keys):
        """The row's parameter tree over ``keys`` (:meth:`weight`; a
        stacked leaf's layer where indexed)."""
        def use(leaf):
            if leaf.stacked:
                return _Indexed(self, leaf, dtype)
            return self.weight(leaf, None, dtype)
        return {k: tree_util.tree_map(use, leaves[k]) for k in keys
                if k in leaves}


class _Blk(NamedTuple):
    """A block of a tensor: its extent lo..hi along the cut dimension, its
    coordinate, and the block."""
    lo: int
    hi: int
    coord: Tuple[int, ...]
    t: torch.Tensor


class _Indexed:
    """A stacked leaf in a row's tree: indexing it gives the layer's
    weight (``transformer.layer``, :meth:`_Row.weight`)."""

    def __init__(self, row: _Row, leaf: _Leaf, dtype):
        self.row, self.leaf, self.dtype = row, leaf, dtype

    def __getitem__(self, i: int):
        return self.row.weight(self.leaf, i, self.dtype)


class _W:
    """A parameter leaf (layer ``index`` of a stacked one) that a step
    computes where it lies: cut by ``'model'`` along ``dim``, its model
    blocks each on its own coordinate (:meth:`_Row.model_block`); ``dim``
    None, the leaf whole at the row (gathered over the data axes).  The
    blocks are fetched once, where an operation first takes them."""

    def __init__(self, row: _Row, leaf: _Leaf, index, dtype):
        self.row, self.leaf, self.index, self.dtype = row, leaf, index, dtype
        self.dim = leaf.dim
        self._blocks = None

    def blocks(self) -> List[Tuple[Tuple[int, ...], torch.Tensor]]:
        if self._blocks is None:
            row = self.row
            if self.dim is None:
                self._blocks = [(row.coord, row.gather(
                    self.leaf, self.index, self.dtype))]
            else:
                self._blocks = [
                    (row.at(m), row.model_block(self.leaf, self.index, m,
                                                self.dtype))
                    for m in range(row.mesh.shape["model"])]
        return self._blocks

    def stack_block(self, coord) -> torch.Tensor:
        """The stacked block ``coord`` holds (the serving cache's key of a
        layer's conv weights)."""
        return self.leaf.sh.shards[tuple(coord)]


class _Cut:
    """A per-token tensor (or a weight's blocks, ``kind`` ``weights``) of
    extent n along ``axis``, held as pieces on mesh coordinates.
    :meth:`take` gives its extent lo..hi on a coordinate: the piece that
    lies there as it is, else the slices of the pieces it covers, sent
    there (once each)."""

    def __init__(self, row: _Row, pieces: List[_Blk], axis: int = -1,
                 kind: str = "activations"):
        self.row, self.pieces, self.axis, self.kind = row, pieces, axis, kind
        self.n = pieces[-1].hi
        self._sent: Dict[tuple, torch.Tensor] = {}

    @classmethod
    def at_row(cls, row: _Row, t: torch.Tensor, axis: int = -1) -> "_Cut":
        return cls(row, [_Blk(0, t.shape[axis], row.coord, t)], axis)

    def take(self, lo: int, hi: int, coord) -> torch.Tensor:
        key = (lo, hi, tuple(coord))
        if key not in self._sent:
            parts = []
            for p in self.pieces:
                a, b = max(lo, p.lo), min(hi, p.hi)
                if a < b:
                    t = p.t if (a, b) == (p.lo, p.hi) \
                        else p.t.narrow(self.axis, a - p.lo, b - a)
                    parts.append(self.row.send(t, p.coord, coord, self.kind))
            self._sent[key] = parts[0] if len(parts) == 1 \
                else torch.cat(parts, dim=self.axis)
        return self._sent[key]

    def spread(self, coords) -> List[torch.Tensor]:
        """The whole tensor on each of ``coords``: a single piece under
        autograd through one :class:`_Tee` (:meth:`_Row.fan`)."""
        if len(self.pieces) == 1 and self.pieces[0].t.requires_grad \
                and torch.is_grad_enabled():
            p = self.pieces[0]
            return self.row.fan(p.t, coords, src=p.coord)
        return [self.take(0, self.n, c) for c in coords]

    def whole(self) -> torch.Tensor:
        """Joined at the row."""
        return self.take(0, self.n, self.row.coord)


def _head_runs(lo: int, hi: int, width: int):
    """The flat columns lo..hi of a (heads, width) layout as runs (h0, h1,
    e0, e1, c0): heads h0..h1, columns e0..e1 of each, from column c0 of
    the block; whole heads run together, a head cut by an edge alone."""
    runs, j = [], lo
    while j < hi:
        h, e = divmod(j, width)
        if e == 0 and hi - j >= width:
            n = (hi - j) // width
            runs.append((h, h + n, 0, width, j - lo))
            j += n * width
        else:
            e1 = min(width, e + hi - j)
            runs.append((h, h + 1, e, e1, j - lo))
            j += e1 - e
    return runs


def _run_cols(t: torch.Tensor, run) -> torch.Tensor:
    """A run's columns of a block (r, cols) as (r, heads, e1 - e0)."""
    h0, h1, e0, e1, c0 = run
    n = (h1 - h0) * (e1 - e0)
    return t[:, c0:c0 + n].reshape(t.shape[0], h1 - h0, e1 - e0)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


def _same_cut(*cuts: List[_Blk]) -> bool:
    first = [(b.lo, b.hi, b.coord) for b in cuts[0]]
    return all([(b.lo, b.hi, b.coord) for b in c] == first for c in cuts)


def _expert_rows(x, route, w_gate, w_up, w_down, e0: int, n_e: int,
                 E: int, C: int) -> torch.Tensor:
    """The sorted dispatch's rows (``route``: expert, token, kept, slot)
    through experts e0..e0 + n_e of one block (``models.moe``'s grouped
    products, on the block's whole experts or its ``f`` slice of them):
    (T * k, d), zero at the rows of other experts."""
    se, st, keep, slot = route[0], route[1], route[2].bool(), route[3]
    mine = (se >= e0) & (se < e0 + n_e)
    local = torch.where(mine, se - e0, n_e)
    # the others' rows and the dropped ones land in a spare expert or
    # slot, cut off after
    grouped = torch.zeros((n_e + 1, C + 1, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    grouped[local, torch.where(keep & mine, slot, C)] = x[st]
    grouped = grouped[:n_e, :C]
    h = F.silu(torch.bmm(grouped, w_gate)) * torch.bmm(grouped, w_up)
    y = torch.bmm(h, w_down)
    rows = y[torch.where(mine, local, 0), slot]
    if n_e == E:
        return rows
    return torch.where(mine[:, None], rows, torch.zeros((), dtype=y.dtype,
                                                        device=y.device))


# --------------------------------------------------------------------------
# the block arithmetic
# --------------------------------------------------------------------------
class Split:
    """Products by weight block, each on its block's coordinate, for one
    row (the module's docstring)."""

    def __init__(self, row: _Row):
        self.row = row

    def _cols(self, w, x, fn=_mm, dim: int = 1, axis: int = -1) -> _Cut:
        """``fn(x, block)`` for each block of ``w`` along ``dim`` (its
        output columns) on the block's coordinate: the output's pieces.
        ``x`` is a :class:`_Cut`, or its tensors on the blocks'
        coordinates, one a block."""
        blocks = self.row.blocks(w, dim)
        xs = x.spread([b.coord for b in blocks]) if isinstance(x, _Cut) \
            else x
        return _Cut(self.row, [_Blk(b.lo, b.hi, b.coord, fn(xb, b.t))
                               for b, xb in zip(blocks, xs)], axis)

    def _rows(self, w, x: _Cut, fn=_mm, dim: int = 0,
              limit: Optional[int] = None) -> torch.Tensor:
        """``fn(x's slice, block)`` for each block of ``w`` along ``dim``
        (its input rows, up to ``limit`` of them) on the block's
        coordinate; the partial sums added at the row in ascending block
        order."""
        row, out = self.row, None
        for b in row.blocks(w, dim):
            hi = b.hi if limit is None else min(b.hi, limit)
            if hi <= b.lo:
                continue
            t = b.t if hi == b.hi else b.t.narrow(dim, 0, hi - b.lo)
            part = row.send(fn(x.take(b.lo, hi, b.coord), t), b.coord,
                            row.coord)
            out = part if out is None else out + part
        return out

    def _whole(self, w) -> torch.Tensor:
        """A leaf ``'model'`` does not cut, at the row."""
        blocks = self.row.blocks(w, w.dim if isinstance(w, _W)
                                 and w.dim is not None else 0)
        if len(blocks) != 1:
            raise ValueError("a leaf cut over 'model' where the step takes "
                             "it whole")
        b = blocks[0]
        return self.row.send(b.t, b.coord, self.row.coord, "weights")

    def _heads(self, w, x: _Cut) -> torch.Tensor:
        """x @ w (d, n, hd) by w's head blocks, joined at the row:
        (B, S, n, hd)."""
        return self._cols(w, x, attn._heads, dim=1, axis=2).whole()

    def _heads_out(self, wo, cfg, o) -> torch.Tensor:
        """``attention.attention_output``: o through wo (Hq_pad, hd, d) by
        its head blocks (padded heads take none).  ``o`` is (B, Hkv, g,
        hd) at the row (a decode step's), or a :class:`_Cut` of (B, S, n,
        hd) pieces along the heads."""
        if isinstance(o, torch.Tensor):
            o = _Cut.at_row(self.row, o.reshape(o.shape[0], 1, -1,
                                                cfg.head_dim), axis=2)
        lead = tuple(o.pieces[0].t.shape[:2])
        return self._rows(
            wo, o, lambda a, t: a.reshape(*lead, -1)
            @ t.reshape(-1, t.shape[-1]), limit=o.n)

    # ---- the embedding and the head ---------------------------------------
    def embed(self, w, tok: torch.Tensor) -> torch.Tensor:
        """tok (B, S) at the row -> (B, S, d): each vocab block looks up
        the tokens in its range, zeros elsewhere; the row sums them."""
        row, out = self.row, None
        blocks = row.blocks(w, 0)
        for b in blocks:
            local = row.to(tok, b.coord) - b.lo
            e = b.t[local.clamp(0, b.hi - b.lo - 1)]
            if len(blocks) > 1:
                inside = (local >= 0) & (local < b.hi - b.lo)
                e = torch.where(inside[..., None], e, torch.zeros(
                    (), dtype=e.dtype, device=e.device))
            part = row.send(e, b.coord, row.coord)
            out = part if out is None else out + part
        return out

    def logit_blocks(self, tree, cfg, x: torch.Tensor) -> List[_Blk]:
        """``transformer.lm_logits`` by the head's vocab blocks, each
        left on its coordinate: the pieces along the vocab."""
        row = self.row
        if cfg.tie_embeddings:
            blocks = row.blocks(tree["embed"], 0)
            fn = lambda a, t: a @ t.T.to(a.dtype)              # noqa: E731
        else:
            blocks = row.blocks(tree["lm_head"], 1)
            fn = lambda a, t: a @ t.to(a.dtype)                # noqa: E731
        xs = _Cut.at_row(row, x).spread([b.coord for b in blocks])
        return [_Blk(b.lo, b.hi, b.coord, fn(xb, b.t).float())
                for b, xb in zip(blocks, xs)]

    def logits(self, tree, cfg, x: torch.Tensor) -> torch.Tensor:
        """:meth:`logit_blocks` joined at the row."""
        return _Cut(self.row, self.logit_blocks(tree, cfg, x)).whole()

    # ---- FFNs ---------------------------------------------------------
    def ffn(self, p, h):
        """``layers.swiglu``: the hidden columns on ``w_gate``'s and
        ``w_up``'s blocks, through ``w_down``'s row blocks."""
        row = self.row
        gate, up = row.blocks(p["w_gate"], 1), row.blocks(p["w_up"], 1)
        if not _same_cut(gate, up):
            raise ValueError("w_gate and w_up are cut apart over 'model'")
        xs = _Cut.at_row(row, h).spread([g.coord for g in gate])
        hidden = [_Blk(g.lo, g.hi, g.coord, F.silu(xb @ g.t) * (xb @ u.t))
                  for g, u, xb in zip(gate, up, xs)]
        return self._rows(p["w_down"], _Cut(row, hidden))

    def _moe(self, p, cfg, h, capacity_factor: float,
             aux: Optional[str] = None):
        """``moe.moe_block`` at ``capacity_factor``: the row routes; each
        block runs its experts (expert parallel) or its ``f`` slice of
        every expert (tensor parallel) on the dispatch's rows; the row
        adds the rows' partials in block order and combines them.  Returns
        (out, the aux loss, or with ``aux`` "stats" the (2, E) router
        statistics, or None)."""
        row = self.row
        B, S, d = h.shape
        E, k = cfg.n_experts, cfg.n_experts_active
        T = B * S
        xt = h.reshape(T, d)
        ds = act_sharding.data_shards()
        ds = ds if T % ds == 0 else 1
        Tl = T // ds
        C = max(int(Tl * k / E * capacity_factor), 1)
        tp = getattr(p["w_gate"], "dim", None) == 2
        dims = (2, 2, 1) if tp else (0, 0, 0)
        gate, up, down = (row.blocks(p[n], dm) for n, dm in
                          zip(("w_gate", "w_up", "w_down"), dims))
        if not _same_cut(gate, up, down):
            raise ValueError("the experts' leaves are cut apart over "
                             "'model'")
        routers = row.fan(self._whole(p["router"]), [row.coord] * ds)
        outs, all_probs, top1 = [], [], []
        for s in range(ds):
            xs = row.fan(xt[s * Tl:(s + 1) * Tl],
                         [row.coord] + [g.coord for g in gate])
            probs = torch.softmax((xs[0] @ routers[s]).float(), dim=-1)
            gate_vals, expert_ids = moe._top_k(probs, k)
            gate_vals = gate_vals / torch.sum(gate_vals, dim=-1,
                                              keepdim=True)
            idx = moe.dispatch(expert_ids, gate_vals, E, k, C)
            route = torch.stack([idx[0], idx[1], idx[3].long(), idx[4]])
            rows = None
            for g, u, w, xg in zip(gate, up, down, xs[1:]):
                e0, n_e = (0, E) if tp else (g.lo, g.hi - g.lo)
                part = _expert_rows(xg, row.to(route, g.coord), g.t, u.t,
                                    w.t, e0, n_e, E, C)
                part = row.send(part, g.coord, row.coord)
                rows = part if rows is None else rows + part
            outs.append(moe.combine_rows(rows, idx, Tl, k, d, xt.dtype))
            if aux is not None:
                all_probs.append(probs)
                top1.append(expert_ids[:, 0])
        out = outs[0] if ds == 1 else torch.cat(outs)
        value = None
        if aux is not None:
            # the load-balancing aux loss over all T tokens, as moe_block
            probs = all_probs[0] if ds == 1 else torch.cat(all_probs)
            first = top1[0] if ds == 1 else torch.cat(top1)
            density = torch.mean(F.one_hot(first, E).float(), dim=0)
            mean_prob = torch.mean(probs, dim=0)
            value = torch.stack([density, mean_prob]) if aux == "stats" \
                else E * torch.sum(density * mean_prob)
        if cfg.n_shared_experts:
            out = out + self.ffn(p["shared"], xt)
        return out.reshape(B, S, d), value


# --------------------------------------------------------------------------
# the training forward's operations
# --------------------------------------------------------------------------
class Forward(Split, tfm.ForwardOps):
    """``transformer.ForwardOps`` over a placed tree, for one row: the
    forward of the sharded train step (under autograd) and of the sharded
    prefill (the module's docstring)."""

    def _plain(self, p):
        """``p``'s tensors where each of its leaves is one block at the
        row, else None."""
        if self.row.mesh.shape["model"] > 1 and any(
                isinstance(w, _W) and w.dim is not None
                for w in tree_util.leaves(p)):
            return None
        return tree_util.tree_map(
            lambda w: self._whole(w) if isinstance(w, _W) else w, p)

    def _units(self, spans, n_heads: int):
        """Runs (h0, h1, coordinate) of consecutive heads with one home:
        the coordinate whose block holds a head's columns whole in each of
        ``spans`` ((pieces, columns a head) pairs), else the row."""
        homes = []
        for h in range(n_heads):
            found = set()
            for pieces, width in spans:
                lo, hi = h * width, (h + 1) * width
                b = next(b for b in pieces if b.lo <= lo < b.hi)
                found.add(tuple(b.coord) if hi <= b.hi else self.row.coord)
            homes.append(found.pop() if len(found) == 1 else self.row.coord)
        runs = []
        for h, c in enumerate(homes):
            if runs and runs[-1][2] == c:
                runs[-1][1] = h + 1
            else:
                runs.append([h, h + 1, c])
        return [tuple(r) for r in runs]

    # ---- the embedding, the head, the MTP projection -----------------------
    def embed(self, w, tokens):
        plain = self._plain(w)
        if plain is not None:
            return plain[tokens]
        return Split.embed(self, w, tokens)

    def logit_blocks(self, params, cfg, hidden):
        w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        plain = self._plain(w)
        if plain is not None:
            t = tfm.lm_logits({"embed": plain, "lm_head": plain}, cfg,
                              hidden)
            return [_Blk(0, t.shape[-1], self.row.coord, t)]
        with full_fp32_matmul():
            return Split.logit_blocks(self, params, cfg, hidden)

    def proj(self, w, x):
        plain = self._plain(w)
        if plain is not None:
            return x @ plain
        return self._cols(w, _Cut.at_row(self.row, x)).whole()

    def _devices(self) -> int:
        """The distinct devices the row's blocks lie on."""
        return len({self.row.mesh.home(c) for c in self.row.line})

    def checkpoint(self, fn):
        """A layer's remat: where the row's blocks lie on several devices,
        so that several of autograd's threads unpack the layer,
        ``transformer.checkpoint_threadsafe``; else the plain
        ``ForwardOps.checkpoint`` under the remat policy."""
        if self._devices() == 1:
            return tfm.ForwardOps.checkpoint(fn)
        tfm.remat_policy()
        return lambda *args: tfm.checkpoint_threadsafe(fn, *args)

    def share(self, t, n: int):
        if self.row.mesh.shape["model"] == 1:
            # one device's thread runs the row's backward
            return [t] * n
        return self.row.fan(t, [self.row.coord] * n)

    # ---- FFNs -------------------------------------------------------------
    def ffn(self, p, h):
        plain = self._plain(p)
        if plain is not None:
            return layers.swiglu(h, **plain)
        return Split.ffn(self, p, h)

    def moe(self, p, cfg, h, router_stats: bool = False):
        plain = self._plain(p)
        if plain is not None:
            return tfm.ForwardOps.moe(plain, cfg, h, router_stats)
        return self._moe(p, cfg, h, 1.25, "stats" if router_stats
                         else "loss")

    # ---- attention --------------------------------------------------------
    def _attend(self, p, cfg, q: _Cut, k, v, finish, causal: bool,
                window: int) -> torch.Tensor:
        """Flash attention by head: ``q`` (B, S, Hq_pad, hd) as pieces on
        ``wq``'s head blocks, ``k`` and ``v`` (B, Sk, Hkv, hd) at the row.
        Each run of heads with one home (:meth:`_units`) is finished
        there (``finish(q, heads, coordinate)``), attends over its heads'
        K/V copies and goes through ``wo``'s head rows."""
        row = self.row
        units = self._units([(q.pieces, 1), (row.blocks(p["wo"], 0), 1)],
                            q.n)
        kx, vx = attn.expand_kv_padded(k, cfg), attn.expand_kv_padded(v, cfg)
        pieces = []
        for (h0, h1, c), fin in zip(units, finish(units)):
            qu = fin(q.take(h0, h1, c))
            o = attn.flash_attention(
                qu[:, :, :, None, :],
                row.send(kx[:, :, h0:h1], row.coord, c),
                row.send(vx[:, :, h0:h1], row.coord, c),
                causal=causal, window=window)
            pieces.append(_Blk(h0, h1, c, o.reshape(*o.shape[:3], -1)))
        return self._heads_out(p["wo"], cfg, _Cut(row, pieces, axis=2))

    def _q_finish(self, p, cfg, positions, bias: bool):
        """Each unit's query finisher: its bias, norm and RoPE on its own
        coordinate, from the coordinate's own copies of ``bq`` and
        ``q_norm`` (which every coordinate holds whole)."""
        row = self.row

        def make(units):
            homes = [c for _, _, c in units]
            bqs = row.replicas(p["bq"], homes) \
                if bias and cfg.qkv_bias else [None] * len(units)
            norms = row.replicas(p["q_norm"], homes) \
                if cfg.qk_norm else [None] * len(units)
            out = []
            for (h0, h1, c), bq, qn in zip(units, bqs, norms):
                pos = None if positions is None \
                    else row.at_positions(positions, c)
                out.append(lambda q, h0=h0, h1=h1, bq=bq, qn=qn, pos=pos:
                           attn.finish_heads(
                               cfg, q, None if bq is None else bq[h0:h1],
                               qn, pos, rope=pos is not None))
            return out
        return make

    def attention(self, p, cfg, h, positions, causal: bool = True):
        plain = self._plain(p)
        if plain is not None:
            return attn.attention_block(plain, cfg, h, positions, causal)
        row = self.row
        qb = row.blocks(p["wq"], 1)
        hs = row.fan(h, [row.coord, row.coord] + [b.coord for b in qb])
        k = attn.finish_heads(cfg, attn._heads(hs[0], self._whole(p["wk"])),
                              p.get("bk"), p.get("k_norm"), positions)
        v = attn._heads(hs[1], self._whole(p["wv"]))
        if cfg.qkv_bias:
            v = v + p["bv"]
        q = self._cols(p["wq"], hs[2:], attn._heads, dim=1, axis=2)
        return self._attend(p, cfg, q, k, v,
                            self._q_finish(p, cfg, positions, True), causal,
                            cfg.sliding_window if causal else 0)

    def cross(self, p, cfg, h, memory, gated: bool = False):
        plain = self._plain(p)
        if plain is not None:
            return attn.cross_attention_block(plain, cfg, h, memory, gated)
        row = self.row
        q = self._cols(p["wq"], _Cut.at_row(row, h), attn._heads, dim=1,
                       axis=2)
        k = attn._heads(memory, self._whole(p["wk"]))
        v = attn._heads(memory, self._whole(p["wv"]))
        if cfg.qk_norm:
            k = layers.rmsnorm(k, p["k_norm"], cfg.norm_eps)
        out = self._attend(p, cfg, q, k, v,
                           self._q_finish(p, cfg, None, False), False, 0)
        return torch.tanh(p["gate"]) * out if gated else out

    def mla(self, p, cfg, h, positions):
        plain = self._plain(p)
        if plain is not None:
            return mla.mla_block(plain, cfg, h, positions)
        row = self.row
        B, S, _ = h.shape
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        qa, kva = row.blocks(p["wq_a"], 1), row.blocks(p["wkv_a"], 1)
        hs = row.fan(h, [b.coord for b in qa] + [b.coord for b in kva])
        q_lat = layers.rmsnorm(self._cols(p["wq_a"], hs[:len(qa)]).whole(),
                               p["q_a_norm"], cfg.norm_eps)
        c_kv, k_rope = mla.kv_latent(
            p, cfg, self._cols(p["wkv_a"], hs[len(qa):]).whole(), positions)
        Q = self._cols(p["wq_b"], _Cut.at_row(row, q_lat))
        KV = self._cols(p["wkv_b"], _Cut.at_row(row, c_kv))
        units = self._units([(Q.pieces, dn + dr), (KV.pieces, dn + dv)],
                            cfg.n_heads)
        ropes = row.fan(k_rope, [c for _, _, c in units])
        pieces = []
        for (h0, h1, c), kr in zip(units, ropes):
            n = h1 - h0
            q_nope, q_rope = mla.q_heads(
                cfg, Q.take(h0 * (dn + dr), h1 * (dn + dr), c),
                row.at_positions(positions, c))
            kv = KV.take(h0 * (dn + dv), h1 * (dn + dv), c).reshape(
                B, S, n, dn + dv)
            k = torch.cat([kv[..., :dn],
                           kr[:, :, None, :].expand(B, S, n, dr)], dim=-1)
            o = attn.flash_attention(
                torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :], k,
                kv[..., dn:], causal=True)
            pieces.append(_Blk(h0 * dv, h1 * dv, c, o.reshape(B, S, n * dv)))
        return self._rows(p["wo"], _Cut(row, pieces))

    # ---- SSM --------------------------------------------------------------
    def conv_key(self, path, i: int, stacked):
        """The layer's name; the conv's blocks key their own weights."""
        return (tuple(path), i)

    def _conv_key(self, conv_key, w, j: int, coord):
        if conv_key is None or self.row.recording or not isinstance(w, _W):
            return None
        path, i = conv_key
        return ssm.conv_cache_key(path + (j,), i, w.stack_block(coord))

    def mamba(self, p, cfg, h, conv_key=None):
        """``ssm.mamba2_block``: ``in_proj``'s columns joined at the row,
        the conv by ``conv_w``'s channel blocks (each with its own copy of
        ``conv_b``), the scan, gate and norm at the row, ``out_proj``'s
        row blocks."""
        row = self.row
        plain = self._plain(p)
        if plain is not None:
            return ssm.mamba2_block(plain, cfg, h, self._conv_key(
                conv_key, p["conv_w"], 0, row.coord))
        z, xbc, dt = ssm.split_in_proj(
            cfg, self._cols(p["in_proj"], _Cut.at_row(row, h)).whole())
        blocks = row.blocks(p["conv_w"], 1)
        biases = row.replicas(p["conv_b"], [b.coord for b in blocks])
        outs = []
        for j, (b, bias) in enumerate(zip(blocks, biases)):
            y = ssm._causal_conv1d(
                row.send(xbc[..., b.lo:b.hi], row.coord, b.coord), b.t,
                bias[b.lo:b.hi], cfg.use_sfc_conv,
                self._conv_key(conv_key, p["conv_w"], j, b.coord))
            outs.append(row.send(y, b.coord, row.coord))
        xbc = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        y = ssm.ssd_gated(p, cfg, z, xbc, dt)
        return self._rows(p["out_proj"], _Cut.at_row(row, y))
