"""Cost analysis of one call of a step, per mesh coordinate: the
counterpart of the JAX package's loop-aware HLO analysis.

The port has no compiler and no HLO: this module analyses the aten
operations that one call of a step dispatches (a ``TorchDispatchMode``),
on meta tensors over a mesh of meta devices (``launch.mesh.
make_production_mesh(device="meta")``) or on real ones, and keeps every
figure per mesh coordinate (``distributed/coords.py`` says how an
operation learns its coordinate):

  * ``flops``: ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution`` and
    the attention operations, by ``torch.utils.flop_counter``'s formulas;
  * ``traffic_bytes``: operand plus result bytes of every operation that
    makes a new storage or writes one in place.  Eager mode materialises
    each operation, so this is the eager step's HBM traffic; views,
    ``detach`` and ``empty`` are free, as ``_FREE`` is in the JAX
    analysis, and a broadcast dimension counts once.  A copy between
    coordinates reads at its source and writes at its destination;
  * ``param_bytes``: the bytes of the step's arguments (the placed
    blocks) at the coordinate;
  * ``collective_bytes``/``collective_counts``: the bytes (and copies) a
    coordinate receives from others, by the kinds of
    ``model_split.copied`` (weights, activations, cache, gradients,
    outputs), and
    ``link_bytes``: its larger direction, sent or received, by the link
    crossed (``nvlink`` for a copy that crosses only ``'model'``,
    ``network`` otherwise);
  * the live bytes: a storage counts from the operation that makes it
    until it is freed (``weakref.finalize`` on the storage); ``peak`` is
    their most at any moment, beside the arguments.

The summary gives the max over coordinates of each figure and, beside it
(``mean``), the mean.  The JAX analysis's ``loop_trips`` and
``normalize_cost_analysis`` have no counterpart: a Python loop runs every
trip, and there is no XLA ``cost_analysis`` to normalise.

With ``rows_alike=True`` the sharded steps run one data row of each class
of rows alike (``coords.rows``) and the analysis replays its record for
the others, each coordinate shifted along ``'data'`` unless it is fixed:
the whole run's figures, row for row (``tests/test_torch_dryrun.py``
holds the two equal).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as tree_util
from repro_torch.distributed import coords as coords_lib

KINDS = ("weights", "activations", "cache", "gradients", "outputs")
LINKS = ("nvlink", "network")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh"}


class _Coord:
    """One coordinate's figures."""

    __slots__ = ("flops", "traffic", "args", "live", "peak", "recv",
                 "counts", "sent_link", "recv_link")

    def __init__(self):
        self.flops = 0.0
        self.traffic = 0.0
        self.args = 0
        self.live = 0
        self.peak = 0
        self.recv = {k: 0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}
        self.sent_link = {k: 0 for k in LINKS}
        self.recv_link = {k: 0 for k in LINKS}


@dataclasses.dataclass
class CostSummary:
    """Per-device figures of one call: each the max over the mesh's
    coordinates, the mean beside it in ``mean``; ``per_coord`` holds them
    all and ``copied`` the bytes moved between coordinates over the whole
    mesh by kind (``model_split.copied``'s count)."""
    flops: float = 0.0
    traffic_bytes: float = 0.0
    param_bytes: float = 0.0
    peak_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in KINDS})
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in KINDS})
    link_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in LINKS})
    dot_flops_by_site: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    mean: Dict[str, Any] = dataclasses.field(default_factory=dict)
    copied: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in KINDS})
    per_coord: Dict[Tuple[int, ...], _Coord] = dataclasses.field(
        default_factory=dict, repr=False)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an operation reads or writes of ``t``: a broadcast
    dimension (stride 0) holds one element however long it is."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class _Moved(torch.autograd.Function):
    """A copy to another coordinate: forward at ``dst``, its gradient
    copied back to the source's coordinate, as ``.to`` between two
    devices does."""

    @staticmethod
    def forward(ctx, t, tracker, device, dst):
        ctx.tracker, ctx.device, ctx.src = tracker, t.device, \
            tracker.tag_of(t)
        return tracker.copy(t, device, dst)

    @staticmethod
    def backward(ctx, g):
        return ctx.tracker.copy(g, ctx.device, ctx.src), None, None, None


class _Tracker(TorchDispatchMode):
    """The analysis while a call runs: see the module's docstring."""

    def __init__(self, mesh, keep_sites: bool, rows_alike: bool):
        super().__init__()
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names) if mesh is not None else ()
        self.origin = (0,) * len(self.axes)
        self.keep_sites, self.rows_alike = keep_sites, rows_alike
        self.per: Dict[Tuple[int, ...], _Coord] = {}
        self.sites: Dict[str, float] = {}
        self.copied_total = {k: 0 for k in KINDS}
        self.tags: Dict[int, Tuple[Tuple[int, ...], bool]] = {}
        self.loose: set = set()
        self.sizes: Dict[int, int] = {}
        self.finalizers: List[weakref.finalize] = []
        self.local = threading.local()
        self.lock = threading.RLock()
        # the replay of rows alike
        self.plan: Dict[int, List[int]] = {}
        self.row_coords: List[Tuple[int, ...]] = []
        self.log: Optional[list] = None
        self.log_row: Optional[int] = None
        self.rep_allocs: Dict[int, Tuple[int, int]] = {}
        self.replicas: Dict[Tuple[int, int], Tuple[Tuple[int, ...], int]] \
            = {}
        self.standing: Dict[int, Tuple[int, int]] = {}
        self.next_sid = 0
        self.data_axis = self.axes.index("data") if "data" in self.axes \
            else None

    # ---- coordinates ------------------------------------------------------
    def coord(self, c) -> _Coord:
        st = self.per.get(c)
        if st is None:
            st = self.per[c] = _Coord()
        return st

    def current(self):
        stack = getattr(self.local, "at", None)
        return stack[-1] if stack else (self.origin, True)

    def placed(self) -> bool:
        """Whether a coordinate is in force (an :meth:`at` scope)."""
        return bool(getattr(self.local, "at", None))

    @contextlib.contextmanager
    def at(self, coord, fixed: bool):
        stack = getattr(self.local, "at", None)
        if stack is None:
            stack = self.local.at = []
        stack.append((coord, fixed))
        try:
            yield
        finally:
            stack.pop()

    def tag_of(self, t):
        k = _key(t)
        tag = self.tags.get(k) if k is not None else None
        return tag if tag is not None else self.current()

    def tag_args(self, leaves) -> None:
        """The call's arguments: each placed block at its coordinate, a
        plain tensor at the mesh's first coordinate."""
        for leaf in leaves:
            if hasattr(leaf, "shards"):
                for c in leaf.mesh.coords():
                    t = leaf.shards[c]
                    self.coord(tuple(c)).args += _nbytes(t)
                    k = _key(t)
                    if k is not None and k not in self.tags:
                        self.tags[k] = (tuple(c), False)
            elif isinstance(leaf, torch.Tensor):
                self.coord(self.origin).args += _nbytes(leaf)
                k = _key(leaf)
                if k is not None and k not in self.tags:
                    self.tags[k] = (self.origin, True)

    # ---- storages ---------------------------------------------------------
    def _alloc(self, t, tag, loose: bool = False) -> None:
        k = _key(t)
        if k is None or k in self.tags:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        with self.lock:
            self.tags[k] = tag
            if loose:
                self.loose.add(k)
            self.sizes[k] = n
            c = self.coord(tag[0])
            c.live += n
            c.peak = max(c.peak, c.live)
            if self.log is not None:
                sid = self.next_sid
                self.next_sid += 1
                self.rep_allocs[k] = (self.log_row, sid)
                self.log.append(("alloc", sid, tag, n))
        self.finalizers.append(weakref.finalize(st, self._freed, k))

    def _freed(self, k: int) -> None:
        with self.lock:
            tag, n = self.tags.pop(k, None), self.sizes.pop(k, 0)
            self.loose.discard(k)
            if tag is None:
                return
            self.coord(tag[0]).live -= n
            rep = self.rep_allocs.pop(k, None)
            if rep is None:
                return
            s, sid = rep
            if self.log is not None and self.log_row == s:
                self.log.append(("free", sid))
                return
            # freed outside its row's parts: its replays with it, but
            # for those a stand-in still holds
            for r in self.plan.get(s, ()):
                if (sid, r) not in self.standing.values():
                    self._drop(sid, r)

    def stand_in(self, t, r: int):
        """For row ``r``, replayed, the tensor ``t`` that its
        representative made: a copy standing for ``r``'s own, at its
        coordinate, that holds ``r``'s replayed storage until it dies."""
        k = _key(t)
        rep = self.rep_allocs.get(k)
        if rep is None or (rep[1], r) not in self.replicas:
            return t
        self.local.quiet = True
        try:
            out = t.clone()
        finally:
            self.local.quiet = False
        ko = _key(out)
        with self.lock:
            self.tags[ko] = (self.replicas[(rep[1], r)][0], self.tags[k][1])
            self.standing[ko] = (rep[1], r)
        self.finalizers.append(weakref.finalize(
            out.untyped_storage(), self._stand_freed, ko))
        return out

    def _stand_freed(self, ko: int) -> None:
        with self.lock:
            self.tags.pop(ko, None)
            got = self.standing.pop(ko, None)
            if got is not None:
                self._drop(*got)

    def _drop(self, sid: int, r: int) -> None:
        got = self.replicas.pop((sid, r), None)
        if got is not None:
            self.coord(got[0]).live -= got[1]

    # ---- figures ------------------------------------------------------------
    def _op(self, tag, flops: float, traffic: float) -> None:
        c = self.coord(tag[0])
        c.flops += flops
        c.traffic += traffic
        if self.log is not None and (flops or traffic):
            self.log.append(("op", tag, flops, traffic))

    def _link(self, src, dst) -> str:
        if self.mesh is None:
            return "network"
        diff = [a for a, x, y in zip(self.axes, src, dst) if x != y]
        return "nvlink" if diff == ["model"] else "network"

    def copied(self, kind, n, src, dst, src_fixed, dst_fixed) -> None:
        with self.lock:
            self._copied(kind, n, (src, src_fixed), (dst, dst_fixed))
            if self.log is not None:
                self.log.append(("copy", kind, n, (src, src_fixed),
                                 (dst, dst_fixed)))

    def _copied(self, kind, n, src, dst) -> None:
        link = self._link(src[0], dst[0])
        self.coord(src[0]).sent_link[link] += n
        d = self.coord(dst[0])
        d.recv_link[link] += n
        d.recv[kind] += n
        d.counts[kind] += 1
        self.copied_total[kind] += n

    # ---- copies between coordinates ----------------------------------------
    def move(self, t, device, dst, fixed: bool):
        return _Moved.apply(t, self, device, (dst, fixed))

    def copy(self, t, device, tag):
        src = self.tag_of(t)
        self.local.quiet = True
        try:
            out = t.to(device, copy=True)
        finally:
            self.local.quiet = False
        self._alloc(out, tag)
        n = _nbytes(t)
        self._op(src, 0.0, n)
        self._op(tag, 0.0, n)
        return out

    # ---- rows alike ---------------------------------------------------------
    def rows(self, mesh, coords) -> List[bool]:
        """Run the first row of each class; the others replay it.  A class
        is the rows of one coordinate of the batch axes other than
        'data' (a pod), the mesh's first coordinate a class alone."""
        self.row_coords = coords
        self.plan = {}
        if not self.rows_alike or self.data_axis is None or len(coords) < 3:
            return [True] * len(coords)
        runs, rep, key = [], None, None
        for s, c in enumerate(coords):
            k = tuple(x for i, x in enumerate(c) if i != self.data_axis)
            if c == self.origin:
                rep = None
            elif rep is not None and k == key:
                self.plan[rep].append(s)
                runs.append(False)
                continue
            else:
                rep, key = s, k
                self.plan[s] = []
            runs.append(True)
        return runs

    @contextlib.contextmanager
    def segment(self, s: int):
        coord = self.row_coords[s] if self.row_coords else self.origin
        alike = self.plan.get(s)
        with self.at(coord, False):
            if not alike:
                yield
                return
            with self.lock:
                self.log, self.log_row = [], s
            try:
                yield
            finally:
                with self.lock:
                    log, self.log, self.log_row = self.log, None, None
                for r in alike:
                    self._replay(log, s, r)

    def _shift(self, tag, k: int):
        c, fixed = tag
        if fixed or k == 0:
            return c
        n = self.mesh.shape["data"]
        c = list(c)
        c[self.data_axis] = (c[self.data_axis] + k) % n
        return tuple(c)

    def _replay(self, log, s: int, r: int) -> None:
        k = self.row_coords[r][self.data_axis] \
            - self.row_coords[s][self.data_axis]
        with self.lock:
            for ev in log:
                if ev[0] == "op":
                    c = self.coord(self._shift(ev[1], k))
                    c.flops += ev[2]
                    c.traffic += ev[3]
                elif ev[0] == "alloc":
                    where = self._shift(ev[2], k)
                    c = self.coord(where)
                    c.live += ev[3]
                    c.peak = max(c.peak, c.live)
                    self.replicas[(ev[1], r)] = (where, ev[3])
                elif ev[0] == "free":
                    self._drop(ev[1], r)
                elif ev[0] == "copy":
                    self._copied(ev[1], ev[2],
                                 (self._shift(ev[3], k), ev[3][1]),
                                 (self._shift(ev[4], k), ev[4][1]))
                elif ev[0] == "site":
                    self.sites[ev[1]] = self.sites.get(ev[1], 0.0) + ev[2]

    # ---- the operations ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(self.local, "quiet", False):
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        tag, seen = None, set()
        for t in ins:
            k = _key(t)
            seen.add(k)
            if tag is None and k is not None and k not in self.loose:
                tag = self.tags.get(k)
        loose = tag is None and not self.placed()
        if tag is None:
            tag = self.current()
        for t in outs:
            if _key(t) not in seen:
                self._alloc(t, tag, loose)
        packet = func.overloadpacket
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            if self.keep_sites and flops:
                self._site(flops)
        name = packet.__name__
        traffic = 0.0
        if not func.is_view and name not in _NO_TRAFFIC:
            traffic = float(sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs))
        self._op(tag, flops, traffic)
        return out

    def _site(self, flops: float) -> None:
        f = sys._getframe(2)
        key = "?"
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod.startswith("repro_torch.") and not mod.startswith(
                    ("repro_torch.launch.hlo_analysis",
                     "repro_torch.distributed.coords")):
                key = f"{mod}.{f.f_code.co_name}"
                break
            f = f.f_back
        self.sites[key] = self.sites.get(key, 0.0) + flops
        if self.log is not None:
            self.log.append(("site", key, flops))

    # ---- the summary -------------------------------------------------------
    def summary(self) -> CostSummary:
        out = CostSummary()
        coords = self.mesh.coords() if self.mesh is not None \
            else [self.origin]
        per = {tuple(c): self.coord(tuple(c)) for c in coords}
        for c, st in self.per.items():
            per.setdefault(c, st)
        sts = list(per.values())
        n = len(sts)

        def both(name, values):
            values = list(values)
            setattr(out, name, max(values))
            out.mean[name] = sum(values) / n
        both("flops", (s.flops for s in sts))
        both("traffic_bytes", (s.traffic for s in sts))
        both("param_bytes", (s.args for s in sts))
        both("peak_bytes", (s.args + s.peak for s in sts))
        for k in KINDS:
            out.collective_bytes[k] = max(s.recv[k] for s in sts)
            out.collective_counts[k] = max(s.counts[k] for s in sts)
        out.mean["collective_bytes"] = {
            k: sum(s.recv[k] for s in sts) / n for k in KINDS}
        for k in LINKS:
            out.link_bytes[k] = max(max(s.sent_link[k], s.recv_link[k])
                                    for s in sts)
        out.mean["link_bytes"] = {
            k: sum(max(s.sent_link[k], s.recv_link[k]) for s in sts) / n
            for k in LINKS}
        out.dot_flops_by_site = dict(self.sites)
        out.copied = dict(self.copied_total)
        out.per_coord = per
        return out

    def close(self) -> None:
        for f in self.finalizers:
            f.detach()


def analyze(fn, *args, mesh=None, keep_sites: bool = False,
            rows_alike: bool = False, **kwargs):
    """``(fn(*args, **kwargs), CostSummary)`` of one call (the module's
    docstring).  ``mesh``: the mesh the arguments are placed on, whose
    coordinates the figures are kept by (None: one device); the live
    bytes of what the call returns stay in the peak."""
    if coords_lib.TRACKER is not None:
        raise RuntimeError("an analysis is already running")
    tracker = _Tracker(mesh, keep_sites, rows_alike)
    tracker.tag_args(tree_util.leaves((args, kwargs)))
    # storages die when their last reference goes, as the card's caching
    # allocator frees them: not whenever the collector runs
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    coords_lib.TRACKER = tracker
    try:
        with tracker:
            result = fn(*args, **kwargs)
    finally:
        coords_lib.TRACKER = None
        if collecting:
            gc.enable()
        tracker.close()
    return result, tracker.summary()
