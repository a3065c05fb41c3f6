"""Where a tensor lies on a mesh: the hooks the dry run's cost analysis
(``launch/hlo_analysis.py``) reads.

A mesh of meta devices (``launch.mesh.make_production_mesh(device=
"meta")``) holds no data, and a meta tensor carries no device index, so
the analysis learns each operation's mesh coordinate from the sharded
steps themselves:

  * a new storage takes the coordinate of the first input storage that
    has one (autograd's saved tensors carry it into the backward);
  * a storage with no tensor input (a factory operation) takes the
    coordinate of the innermost :func:`at` (a row's, while the row runs);
    made outside every :func:`at`, and from such storages only, it is
    loose: a table a step builds on its first call and caches (the
    transform matrices, the rotary tables) counts at the mesh's first
    coordinate but places no operation that reads it, so a cold call is
    attributed as a warm one;
  * a copy between coordinates (:func:`move`, from the copy sites of
    ``model_split``, ``lm_spmd``, ``serve_spmd`` and the sharded CNN step)
    makes a new storage at its destination, and :func:`copied` reports
    the bytes with both ends, so the analysis splits them by the link
    they cross;
  * a step's argument placed on the mesh (the state, a serving step's
    inputs over the batch axes) counts each block on the coordinate that
    holds it, a plain tensor (the train batch) at the mesh's first
    coordinate; so does what a step returns, where it lies.

``fixed`` marks a coordinate that does not move with the data row
running (the mesh's first coordinate, which holds a plain argument, the
one gradient block of a leaf the data axes do not cut): the analysis may
run one row of a class of rows alike and replay its record for the
others (:func:`rows`, :func:`segment`), each coordinate shifted along
``'data'`` unless fixed.

With no analysis running every hook is a ``None`` check and a plain
``.to``.
"""
from __future__ import annotations

import contextlib

TRACKER = None        # the running analysis (launch.hlo_analysis._Tracker)


def move(t, mesh, dst, fixed: bool = False):
    """``t`` on coordinate ``dst``'s device (``t.to(device)``); under the
    analysis a new storage at ``dst`` even where the device is the same
    (a mesh of meta devices)."""
    device = mesh.device(dst)
    if TRACKER is None:
        return t.to(device)
    return TRACKER.move(t, device, tuple(dst), fixed)


def copied(kind: str, nbytes: int, src, dst, src_fixed: bool = False,
           dst_fixed: bool = False) -> None:
    """``nbytes`` of ``kind`` copied from coordinate ``src`` to ``dst``
    (the analysis's record of ``model_split._count``)."""
    if TRACKER is not None:
        TRACKER.copied(kind, nbytes, tuple(src), tuple(dst), src_fixed,
                       dst_fixed)


def at(coord, fixed: bool = False):
    """Factory operations inside make their storage at ``coord``."""
    if TRACKER is None:
        return contextlib.nullcontext()
    return TRACKER.at(tuple(coord), fixed)


def rows(mesh, coords):
    """Which of the data rows at ``coords`` (their first coordinates, in
    order) the step runs: all, unless the analysis replays rows alike."""
    if TRACKER is None:
        return [True] * len(coords)
    return TRACKER.rows(mesh, [tuple(c) for c in coords])


def stand_in(tree, s: int):
    """For row ``s``, which the analysis replays, the run row's outputs
    ``tree`` standing for its own (unchanged when no analysis runs)."""
    if TRACKER is None:
        return tree
    from repro_torch import tree as tree_util
    return tree_util.tree_map(
        lambda t: TRACKER.stand_in(t, s)
        if hasattr(t, "untyped_storage") else t, tree)


def segment(s: int):
    """A part of row ``s``'s work in a step (its forward, its backward),
    at the row's coordinate: the analysis records it to replay for the
    rows alike."""
    if TRACKER is None:
        return contextlib.nullcontext()
    return TRACKER.segment(s)
