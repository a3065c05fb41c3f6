"""Activation sharding rules: the data shards the MoE dispatch groups in.

The counterpart of the JAX package's ``distributed/act_sharding.py``.
There, ``constrain`` and ``constrain_batch`` pin an activation's layout
for GSPMD and ``data_shards`` tells the MoE dispatch how many data shards
the token dimension is cut into, so that its grouping stays on a shard.
In the port's single controller each shard's compute already runs on its
own slice of the batch (``distributed/lm_spmd.py``), so the constraints
place nothing and return their input; ``data_shards`` is what matters.

The rules are process-wide and optional: with none installed (unit
tests, single-device runs) ``data_shards`` is 1.  The sharded train step
sets the count its shards' compute sees (:func:`local`) for the whole of
its forward and backward: a rematerialised layer runs its forward again
in the backward, on autograd's device threads, and must group the tokens
as the forward did.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

_RULES: Optional[Tuple[object, Tuple[str, ...]]] = None
_LOCAL: Optional[int] = None


def install(mesh, batch_axes: Tuple[str, ...]) -> None:
    global _RULES
    _RULES = (mesh, tuple(batch_axes))


def clear() -> None:
    global _RULES
    _RULES = None


def constrain(x, spec):
    """No layout to pin: a shard's compute holds its own slice."""
    return x


def constrain_batch(x, batch_dim: int = 0):
    """No layout to pin: a shard's compute holds its own slice."""
    return x


def data_shards() -> int:
    """Number of data-parallel shards (1 when no rules are installed):
    the MoE dispatch cuts its tokens into this many chunks and groups
    each alone.  Inside :func:`local`, the count it sets."""
    if _LOCAL is not None:
        return _LOCAL
    if _RULES is None:
        return 1
    mesh, baxes = _RULES
    return math.prod(mesh.shape[a] for a in baxes)


@contextlib.contextmanager
def local(n: int):
    """``data_shards()`` is ``n`` inside the block: 1 where a shard's
    compute holds its own slice of the batch, the data axes' size where
    the batch did not divide and one compute holds it whole."""
    global _LOCAL
    was, _LOCAL = _LOCAL, int(n)
    try:
        yield
    finally:
        _LOCAL = was
