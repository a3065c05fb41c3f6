"""Pipeline parallelism over a mesh axis (GPipe schedule), single
controller.

The counterpart of the JAX package's ``distributed/pipeline.py``: a
homogeneous layer stack maps onto ``n_stages`` groups along a mesh axis
(the 'pod' axis of a multi-pod mesh), and ``pipeline_apply`` runs the
GPipe fill/drain schedule,

    tick t: stage s processes microbatch (t - s) if 0 <= t - s < M

Activations enter at stage 0 and leave at stage S-1.  The JAX package
runs it under ``shard_map`` with ``ppermute`` hops between neighbouring
stages; here one process drives every stage: stage ``s``'s parameters go
to the device of its coordinate on the axis (the other axes at 0), each
tick runs the active stages in turn (their launches queue on their own
devices), and an activation moves to the next stage's device with
``.to``.  The output lands on ``x``'s device, and autograd runs through
the schedule, the gradients of each stage's parameters arriving on the
caller's tensors.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tree_util


def stack_params_for_stages(params_stacked, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L/S, ...)."""
    def reshape(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return tree_util.tree_map(reshape, params_stacked)


def _stage_device(mesh, axis: str, s: int) -> torch.device:
    coord = tuple(s if name == axis else 0 for name in mesh.axis_names)
    return mesh.device(coord)


def pipeline_apply(stage_fn: Callable, params_staged, x: torch.Tensor,
                   n_micro: int, mesh, axis: str = "stage") -> torch.Tensor:
    """Run x (B, ...) through S pipeline stages with M microbatches.

    ``stage_fn(stage_params, x_micro) -> x_micro`` is one stage's layers;
    ``params_staged`` leaves have leading dim S (the axis's size)."""
    S = mesh.shape[axis]
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    x_micro = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    devices = [_stage_device(mesh, axis, s) for s in range(S)]
    params = [tree_util.tree_map(lambda a, s=s: a[s].to(devices[s]),
                                 params_staged) for s in range(S)]
    outs = [None] * n_micro
    buf = [None] * S                  # what each stage received last tick
    for t in range(n_micro + S - 1):
        nxt = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            inp = x_micro[m].to(devices[0]) if s == 0 else buf[s]
            out = stage_fn(params[s], inp)
            if s == S - 1:
                outs[m] = out.to(x.device)
            else:
                nxt[s + 1] = out.to(devices[s + 1])
        buf = nxt
    y = torch.stack(outs)
    return y.reshape((B,) + tuple(y.shape[2:]))
