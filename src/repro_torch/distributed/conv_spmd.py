"""Sharded conv backend: the ``cuda`` datapath over a device mesh.

``cuda_spmd`` scales the single-device ``cuda`` datapath across a
:class:`~repro_torch.launch.mesh.Mesh` without touching any call site: it
is a ``repro_torch.api`` backend like the others, registered at the
registry seam (``api/backends.py``) and resolved by name from
``plan(spec, backend="cuda_spmd")``.  It is the counterpart of the JAX
package's ``pallas_spmd``.

Sharding layout:

  * batch over ``('pod', 'data')`` — SFC tiling is *halo-free across
    images*: every (L, L) input tile lives entirely inside one image, so
    splitting the batch ships whole images and needs no neighbour
    exchange;
  * C_out over ``'model'`` — transform-domain output channels are
    independent: each shard holds its own (t^2, C_in, C_out/m) int8
    weight block plus the matching per-frequency dequant scales, and the
    kernels run unchanged on the local block.

Both axes compose, and neither needs a cross-shard reduction: the C_in
contraction stays whole in every shard, so no collective runs and the
int8 datapaths give the single-device bits (B2 accumulates exactly in
int32, B4's and B7's epilogues are per (position, channel)).

Single controller: like ``shard_map``, ``plan(spec,
backend="cuda_spmd").apply(x, ...)`` takes the global ``x``.  One process
cuts it per mesh coordinate, runs ``get_backend("cuda").apply`` on each
shard under ``torch.cuda.device`` of the shard's device, and joins the
outputs on ``x``'s device with ``torch.cat``.  ``torch.distributed.tensor``
would need one process per device, and NCCL refuses two ranks on one
GPU, so a one-card host could not run a sharded layout at all; a mesh
that repeats one device (``launch.mesh.make_forced_host_mesh(...,
device="cuda:0")``) runs every shard there.  Every mesh coordinate runs
its shard, replicas included, as every device of a ``shard_map`` does.
Copies between devices are blocking ``.to`` calls on the default streams.

Kernel configs ride the plan unchanged: a ``KernelConfig`` resolves its
geometry per shard against the *local* extents (a shard's C_out may be
smaller than the config's ``cout_block``: B4 pads the block as it pads a
ragged C_out on one device).

Axes that do not divide the corresponding extent are dropped per
:func:`repro_torch.distributed.sharding.sanitize_pspec` — batch 1 on a
multi-way data axis, a ragged C_out — and that dimension is computed
replicated instead: graceful degradation, never an error.

Lowered (composite) plans need nothing special here: the lowering pass
hands every polyphase/grouped sub-problem to ``plan(...,
backend="cuda_spmd")``, so each sub-plan is its own sharded apply with its
own ``place_prepared`` placement.  2-D depthwise specs shard their single
channel axis over 'model' on input and weights alike.  Rank-1 plans go to
the ``cuda`` backend whole.

:meth:`CudaSpmdBackend.place_prepared` is the offline half:
``ConvPlan.prepare_weights`` routes prepared tensors through it, so
``wq``/``w_scale`` (and fp ``tw``) land on the mesh C_out-sharded once,
ahead of traffic, instead of being cut at every apply.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import (P, Sharded, batch_axes,
                                              sanitize_pspec)
from repro_torch.launch.mesh import Mesh

# NOTE: repro_torch.api imports are late (inside methods) —
# repro_torch.api.backends imports this module to register the backend.


def _device_scope(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _shape(a) -> tuple:
    return tuple(a.shape)


def _as_sharded(a, spec, mesh: Mesh) -> Sharded:
    """``a`` cut by ``spec`` over ``mesh``: a placed operand of this mesh
    and layout as it is, anything else (a tensor, or a placement for
    another mesh) placed anew."""
    if isinstance(a, Sharded):
        if a.mesh is mesh and a.spec == spec:
            return a
        a = a.gather()
    return Sharded.place(a, spec, mesh)


class CudaSpmdBackend:
    """The ``cuda`` datapath per shard; one mesh per backend object.

    The default mesh is whatever the host exposes
    (``launch.mesh.make_host_mesh``: all GPUs on 'data', 'model' = 1);
    callers install an explicit mesh with :meth:`set_mesh`.
    """

    name = "cuda_spmd"
    # the same int8 x int8 -> int32 datapath as the cuda backend: the
    # planner's overflow pre-flight applies (each shard accumulates its
    # full C_in contraction)
    integer_datapath = True

    def __init__(self, mesh: Optional[Mesh] = None):
        self._mesh = mesh

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            from repro_torch.launch.mesh import make_host_mesh
            self._mesh = make_host_mesh()
        return self._mesh

    def set_mesh(self, mesh: Optional[Mesh]) -> None:
        """Install an execution mesh (None re-resolves the host default).

        Invalidates memoized plans: their prepared-weight caches hold
        placements for the previous mesh.
        """
        self._mesh = mesh
        from repro_torch.api import planner
        planner.invalidate_plan_cache()

    # ------------------------------------------------------------------
    # offline: prepared-weight placement (ConvPlan.prepare_weights hook)
    # ------------------------------------------------------------------
    def place_prepared(self, plan, prep):
        """Shard prepared weights: C_out over 'model', the activation
        scales replicated, each block on its shard's device.  Extents the
        axis does not divide degrade to replication.

        Grouped specs stay as they are: slicing C_out across shards would
        misalign the group <-> input-block correspondence (grouped specs
        normally lower into per-group dense sub-plans, each of which
        shards its own C_out/g).  Depthwise shards its single channel
        axis: ``apply`` co-shards the input channels.  Rank-1 specs stay
        as they are.
        """
        if plan.spec.rank != 2 or plan.spec.groups > 1:
            return prep
        mesh = self.mesh

        def put(a, spec):
            return None if a is None else _as_sharded(
                a, sanitize_pspec(spec, _shape(a), mesh), mesh)

        return dataclasses.replace(
            prep,
            tw=put(prep.tw, P(None, None, None, "model")),
            wq=put(prep.wq, P(None, None, "model")),
            w_scale=put(prep.w_scale, P(None, None, "model")),
            act_scale=put(prep.act_scale, P(None, None)))

    # ------------------------------------------------------------------
    # online: execution
    # ------------------------------------------------------------------
    def apply(self, plan, x, prep, *, bias=None, elementwise_hook=None):
        if elementwise_hook is not None:
            raise ValueError(
                "the cuda_spmd backend takes no elementwise_hook; bake "
                "quantization into the plan (spec.quant + calibrated "
                "prepare_weights) or use backend='reference'")
        from repro_torch.api.backends import get_backend
        from repro_torch.api.plan import PreparedWeights
        inner = get_backend("cuda")
        if plan.spec.rank != 2:
            # rank-1 depthwise: the inner backend, whole
            return inner.apply(plan, x, prep, bias=bias)
        mesh = self.mesh
        b_ax = batch_axes(mesh)

        # depthwise: in == out channels, so the channel axis shards over
        # 'model' on BOTH the input and the weights.  Grouped direct stays
        # replicated on C_out: a shard slice would misalign the groups.
        dw = plan.spec.depthwise
        c_ax = "model" if dw else None
        o_ax = None if plan.spec.groups > 1 else "model"

        operands = {"x": x}
        specs = {"x": P(b_ax, None, None, c_ax)}
        if prep.quantized:
            operands.update(wq=prep.wq, w_scale=prep.w_scale,
                            act_scale=prep.act_scale)
            specs.update(wq=P(None, None, o_ax),
                         w_scale=P(None, None, o_ax),
                         act_scale=P(None, None))
            w_key = "wq"
        elif plan.algorithm is not None:
            operands["tw"] = prep.tw
            specs["tw"] = P(None, None, None, o_ax)
            w_key = "tw"
        else:
            # direct path: HWIO weights; output channels stay independent
            operands["w"] = prep.w
            specs["w"] = P(None, None, None, o_ax)
            w_key = "w"
        if bias is not None:
            operands["bias"] = torch.as_tensor(bias, device=x.device)
            specs["bias"] = P(o_ax)
        specs = {k: sanitize_pspec(s, _shape(operands[k]), mesh)
                 for k, s in specs.items()}
        placed = {k: _as_sharded(a, specs[k], mesh)
                  for k, a in operands.items()}
        out_spec = P(specs["x"][0], None, None, specs[w_key][-1])

        outs = np.empty(mesh.devices.shape, dtype=object)
        for coord in mesh.coords():
            local = {k: s.shard(coord) for k, s in placed.items()}
            lp = PreparedWeights(w=local.get("w"), tw=local.get("tw"),
                                 wq=local.get("wq"),
                                 w_scale=local.get("w_scale"),
                                 act_scale=local.get("act_scale"))
            with _device_scope(mesh.device(coord)):
                outs[coord] = inner.apply(plan, local["x"], lp,
                                          bias=local.get("bias"))
        return Sharded.from_shards(mesh, out_spec, outs).gather(x.device)
