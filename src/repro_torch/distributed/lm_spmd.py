"""The sharded LM train step: what GSPMD does for the JAX package's
``make_train_step`` over a (data, model) mesh, in one process.

The JAX package places an LM's training state by ``params_pspecs``
(FSDP over ``'data'``, TP/EP over ``'model'``) and runs the same jitted
step on it; XLA computes each weight block where it lies, inserts the
data axes' all-gather at each use and the reduce-scatter in the
backward.  The port has no compiler to do that, so this module does it
by hand, in the single-controller design of the sharded conv backend
(``conv_spmd``): one process holds every block as a
:class:`~repro_torch.distributed.sharding.Sharded` on its mesh
coordinate's device, and a mesh may repeat one device, so one card runs
any mesh shape.

  * **State.** Parameters and the AdamW moments are ``Sharded`` by the
    sanitized ``param_pspec`` (the moments through ``opt_state_pspecs``);
    the step counter and the seed are replicated
    (:func:`state_shardings`).  A fresh state is drawn by ``init_lm`` from
    the generator the unsharded init uses, in its order, each stack layer
    by layer and each other entry as it is drawn, and placed at once
    (:func:`init_train_state`): its values are the unsharded init's, and
    the peak beside the blocks is one drawn layer or the largest other
    entry (a stack keeps its first layer's structure, not its tensors).
  * **Compute where the weights lie.** Each coordinate of the batch axes
    (a data row) runs ``transformer.loss_terms`` on its slice of the
    batch with ``model_split.Forward``'s operations: each weight block
    computes on its own coordinate (r, m), which fetches only its own
    model block over the data axes; leaves ``'model'`` does not cut run
    at the row's first coordinate; only per-token tensors move between
    coordinates, and partial sums are added at the row in ascending
    block order.  A batch the data axes do not divide is computed whole
    by the first row, its MoE dispatch still in ``data_shards()`` chunks,
    as ``sanitize_pspec`` and the JAX package's ``moe_block`` have it.
  * **Fetch at use, reduce-scatter in the backward.** A stacked leaf's
    layer ``i`` is fetched where the model takes it
    (``transformer.layer``), inside the layer's checkpointed function,
    so the recomputation fetches again and the forward keeps no fetched
    copy; the other leaves are fetched once a step.  The fetch is an
    autograd ``Function`` whose backward cuts the gradient by the blocks
    it was joined from and adds each into that block's float32 gradient
    block on the block's device.  Rows run their backward one after
    another in ascending order, and a tensor several coordinates take
    sums its gradients in a fixed order (``model_split._Tee``), so the
    sums come in one order, with no atomics, and a step replays bit for
    bit.
  * **Cross-shard terms.** The loss is the mean of the equal-size shards'
    per-token losses (cross entropy and deepseek's MTP term).  The MoE
    aux loss ``E * sum(density * mean_prob)`` is over *all* tokens: each
    shard returns its layers' density and mean probability
    (``router_stats``), the means over shards are taken before the
    product, and each shard's backward takes ``E * D * m_s / n`` with the
    global density ``D`` (the density carries no gradient).
  * **Microbatches** (``make_train_step(..., microbatches=mb)``), as the
    JAX step has them: chunk i is rows [i B / mb, (i + 1) B / mb) of the
    global batch, split over the data rows (the first row computes a
    chunk the data axes do not divide); the gradient blocks are summed in
    float32 in chunk order, then divided by mb; the loss is the mean of
    the chunks' losses, the MoE aux loss over each chunk's tokens.
  * **int8 gradient compression** (``grad_compression=True``): each
    leaf's gradient blocks after the reduction, scaled by the leaf's
    global ``max |g| / 127 + 1e-12`` (the max over its blocks), rounded
    with noise keyed by each element's flat index in the whole leaf
    (``optim.grad_compression.int8_roundtrip``), so the result depends on
    neither the mesh nor the order the blocks are visited in: the
    unsharded step's compressed gradients.
  * **AdamW on blocks.** ``AdamW.apply`` runs over the unique blocks: the
    global norm counts each block once, and each block's update, an
    elementwise function of its own leaf's block, is computed on that
    block's device and copied to its replicas on other devices.

On a mesh of one coordinate the loss and gradients are the single-device
step's bit for bit (``tests/test_torch_lm_spmd.py``); elsewhere the row
blocks' partial sums and the sums over data shards come in another
order.  ``model_split.copied`` counts the bytes a step moves between
coordinates: its weights are the all-gather over the data
axes of the leaves it reads, once a fetch (twice for a rematerialised
layer's), 0 on a mesh of one data row.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.precision import full_fp32_backward
from repro_torch.distributed import act_sharding, coords as coords_lib
from repro_torch.distributed.model_split import (Forward, _Leaf, _Row,
                                                 param_leaves)
from repro_torch.distributed.sharding import (
    P, Sharded, _with_paths, batch_axes, block_of, opt_state_pspecs,
    params_pspecs, sanitized_shardings, tree_map_with_path)
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of
from repro_torch.optim import grad_compression as gc
from repro_torch.optim.optimizers import AdamWState


def is_sharded(state) -> bool:
    """The state's parameters are placed on a mesh."""
    first = tree_util.leaves(state.params)
    return bool(first) and isinstance(first[0], Sharded)


def state_shardings(model, optimizer, mesh):
    """The ``TrainState`` of ``NamedSharding``s the JAX package gives
    ``jax.device_put``: the parameters by ``params_pspecs``, the moments
    by ``opt_state_pspecs``, the seed replicated, each sanitized against
    its leaf's shape."""
    from repro_torch.train.steps import TrainState, abstract_train_state
    abstract = abstract_train_state(model, optimizer)
    pspecs = params_pspecs(abstract.params, model.cfg, mesh)
    specs = TrainState(params=pspecs,
                       opt=opt_state_pspecs(abstract.opt, pspecs), rng=P())
    return sanitized_shardings(specs, abstract, mesh)


# --------------------------------------------------------------------------
# a fresh sharded state
# --------------------------------------------------------------------------
class _Placer:
    """``init_lm``'s placer: each entry onto the mesh as it is drawn."""

    def __init__(self, shardings):
        self.by_path = dict(_with_paths(shardings))

    def put(self, key, tree):
        def one(path, leaf):
            s = self.by_path[(key,) + path]
            return Sharded.place(leaf, s.spec, s.mesh, own=True)
        return tree_map_with_path(one, tree)

    def stack(self, key, n):
        return _StackSink(self, key, n)


class _StackSink:
    """One stack's blocks, written layer by layer; of the drawn layers it
    keeps only the first one's structure (meta tensors), so no drawn
    layer outlives its placement (22.5 GB for a bf16 deepseek-v3 MoE
    layer)."""

    def __init__(self, placer: _Placer, key: str, n: int):
        self.placer, self.key, self.n = placer, key, n
        self.like = None
        self.leaves: Dict[Tuple[str, ...], Dict[str, Any]] = {}

    def add(self, i: int, layer) -> None:
        if self.like is None:
            self.like = tree_util.tree_map(
                lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"),
                layer)
        for path, a in _with_paths(layer):
            s = self.placer.by_path[(self.key,) + path]
            entry = self.leaves.get(path)
            if entry is None:
                entry = self.leaves[path] = _empty_stack(
                    s, (self.n,) + tuple(a.shape), a.dtype)
            core = P(*tuple(s.spec)[1:])
            for (index, _), block in entry["blocks"].items():
                block[i].copy_(block_of(a, core, s.mesh, index[1:]))

    def done(self):
        out = {path: e["sharded"] for path, e in self.leaves.items()}
        return tree_map_with_path(lambda path, _: out[path], self.like)


def _empty_stack(s, shape, dtype) -> Dict[str, Any]:
    """Empty blocks of a (n, ...) leaf cut by ``s``: one per block and
    device, shared by the coordinates of that device."""
    mesh = s.mesh
    probe = torch.empty(shape, dtype=dtype, device="meta")
    spec = s.spec
    blocks: Dict[Any, torch.Tensor] = {}
    shards = np.empty(mesh.devices.shape, dtype=object)
    sh = Sharded(mesh, spec, tuple(shape), shards)
    for coord in mesh.coords():
        index, home = sh.block_index(coord), mesh.home(coord)
        if (index, home) not in blocks:
            blocks[(index, home)] = torch.empty(
                block_of(probe, spec, mesh, index).shape, dtype=dtype,
                device=mesh.device(coord))
        shards[coord] = blocks[(index, home)]
    return {"blocks": blocks, "sharded": sh}


def _zeros_like(sh: Sharded, dtype) -> Sharded:
    """Zeros of ``sh``'s shape and spec in ``dtype``, one block a device."""
    made: Dict[Any, torch.Tensor] = {}
    shards = np.empty(sh.mesh.devices.shape, dtype=object)
    for coord in sh.mesh.coords():
        key = (sh.block_index(coord), sh.mesh.home(coord))
        if key not in made:
            made[key] = torch.zeros(sh.shards[coord].shape, dtype=dtype,
                                    device=sh.mesh.device(coord))
        shards[coord] = made[key]
    return Sharded(sh.mesh, sh.spec, sh.shape, shards)


def init_train_state(model, optimizer, seed: int, shardings, device):
    """A fresh ``TrainState`` placed by ``shardings``
    (:func:`state_shardings`): the parameters ``Model.init`` draws from a
    generator on ``device`` seeded with ``seed``, each placed as it is
    drawn; float32 zero moments; the step and the seed replicated."""
    from repro_torch.train.steps import TrainState
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tfm.init_lm(gen, model.cfg, placer=_Placer(shardings.params))
    zeros = lambda sh: _zeros_like(sh, torch.float32)        # noqa: E731
    step = shardings.opt.step
    opt = AdamWState(
        step=Sharded.place(torch.zeros((), dtype=torch.int32), step.spec,
                           step.mesh, own=True),
        mu=tree_util.tree_map(zeros, params),
        nu=tree_util.tree_map(zeros, params))
    rng = Sharded.place(torch.tensor(seed, dtype=torch.int64),
                        shardings.rng.spec, shardings.rng.mesh, own=True)
    return TrainState(params=params, opt=opt, rng=rng)


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
def _compute_coords(mesh, n_rows: int) -> List[Tuple[int, ...]]:
    """The first coordinate of each data row, in ascending order."""
    baxes = batch_axes(mesh)
    sizes = [mesh.shape[a] for a in baxes]
    out = []
    for d in range(n_rows):
        where = dict(zip(baxes, np.unravel_index(d, sizes)))
        out.append(tuple(int(where.get(a, 0)) for a in mesh.axis_names))
    return out


def _batch_slice(batch, s: int, n: int, mesh, coord
                 ) -> Dict[str, torch.Tensor]:
    def cut(v):
        b = v.shape[0] // n
        return coords_lib.move(v[s * b:(s + 1) * b], mesh, coord)
    return {k: cut(v) for k, v in batch.items()}


def _chunk(model, leaves, mesh, batch):
    """One chunk of the batch through each row's forward and backward
    (the module's docstring): its loss and metrics; the gradients added
    into ``leaves``."""
    cfg = model.cfg
    n_data = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    B = next(iter(batch.values())).shape[0]
    split = B % n_data == 0
    n = n_data if split else 1
    cdtype = dtype_of(cfg.compute_dtype)
    moe = cfg.family == "moe"
    mains, auxes, metrics = [], [], []
    coords = _compute_coords(mesh, n)
    # a row the dry run replays stands in the last run row's outputs
    runs = coords_lib.rows(mesh, coords)
    origin = (0,) * len(mesh.axis_names)

    def to0(t):
        return coords_lib.move(t, mesh, origin, fixed=True)
    with act_sharding.local(1 if split else n_data):
        for s, coord in enumerate(coords):
            if not runs[s]:
                main, aux, m = coords_lib.stand_in(ran, s)
                mains.append(main)
                auxes.append(aux)
                metrics.append(m)
                continue
            with coords_lib.segment(s):
                device = mesh.device(coord)
                row = _Row(mesh, coord, s, anchor=torch.empty(
                    0, device=device, requires_grad=True))
                main, aux, m = ran = tfm.loss_terms(
                    row.weights(leaves, cdtype, tuple(leaves)), cfg,
                    _batch_slice(batch, s, n, mesh, coord),
                    router_stats=moe, ops=Forward(row))
            mains.append(main)
            auxes.append(aux)
            metrics.append(m)
        dev0 = mains[0].device
        if moe:
            # the aux loss over all tokens: the shards' means before the
            # product, layer by layer as the single-device sum adds them
            D = torch.stack([to0(a[:, 0].detach()) for a in auxes]).mean(0)
            M = torch.stack([to0(a[:, 1].detach()) for a in auxes]).mean(0)
            E = cfg.n_experts
            aux = torch.zeros((), dtype=torch.float32, device=dev0) \
                + torch.sum(torch.stack([E * torch.sum(D[i] * M[i])
                                         for i in range(D.shape[0])]))
        else:
            aux = auxes[0].detach()
        coef = cfg.router_aux_coef
        for s, main in enumerate(mains):
            if not runs[s]:
                continue
            with coords_lib.segment(s):
                term = main / n
                if moe:
                    m_s = auxes[s][:, 1]
                    D_s = coords_lib.move(D, mesh, coords[s])
                    term = term + coef * torch.sum(torch.stack(
                        [E * torch.sum(D_s[i] * m_s[i])
                         for i in range(D_s.shape[0])])) / n
                with full_fp32_backward():
                    torch.autograd.backward(term)
    with torch.no_grad():
        loss = torch.mean(torch.stack([to0(m.detach()) for m in mains])) \
            + coef * aux
        out = {"loss": loss, "aux": aux,
               "ce": torch.mean(torch.stack([to0(m["ce"].detach())
                                             for m in metrics]))}
        if "mtp" in metrics[0]:
            out["mtp"] = torch.mean(torch.stack(
                [to0(m["mtp"].detach()) for m in metrics]))
    return loss, out


def value_and_grad(model, params, batch, microbatches: int = 1):
    """(loss, metrics, {path: _Leaf with its gradient blocks}) of the
    model's loss at the placed ``params`` over ``batch`` (global tensors,
    or ``Sharded`` ones), computed per data row where each weight block
    lies (the module's docstring); with ``microbatches`` the batch's
    chunks one after another, their gradients summed in float32 and
    divided by their count, and the loss their losses' mean."""
    leaves = param_leaves(params)
    mesh = tree_util.leaves(params)[0].mesh
    batch = {k: v.gather() if isinstance(v, Sharded) else v
             for k, v in batch.items()}
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"{microbatches} microbatches do not divide a "
                         f"batch of {B}")
    if microbatches == 1:
        loss, metrics = _chunk(model, leaves, mesh, batch)
        return loss, metrics, leaves
    b = B // microbatches
    flat = tree_util.leaves(leaves)
    sums = [{} for _ in flat]
    loss_sum = None
    for i in range(microbatches):
        loss, _ = _chunk(model, leaves, mesh,
                         {k: v[i * b:(i + 1) * b] for k, v in batch.items()})
        with torch.no_grad():
            for leaf, acc in zip(flat, sums):
                for idx in leaf.unique:
                    g = leaf.grad(idx)
                    acc[idx] = (acc[idx] if idx in acc
                                else torch.zeros_like(g)) + g
                leaf.grads = {}
        loss_sum = loss if loss_sum is None else loss_sum + loss
    for leaf, acc in zip(flat, sums):
        leaf.grads = {idx: g / microbatches for idx, g in acc.items()}
    loss = loss_sum / microbatches
    return loss, {"loss": loss}, leaves


@torch.no_grad()
def compress(leaves) -> None:
    """The int8 round trip of each leaf's gradient blocks, in place
    (``grad_compression.int8_roundtrip``): the leaf's global scale, the
    max over its blocks, and noise keyed by each element's flat index in
    the whole leaf, a stacked block a layer at a time; the blocks in the
    parameters' dtype, as the unsharded step casts them."""
    for leaf in tree_util.leaves(leaves):
        blocks = {idx: leaf.grad(idx) for idx in leaf.unique}
        mesh, c0 = leaf.sh.mesh, next(iter(leaf.unique.values()))[0]
        scale = torch.stack([
            coords_lib.move(g.abs().max(), mesh, c0, leaf.fixed)
            for g in blocks.values()]).max() / 127.0 + 1e-12
        leaf.grads = {
            idx: gc.int8_roundtrip(
                g, coords_lib.move(scale, mesh, leaf.unique[idx][0]),
                tuple(i * n for i, n in zip(idx, g.shape)),
                leaf.sh.shape).to(leaf.sh.dtype)
            for idx, g in blocks.items()}


def _blocks_of(sh: Sharded, unique) -> List[torch.Tensor]:
    return [sh.shards[coords[0]] for coords in unique.values()]


def _replaced(like: Sharded, unique, new: List[torch.Tensor]) -> Sharded:
    """``like``'s layout with its unique blocks replaced by ``new``, copied
    to the coordinates of other devices (one copy a device)."""
    mesh = like.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    for (idx, coords), t in zip(unique.items(), new):
        on = {mesh.home(coords[0]): t}
        for c in coords:
            home = mesh.home(c)
            if home not in on:
                on[home] = coords_lib.move(t, mesh, c)
            shards[c] = on[home]
    return Sharded(like.mesh, like.spec, like.shape, shards)


def gradients(leaves):
    """The gradient blocks of :func:`value_and_grad`'s leaves, as a tree of
    ``Sharded`` laid out as the parameters."""
    return tree_util.tree_map(
        lambda leaf: _replaced(leaf.sh, leaf.unique,
                              [leaf.grad(idx) for idx in leaf.unique]),
        leaves)


def train_step(model, optimizer, state, batch, microbatches: int = 1,
               grad_compression: bool = False):
    """One sharded step: ``make_train_step``'s over a placed state, with
    its microbatches and its int8 gradient compression.  Returns the new
    placed state and the metrics."""
    _, metrics, leaves = value_and_grad(model, state.params, batch,
                                        microbatches)
    if grad_compression:
        compress(leaves)
    return apply_gradients(optimizer, state, leaves, metrics)


def apply_gradients(optimizer, state, leaves, metrics):
    """``optimizer.apply`` over the unique blocks of :func:`value_and_grad`'s
    ``leaves``: the new placed state, and ``metrics`` with the
    optimizer's."""
    from repro_torch.train.steps import TrainState
    flat = tree_util.leaves(leaves)
    mu, nu = tree_util.leaves(state.opt.mu), tree_util.leaves(state.opt.nu)
    p_b, g_b, m_b, v_b = [], [], [], []
    for leaf, m, v in zip(flat, mu, nu):
        p_b += _blocks_of(leaf.sh, leaf.unique)
        g_b += [leaf.grad(idx) for idx in leaf.unique]
        m_b += _blocks_of(m, leaf.unique)
        v_b += _blocks_of(v, leaf.unique)
    step_sh = state.opt.step
    new_p, new_opt, opt_metrics = optimizer.apply(
        p_b, g_b, AdamWState(step_sh.shards.flat[0], m_b, v_b))
    del g_b
    out_p, out_m, out_v, at = [], [], [], 0
    for leaf, m, v in zip(flat, mu, nu):
        k = len(leaf.unique)
        out_p.append(_replaced(leaf.sh, leaf.unique, new_p[at:at + k]))
        out_m.append(_replaced(m, leaf.unique, new_opt.mu[at:at + k]))
        out_v.append(_replaced(v, leaf.unique, new_opt.nu[at:at + k]))
        at += k
    step = _replaced(step_sh, step_sh.unique(), [new_opt.step])
    metrics = dict(metrics)
    metrics.update(opt_metrics)
    return TrainState(
        tree_util.unflatten(state.params, out_p),
        AdamWState(step, tree_util.unflatten(state.opt.mu, out_m),
                   tree_util.unflatten(state.opt.nu, out_v)),
        state.rng), metrics
