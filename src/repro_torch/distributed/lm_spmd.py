"""The sharded LM train step: what GSPMD does for the JAX package's
``make_train_step`` over a (data, model) mesh, in one process.

The JAX package places an LM's training state by ``params_pspecs``
(FSDP over ``'data'``, TP/EP over ``'model'``) and runs the same jitted
step on it; XLA inserts the all-gather at each use and the
reduce-scatter in the backward.  The port has no compiler to do that, so
this module does it by hand, in the single-controller design of the
sharded conv backend (``conv_spmd``): one process holds every block as a
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
    the peak beside the blocks is one layer or the largest other entry.
  * **Data-parallel compute.** Each coordinate of the batch axes runs
    ``transformer.loss_terms`` on its slice of the batch, on the device of
    its row's first coordinate; the model axis's other coordinates run
    nothing more.  A batch the data axes do not divide is computed whole
    by the first row, its MoE dispatch still in ``data_shards()`` chunks,
    as ``sanitize_pspec`` and the JAX package's ``moe_block`` have it.
  * **Gather at use.** A stacked leaf's layer ``i`` is gathered onto the
    compute device where the model takes it (``transformer.layer``),
    inside the layer's checkpointed function, so the recomputation
    gathers again and the forward frees the gathered copy; the other
    leaves are gathered once a step.  The gather is an autograd
    ``Function`` (``_Gather``) whose backward cuts the gradient by the
    same spec and adds each block into the leaf's gradient block on the
    block's device: the reduce-scatter.  Shards run their backward one
    after another in ascending coordinate order, so the sums over data
    shards come in one order, with no atomics, and a step replays bit for
    bit.
  * **Cross-shard terms.** The loss is the mean of the equal-size shards'
    per-token losses (cross entropy and deepseek's MTP term).  The MoE
    aux loss ``E * sum(density * mean_prob)`` is over *all* tokens: each
    shard returns its layers' density and mean probability
    (``router_stats``), the means over shards are taken before the
    product, and each shard's backward takes ``E * D * m_s / n`` with the
    global density ``D`` (the density carries no gradient).
  * **AdamW on blocks.** ``AdamW.apply`` runs over the unique blocks: the
    global norm counts each block once, and each block's update, an
    elementwise function of its own leaf's block, is computed on that
    block's device and copied to its replicas on other devices.

On a mesh of one data row the loss and gradients are the single-device
step's bit for bit (``tests/test_torch_lm_spmd.py``); across data shards
the sums come in another order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.precision import full_fp32_backward
from repro_torch.distributed import act_sharding
from repro_torch.distributed.sharding import (
    P, Sharded, _STACK_KEYS, _with_paths, batch_axes, block_of,
    opt_state_pspecs, params_pspecs, sanitized_shardings,
    tree_map_with_path)
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of
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
    """One stack's blocks, written layer by layer."""

    def __init__(self, placer: _Placer, key: str, n: int):
        self.placer, self.key, self.n = placer, key, n
        self.like = None
        self.leaves: Dict[Tuple[str, ...], Dict[str, Any]] = {}

    def add(self, i: int, layer) -> None:
        if self.like is None:
            self.like = layer
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
        index, device = sh.block_index(coord), mesh.device(coord)
        if (index, device) not in blocks:
            blocks[(index, device)] = torch.empty(
                block_of(probe, spec, mesh, index).shape, dtype=dtype,
                device=device)
        shards[coord] = blocks[(index, device)]
    return {"blocks": blocks, "sharded": sh}


def _zeros_like(sh: Sharded, dtype) -> Sharded:
    """Zeros of ``sh``'s shape and spec in ``dtype``, one block a device."""
    made: Dict[Any, torch.Tensor] = {}
    shards = np.empty(sh.mesh.devices.shape, dtype=object)
    for coord in sh.mesh.coords():
        key = (sh.block_index(coord), sh.mesh.device(coord))
        if key not in made:
            made[key] = torch.zeros(sh.shards[coord].shape, dtype=dtype,
                                    device=key[1])
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
# gather at use, reduce-scatter in the backward
# --------------------------------------------------------------------------
class _Leaf:
    """A parameter leaf in one step: its blocks, gathered where a shard's
    compute takes them, and float32 gradient blocks on the blocks'
    devices (the first coordinate holding each), added into by the
    gather's backward."""

    def __init__(self, sh: Sharded, stacked: bool):
        self.sh, self.stacked = sh, stacked
        self.core = P(*tuple(sh.spec)[1:]) if stacked else sh.spec
        self.unique = sh.unique()
        self.grads: Dict[Tuple[int, ...], torch.Tensor] = {}

    def _copy(self, coords, device) -> torch.Tensor:
        """A copy of the block held at ``coords``, one on ``device`` where
        there is one."""
        for c in coords:
            if self.sh.mesh.device(c) == device:
                return self.sh.shards[c]
        return self.sh.shards[coords[0]]

    def gather(self, index, device) -> torch.Tensor:
        """The leaf (layer ``index`` of a stacked one) whole on
        ``device``."""
        parts = {}
        for idx, coords in self.unique.items():
            b = self._copy(coords, device)
            parts[idx[1:] if self.stacked else idx] = \
                b if index is None else b[index]
        ndim = len(self.sh.shape) - (1 if self.stacked else 0)
        counts = [1 + max(k[d] for k in parts) for d in range(ndim)]

        def join(prefix, d):
            if d == ndim:
                return parts[prefix].to(device)
            cut = [join(prefix + (i,), d + 1) for i in range(counts[d])]
            return cut[0] if len(cut) == 1 else torch.cat(cut, dim=d)
        return join((), 0)

    def add_grad(self, index, g: torch.Tensor) -> None:
        for idx, coords in self.unique.items():
            part = block_of(g, self.core, self.sh.mesh,
                            idx[1:] if self.stacked else idx)
            dev = self.sh.mesh.device(coords[0])
            buf = self.grads.get(idx)
            if buf is None:
                buf = self.grads[idx] = torch.zeros(
                    self.sh.shards[coords[0]].shape, dtype=torch.float32,
                    device=dev)
            dst = buf if index is None else buf[index]
            dst.add_(part.to(device=dev, dtype=torch.float32))

    def grad(self, idx) -> torch.Tensor:
        """The gradient block ``idx`` (zeros where the loss did not reach
        the leaf, as in JAX)."""
        g = self.grads.get(idx)
        if g is None:
            c0 = self.unique[idx][0]
            g = torch.zeros(self.sh.shards[c0].shape, dtype=torch.float32,
                            device=self.sh.mesh.device(c0))
        return g


class _Gather(torch.autograd.Function):
    """Forward: a leaf (or a stacked leaf's layer) gathered on a device.
    Backward: its gradient cut by the leaf's spec and added into the
    gradient blocks (``_Leaf.add_grad``).  ``anchor`` is an empty tensor
    that requires grad, so the output records and the backward runs."""

    @staticmethod
    def forward(ctx, anchor, leaf: _Leaf, index, device):
        ctx.leaf, ctx.index = leaf, index
        return leaf.gather(index, device).detach()

    @staticmethod
    def backward(ctx, g):
        ctx.leaf.add_grad(ctx.index, g)
        return None, None, None, None


class _Stack:
    """A stacked leaf in a shard's parameter tree: indexing it gathers the
    layer (``transformer.layer``) in the compute dtype."""

    def __init__(self, leaf: _Leaf, device, anchor, dtype):
        self.leaf, self.device, self.anchor, self.dtype = \
            leaf, device, anchor, dtype

    def __getitem__(self, i: int) -> torch.Tensor:
        t = _Gather.apply(self.anchor, self.leaf, i, self.device)
        return t.to(self.dtype) if t.is_floating_point() else t

    @property
    def _version(self) -> int:
        """The version of the blocks (the serving cache's key)."""
        return self.leaf.sh.shards.flat[0]._version


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


def _batch_slice(batch, s: int, n: int, device) -> Dict[str, torch.Tensor]:
    def cut(v):
        v = v.gather() if isinstance(v, Sharded) else v
        b = v.shape[0] // n
        return v[s * b:(s + 1) * b].to(device)
    return {k: cut(v) for k, v in batch.items()}


def value_and_grad(model, params, batch):
    """(loss, metrics, {path: _Leaf with its gradient blocks}) of the
    model's loss at the placed ``params`` over ``batch`` (global tensors,
    or ``Sharded`` ones), computed per data shard (the module's
    docstring)."""
    cfg = model.cfg
    leaves = tree_map_with_path(
        lambda path, sh: _Leaf(sh, any(k in _STACK_KEYS for k in path)),
        params)
    mesh = tree_util.leaves(params)[0].mesh
    n_data = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    B = next(iter(batch.values())).shape[0]
    split = B % n_data == 0
    n = n_data if split else 1
    coords = _compute_coords(mesh, n)
    cdtype = dtype_of(cfg.compute_dtype)
    moe = cfg.family == "moe"
    mains, auxes, metrics = [], [], []
    with act_sharding.local(1 if split else n_data):
        for s, coord in enumerate(coords):
            device = mesh.device(coord)
            anchor = torch.empty(0, device=device, requires_grad=True)

            def use(leaf):
                if leaf.stacked:
                    return _Stack(leaf, device, anchor, cdtype)
                return _Gather.apply(anchor, leaf, None, device)
            tree = tree_util.tree_map(use, leaves)
            main, aux, m = tfm.loss_terms(tree, cfg,
                                          _batch_slice(batch, s, n, device),
                                          router_stats=moe)
            mains.append(main)
            auxes.append(aux)
            metrics.append(m)
        dev0 = mains[0].device
        if moe:
            # the aux loss over all tokens: the shards' means before the
            # product, layer by layer as the single-device sum adds them
            D = torch.stack([a[:, 0].detach().to(dev0) for a in auxes]
                            ).mean(0)
            M = torch.stack([a[:, 1].detach().to(dev0) for a in auxes]
                            ).mean(0)
            E = cfg.n_experts
            aux = torch.zeros((), dtype=torch.float32, device=dev0) \
                + torch.sum(torch.stack([E * torch.sum(D[i] * M[i])
                                         for i in range(D.shape[0])]))
        else:
            aux = auxes[0].detach()
        coef = cfg.router_aux_coef
        for s, main in enumerate(mains):
            term = main / n
            if moe:
                m_s, D_s = auxes[s][:, 1], D.to(main.device)
                term = term + coef * torch.sum(torch.stack(
                    [E * torch.sum(D_s[i] * m_s[i])
                     for i in range(D_s.shape[0])])) / n
            with full_fp32_backward():
                torch.autograd.backward(term)
    with torch.no_grad():
        loss = torch.mean(torch.stack([m.detach().to(dev0) for m in mains])) \
            + coef * aux
        out = {"loss": loss, "aux": aux,
               "ce": torch.mean(torch.stack([m["ce"].detach().to(dev0)
                                             for m in metrics]))}
        if "mtp" in metrics[0]:
            out["mtp"] = torch.mean(torch.stack(
                [m["mtp"].detach().to(dev0) for m in metrics]))
    return loss, out, leaves


def _blocks_of(sh: Sharded, unique) -> List[torch.Tensor]:
    return [sh.shards[coords[0]] for coords in unique.values()]


def _replaced(like: Sharded, unique, new: List[torch.Tensor]) -> Sharded:
    """``like``'s layout with its unique blocks replaced by ``new``, copied
    to the coordinates of other devices (one copy a device)."""
    shards = np.empty(like.mesh.devices.shape, dtype=object)
    for (idx, coords), t in zip(unique.items(), new):
        on = {}
        for c in coords:
            dev = like.mesh.device(c)
            if dev not in on:
                on[dev] = t if t.device == dev else t.to(dev)
            shards[c] = on[dev]
    return Sharded(like.mesh, like.spec, like.shape, shards)


def gradients(leaves):
    """The gradient blocks of :func:`value_and_grad`'s leaves, as a tree of
    ``Sharded`` laid out as the parameters."""
    return tree_util.tree_map(
        lambda leaf: _replaced(leaf.sh, leaf.unique,
                              [leaf.grad(idx) for idx in leaf.unique]),
        leaves)


def train_step(model, optimizer, state, batch):
    """One sharded step: ``make_train_step``'s over a placed state.
    Returns the new placed state and the metrics."""
    _, metrics, leaves = value_and_grad(model, state.params, batch)
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
