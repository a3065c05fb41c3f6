"""The paper's own architecture on the production mesh: the sharded CNN
train step, and its dry run.

The counterpart of the JAX package's ``launch/dryrun_cnn.py``, which
lowers an SFC-int8 ResNet-18 or VGG-16 training step at a global batch of
4096 on the production mesh and lets GSPMD shard it: the convs' C_out and
the head's columns over ``'model'`` (:func:`cnn_param_pspec`), the batch
over ``('pod', 'data')``.  The port has no compiler, so
:func:`train_step` is that sharded step, in the single-controller design
of ``distributed/lm_spmd.py`` (one process drives every block on its
coordinate's device; a mesh may repeat one device):

  * **State.** Parameters and the AdamW moments are ``Sharded`` by
    :func:`cnn_param_pspec` (the moments by ``opt_state_pspecs``), each
    data row holding its own replica (:func:`state_shardings`).
  * **Each block on its own coordinate.** Every data row takes its slice
    of the batch; a conv runs each C_out block on its coordinate (r, m)
    from the row's input, sent there, and the blocks' outputs are
    gathered over ``'model'`` at the row before the next layer
    (``model_split._Cut``, the column arithmetic of the sharded LM step);
    the head likewise by its column blocks.
  * **The whole batch's statistics, as GSPMD computes them.** The norms'
    mean and variance are over the global batch (each row's sums added at
    the mesh's first coordinate in row order, sent back to the rows), and
    with int8 fake quantization each conv's activation scales are the
    absmax over the global batch: each row's transform-domain input is
    measured first, the maxima joined in row order, and a row's absmax
    element takes the scale's gradient where it is the global one.
  * **Gradients summed in a fixed order.** One backward gives each
    coordinate's gradient of its own blocks; each block's replicas'
    gradients are added at its first coordinate in coordinate order
    (counted as ``gradients``), and AdamW runs on each block there, its
    result copied to the replicas (``lm_spmd.apply_gradients``).

On a mesh of one coordinate the step is ``make_train_step``'s over
``cnn_loss`` bit for bit (``tests/test_torch_dryrun.py``); elsewhere the
sums come in another order.  It runs on the card as on meta.

:func:`lower_cnn` dry-runs the step on ``make_production_mesh(device=
"meta")`` at ``GLOBAL_BATCH`` under ``hlo_analysis.analyze`` and writes
a record with the LM record's keys (``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_cnn [--multi-pod] \\
      [--model resnet18|vgg16] [--algo sfc6_7|direct|sfc6_6|sfc4_4|wino4]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Dict, List, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.api import ConvSpec, plan
from repro_torch.api.lowering import CompositePlan
from repro_torch.configs.resnet18 import RESNET18, VGG16
from repro_torch.core import conv2d as c2d
from repro_torch.distributed import lm_spmd
from repro_torch.distributed.model_split import (_Blk, _Cut, _Row,
                                                 _model_dim, param_leaves)
from repro_torch.distributed.sharding import (
    P, _with_paths, batch_axes, opt_state_pspecs, place,
    sanitized_shardings, tree_map_with_path)
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import cnn
from repro_torch.optim.optimizers import AdamW
from repro_torch.quant import fake_quant as fq
from repro_torch.train.steps import TrainState

GLOBAL_BATCH = 4096          # ImageNet-scale training batch


def cnn_param_pspec(path, leaf, mesh) -> P:
    """Convs: output channels over 'model'; the head's columns likewise;
    everything else replicated.  The batch carries the 'data' (+'pod')
    parallelism."""
    name = path[-1]
    m = mesh.shape["model"]
    if name == "w" and len(leaf.shape) == 4 and leaf.shape[-1] % m == 0:
        return P(None, None, None, "model")       # (R, R, Cin, Cout)
    if name == "w" and len(leaf.shape) == 2 and leaf.shape[-1] % m == 0:
        return P(None, "model")                   # head
    return P(*([None] * len(leaf.shape)))


def state_shardings(cfg, optimizer, mesh) -> TrainState:
    """The CNN's ``TrainState`` of ``NamedSharding``s: the parameters by
    :func:`cnn_param_pspec`, the moments by ``opt_state_pspecs``, the
    seed replicated."""
    params = cnn.init_abstract(cfg)
    pspecs = tree_map_with_path(
        lambda p, leaf: cnn_param_pspec(p, leaf, mesh), params)
    abstract = TrainState(params, optimizer.init(params),
                          torch.empty((), dtype=torch.int64, device="meta"))
    specs = TrainState(pspecs, opt_state_pspecs(abstract.opt, pspecs), P())
    return sanitized_shardings(specs, abstract, mesh)


def place_state(cfg, optimizer, mesh, params=None, seed: int = 0
                ) -> TrainState:
    """The state placed by :func:`state_shardings`: ``params`` (an
    unsharded tree) and fresh moments, or with none the abstract tree."""
    params = cnn.init_abstract(cfg) if params is None else params
    state = TrainState(params, optimizer.init(params),
                       torch.tensor(seed, dtype=torch.int64,
                                    device=tree_util.leaves(params)[0].device))
    return place(state, state_shardings(cfg, optimizer, mesh))


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------
def _amaxes(p, x, granularity: str) -> List[torch.Tensor]:
    """The absmax of each transform-domain input a plan's hook is given
    (in the order it is called), reduced as ``granularity`` reduces."""
    if isinstance(p, CompositePlan):
        out = []
        for sp, xs in zip(p.sub_plans, p._sub_inputs(x)):
            if sp.path != "direct":
                out += _amaxes(sp, xs, granularity)
        return out
    tx, _ = c2d.transform_input_2d(x, p.algorithm, p.spec.padding)
    axes = fq.activation_reduce_axes(tx.dim(), granularity, (-3, -2))
    return [torch.amax(torch.abs(tx), dim=axes, keepdim=True)]


class _Step(cnn.Ops):
    """The operations of ``cnn_loss``'s forward over every data row at
    once, layer by layer (lists of the rows' activations): the rows meet
    at the batch's statistics (the module's docstring).  The forward
    itself is the models' (``cnn.resnet_forward``/``vgg_forward`` over
    the placed tree, their ``ops`` seam)."""

    def __init__(self, cfg, params, batch):
        self.path_of = {id(sh): path for path, sh in _with_paths(params)}
        self.mesh = next(iter(_with_paths(params)))[1].mesh
        mesh = self.mesh
        B = batch["images"].shape[0]
        n_data = math.prod(mesh.shape[a] for a in batch_axes(mesh))
        self.n = n_data if B % n_data == 0 else 1
        self.B = B
        self.rows = [_Row(mesh, c, s) for s, c in
                     enumerate(lm_spmd._compute_coords(mesh, self.n))]
        self.origin = self.rows[0]
        self.leaves: Dict[Tuple, torch.Tensor] = {}
        b = B // self.n
        self.images = [row.take(batch["images"][s * b:(s + 1) * b])
                       for s, row in enumerate(self.rows)]
        self.labels = [row.take(batch["labels"][s * b:(s + 1) * b])
                       for s, row in enumerate(self.rows)]
        self.quant = cnn.quant_config(cfg)

    # ---- the coordinates' own blocks, as autograd leaves ------------------
    def leaf(self, sh, coord) -> torch.Tensor:
        key = (self.path_of[id(sh)], tuple(coord))
        t = self.leaves.get(key)
        if t is None:
            t = self.leaves[key] = \
                sh.shards[tuple(coord)].detach().requires_grad_()
        return t

    def blocks(self, row, sh) -> List[_Blk]:
        """The row's blocks of leaf ``sh`` along its output columns."""
        d = _model_dim(sh.spec)
        if d is None:
            t = self.leaf(sh, row.coord)
            return [_Blk(0, t.shape[-1], row.coord, t)]
        out, lo = [], 0
        for m in range(self.mesh.shape["model"]):
            t = self.leaf(sh, row.at(m))
            out.append(_Blk(lo, lo + t.shape[d], row.at(m), t))
            lo += t.shape[d]
        return out

    # ---- the batch's statistics ---------------------------------------------
    def _join(self, parts, fn):
        """``fn`` over the rows' ``parts`` joined at the mesh's first
        coordinate in row order, the result sent to each row."""
        o = self.origin
        total = None
        for row, t in zip(self.rows, parts):
            t = o.send(t, row.coord, o.coord)
            total = t if total is None else fn(total, t)
        return o.fan(total, [row.coord for row in self.rows])

    def norm(self, hs, scale, bias):
        if self.n == 1:
            row = self.rows[0]
            return [super().norm(hs[0], self.leaf(scale, row.coord),
                                 self.leaf(bias, row.coord))]
        count = sum(h.shape[0] * h.shape[1] * h.shape[2] for h in hs)
        mus = self._join([h.sum(dim=(0, 1, 2), keepdim=True) for h in hs],
                         torch.add)
        mus = [m / count for m in mus]
        devs = [h - mu for h, mu in zip(hs, mus)]
        var = self._join([torch.square(d).sum(dim=(0, 1, 2), keepdim=True)
                          for d in devs], torch.add)
        return [d * torch.rsqrt(v / count + 1e-5)
                * self.leaf(scale, row.coord) + self.leaf(bias, row.coord)
                for d, v, row in zip(devs, var, self.rows)]

    def _hooks(self, p, hs, qhook):
        """For each row, what makes a C_out block's elementwise hook: the
        forward's where one row holds the batch, else the config's fake
        quantization at the global batch's activation scales."""
        q = self.quant
        if qhook is None or p.path == "direct":
            return [lambda: None] * len(hs)
        if self.n == 1:
            return [lambda: qhook]
        # each row's transform-domain absmax, measured first (under
        # autograd: the scale's gradient reaches the global argmax through
        # it, as the unsharded step's does), joined in row order
        per_row = [_amaxes(p, h, q.act_granularity) for h in hs]
        glob = [self._join([r[k] for r in per_row], torch.maximum)
                for k in range(len(per_row[0]))]
        qmax = fq.qmax_for_bits(q.bits_act)

        def make(s):
            calls = [0]

            def hook(tx, tw):
                k = calls[0]
                calls[0] += 1
                axes = fq.activation_reduce_axes(tx.dim(), q.act_granularity,
                                                 (-3, -2))
                scale = glob[k][s].to(tx.device) / qmax + 1e-12
                return (fq.fake_quant(tx, q.bits_act, axes, scale),
                        fq.fake_quant_weight(tw, q.bits_weight,
                                             q.weight_granularity))
            return hook
        return [lambda s=s: make(s) for s in range(len(hs))]

    # ---- the layers ------------------------------------------------------------
    def conv(self, hs, p, cfg, stride: int, qhook):
        """The conv of parameters ``p`` on every row, each C_out block on
        its own coordinate, its input sent there and its output gathered
        at the row."""
        first = self.blocks(self.rows[0], p["w"])[0].t
        spec = ConvSpec.for_conv2d(tuple(hs[0].shape), tuple(first.shape),
                                   stride=stride, padding="SAME")
        pl = plan(spec, backend="reference", algo=cfg.conv_algo)
        hooks = self._hooks(pl, hs, qhook)
        out = []
        for row, h, hook in zip(self.rows, hs, hooks):
            blocks = self.blocks(row, p["w"])
            xs = _Cut.at_row(row, h).spread([b.coord for b in blocks])
            pieces = []
            for b, x in zip(blocks, xs):
                bias = self.leaf(p["b"], b.coord)
                if (b.lo, b.hi) != (0, bias.shape[0]):
                    bias = bias[b.lo:b.hi]
                pieces.append(_Blk(b.lo, b.hi, b.coord, cnn.conv_apply(
                    x, b.t, bias, cfg, stride=stride, qhook=hook())))
            out.append(_Cut(row, pieces).whole())
        return out

    def each(self, fn, *hs):
        return [fn(*a) for a in zip(*hs)]

    def head(self, hs, p):
        out = []
        for row, h in zip(self.rows, hs):
            blocks = self.blocks(row, p["w"])
            xs = _Cut.at_row(row, h).spread([b.coord for b in blocks])
            pieces = [_Blk(b.lo, b.hi, b.coord, x @ b.t)
                      for b, x in zip(blocks, xs)]
            out.append(_Cut(row, pieces).whole()
                       + self.leaf(p["b"], row.coord))
        return out

    def loss(self, logits, labels):
        """The global batch's mean cross entropy and accuracy, at the
        mesh's first coordinate."""
        if self.n == 1:
            return super().loss(logits[0], labels[0])
        o = self.origin
        loss = acc = None
        for row, lg, lb in zip(self.rows, logits, labels):
            lb = lb.long()
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, lb[:, None])[:, 0]
            hits = (torch.argmax(lg, -1) == lb).to(torch.float32)
            t = o.send((logz - gold).sum(), row.coord, o.coord)
            h = o.send(hits.sum(), row.coord, o.coord)
            loss = t if loss is None else loss + t
            acc = h if acc is None else acc + h
        return loss / self.B, acc / self.B


def value_and_grad(cfg, params, batch):
    """(loss, metrics, {path: _Leaf with its gradient blocks}) of
    ``cnn_loss`` at the placed ``params`` over ``batch`` (the module's
    docstring)."""
    step = _Step(cfg, params, batch)
    loss, metrics = cnn.cnn_loss(
        params, cfg, {"images": step.images, "labels": step.labels},
        ops=step)
    keys = list(step.leaves)
    grads = torch.autograd.grad(loss, [step.leaves[k] for k in keys],
                                allow_unused=True)
    got = dict(zip(keys, grads))
    leaves = param_leaves(params)
    by_path = dict(_with_paths(leaves))
    for path, leaf in by_path.items():
        for idx, coords in leaf.unique.items():
            c0, total = coords[0], None
            for c in coords:
                g = got.get((path, c))
                if g is None:
                    continue
                if c != c0:
                    g = step.origin.send(g, c, c0, "gradients")
                total = g if total is None else total + g
            if total is not None:
                leaf.grads[idx] = total.to(torch.float32)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        leaves


def train_step(cfg, optimizer, state: TrainState, batch):
    """One sharded step of ``cnn_loss`` over a placed state
    (:func:`place_state`): the new placed state and the metrics."""
    _, metrics, leaves = value_and_grad(cfg, state.params, batch)
    return lm_spmd.apply_gradients(optimizer, state, leaves, metrics)


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------
def cnn_config(model_name: str, algo: str):
    return dataclasses.replace(
        RESNET18 if model_name == "resnet18" else VGG16,
        conv_algo=algo, quant="int8" if algo != "direct" else "none")


def lower_cnn(model_name: str, algo: str, multi_pod: bool, mesh=None,
              cfg=None, batch: int = GLOBAL_BATCH,
              dtype: torch.dtype = torch.float32) -> Dict:
    """The record of one sharded CNN step on the production mesh (the
    LM record's keys, ``launch/dryrun.py``), parameters and images of
    ``dtype``."""
    t0 = time.time()
    cfg = cfg if cfg is not None else cnn_config(model_name, algo)
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device="meta")
    opt = AdamW(lr=1e-3)
    state = place_state(cfg, opt, mesh, tree_util.tree_map(
        lambda t: t.to(dtype), cnn.init_abstract(cfg)))
    images = torch.empty((batch, cfg.image_size, cfg.image_size, 3),
                         dtype=dtype, device="meta")
    labels = torch.empty((batch,), dtype=torch.int32, device="meta")
    result, summary = hlo_analysis.analyze(
        lambda s, b: train_step(cfg, opt, s, b), state,
        {"images": images, "labels": labels}, mesh=mesh)
    n_params = sum(math.prod(t.shape)
                   for t in tree_util.leaves(cnn.init_abstract(cfg)))
    rec = {"arch": f"{model_name}-{algo}", "shape": f"train_b{batch}",
           "mesh": dryrun.mesh_name(mesh), "n_chips": mesh.size,
           "kind": "train", "n_params": int(n_params),
           "active_params": int(n_params), "model_flops": 0.0}
    rec.update(dryrun.record(summary, dryrun._outputs(result, (state,))))
    rec["seconds"] = time.time() - t0
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet18",
                    choices=["resnet18", "vgg16"])
    ap.add_argument("--algo", default="sfc6_7",
                    choices=["direct", "sfc6_7", "sfc6_6", "sfc4_4",
                             "wino4"])
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    rec = lower_cnn(args.model, args.algo, args.multi_pod)
    tag = "pod2" if args.multi_pod else "pod1"
    out = dryrun.OUT_DIR / f"{tag}_{args.model}-{args.algo}_train.json"
    dryrun.OUT_DIR.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"[ok] {out.name}: la_flops/device={rec['la_flops']:.3e} "
          f"t_compute={rec['t_compute_ms']:.1f}ms "
          f"t_memory={rec['t_memory_ms']:.1f}ms "
          f"t_link={rec['t_link_ms']} ({rec['seconds']:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
