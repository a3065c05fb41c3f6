"""CNNs from the paper's evaluation (ResNet-18 family, VGG-16 family).

Every convolution routes through the ``repro_torch.api`` planner on the
``reference`` backend, as the JAX package's models plan theirs: 3x3
stride-1 layers run the selected fast algorithm (any registered name, or
``auto``) with optional transform-domain fake quantization — the
substitution the paper performs on TorchVision models (§6.1) — and the
stride-2 stage-transition convs and the stride-2 stem are *lowered* by the
planner onto polyphase stride-1 SFC sub-convs (``repro_torch.api.
lowering``).  Only 1x1 projections (and shapes whose lowering the cost
model rejects) use the direct path.  The hand-written kernels take no
hooks; a calibrated model reaches them through ``repro_torch.quant.ptq``
(``PTQLayer.prepare`` on a ``cuda`` plan).

Parameters are nested dicts of tensors in the JAX package's layout
(``stem``, ``s{i}b{j}`` with ``conv1``, ``conv2``, ``scale1``, ...,
``proj``, ``head``; VGG's ``s{i}c{j}``), so
``repro_torch.interop.params_from_numpy`` carries JAX parameters across
unchanged.  :class:`ResNet` and :class:`VGG` hold the same tree as an
``nn.Module``.  The forwards run where their inputs lie; the init
functions put the weights on ``device``, the card unless the caller says
otherwise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

import repro_torch.quant.fake_quant as fq
from repro_torch.api import ConvSpec, plan
from repro_torch.api import registry as algo_registry
from repro_torch.configs.resnet18 import CNNConfig
from repro_torch.core.conv2d import same_pads
from repro_torch.core.generator import BilinearAlgorithm

Params = Dict[str, Any]


def conv_algo(name: str) -> Optional[BilinearAlgorithm]:
    """Resolve an algorithm name via the ``repro_torch.api`` registry."""
    return algo_registry.get_algorithm(name)


def quant_config(cfg: CNNConfig) -> fq.QuantConfig:
    if cfg.quant == "none":
        return fq.FP32
    bits = int(cfg.quant[3:])
    return fq.QuantConfig(bits, bits, cfg.act_granularity,
                          cfg.weight_granularity)


def conv_apply(x, w, b, cfg: CNNConfig, stride: int = 1,
               qhook=None) -> torch.Tensor:
    """Algorithm-dispatched conv through the ``repro_torch.api`` planner.

    Stride-2 convs lower onto polyphase stride-1 sub-convs (path
    'lowered'); 1x1 / tap-mismatched / lowering-rejected convs degrade to
    direct.  Quantization stays hook-driven (dynamic fake quant for
    training and PTQ simulation), so the spec itself is fp; on lowered
    plans the hook reaches each sub-conv's transform domain.
    """
    spec = ConvSpec.for_conv2d(tuple(x.shape), tuple(w.shape), stride=stride,
                               padding="SAME")
    p = plan(spec, backend="reference", algo=cfg.conv_algo)
    hook = qhook if p.path != "direct" else None
    return p.apply(x, w, bias=b, elementwise_hook=hook)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """NHWC max-pool with XLA's SAME padding (``lax.reduce_window`` with
    -inf): the low pad is total // 2, the odd pixel goes after the image."""
    lo_h, hi_h = same_pads(x.shape[1], window, stride)
    lo_w, hi_w = same_pads(x.shape[2], window, stride)
    h = F.pad(x.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h),
              value=float("-inf"))
    return F.max_pool2d(h, window, stride).permute(0, 2, 3, 1).contiguous()


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    if gen.device.type == "meta":        # layers.ABSTRACT: shapes only
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(device)


def _conv_init(gen, r, cin, cout, device):
    fan = r * r * cin
    return _normal(gen, (r, r, cin, cout), device) * math.sqrt(2.0 / fan)


def _zeros(n, device):
    return torch.zeros(n, dtype=torch.float32, device=device)


def _ones(n, device):
    return torch.ones(n, dtype=torch.float32, device=device)


def _norm_apply(x, scale, bias):
    # BatchNorm folded into scale/bias (the paper fuses BN before quant);
    # training uses this as a per-channel affine "filter response norm" lite.
    # correction=0: the population variance, as jnp.var
    mu = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.var(x, dim=(0, 1, 2), keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


class Ops:
    """The forward's operations on a batch held whole: the plain ones.

    ``resnet_forward``, ``vgg_forward`` and ``cnn_loss`` reach every
    layer through these, so a caller that holds the batch otherwise (the
    sharded CNN train step, ``launch/dryrun_cnn.py``, over the rows of a
    mesh) supplies its own and keeps the models' structure.  ``p`` is a
    layer's parameter subtree; ``qhook`` a conv's transform-domain hook
    (None: not quantized)."""

    def conv(self, h, p, cfg: CNNConfig, stride: int, qhook):
        return conv_apply(h, p["w"], p["b"], cfg, stride=stride,
                          qhook=qhook)

    def norm(self, h, scale, bias):
        return _norm_apply(h, scale, bias)

    def each(self, fn, *hs):
        """``fn`` over activations, elementwise in the batch."""
        return fn(*hs)

    def head(self, h, p):
        return h @ p["w"] + p["b"]

    def loss(self, logits, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's mean cross entropy and accuracy."""
        labels = labels.long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, None])[:, 0]
        loss = torch.mean(logz - gold)
        acc = torch.mean((torch.argmax(logits, -1) == labels)
                         .to(torch.float32))
        return loss, acc


PLAIN = Ops()


def _relu_sum(y, sc):
    return torch.relu(y + sc)


def _spatial_mean(h):
    return torch.mean(h, dim=(1, 2))


def _head(gen, cin, n_classes, device) -> Params:
    return {"w": _normal(gen, (cin, n_classes), device) * 0.01,
            "b": _zeros(n_classes, device)}


# --------------------------------------------------------------------------
# ResNet
# --------------------------------------------------------------------------
def init_resnet(gen: torch.Generator, cfg: CNNConfig,
                device="cuda") -> Params:
    """He-normal convs, unit norms and a N(0, 0.01) head, drawn from ``gen``
    (on its own device) and placed on ``device``."""
    p: Params = {}
    w0 = cfg.widths[0]
    p["stem"] = {"w": _conv_init(gen, cfg.stem_kernel, 3, w0, device),
                 "b": _zeros(w0, device),
                 "scale": _ones(w0, device), "bias": _zeros(w0, device)}
    cin = w0
    for si, (n_blocks, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = {
                "conv1": {"w": _conv_init(gen, 3, cin, width, device),
                          "b": _zeros(width, device)},
                "conv2": {"w": _conv_init(gen, 3, width, width, device),
                          "b": _zeros(width, device)},
                "scale1": _ones(width, device),
                "bias1": _zeros(width, device),
                "scale2": _ones(width, device),
                "bias2": _zeros(width, device),
            }
            if stride != 1 or cin != width:
                blk["proj"] = {"w": _conv_init(gen, 1, cin, width, device),
                               "b": _zeros(width, device)}
            p[f"s{si}b{bi}"] = blk
            cin = width
    p["head"] = _head(gen, cin, cfg.n_classes, device)
    return p


def resnet_forward(p: Params, cfg: CNNConfig, x: torch.Tensor,
                   qhooks: Optional[Dict[str, Any]] = None,
                   ops: Ops = PLAIN) -> torch.Tensor:
    """x (B, H, W, 3) -> logits.  qhooks maps layer name -> elementwise hook
    (None = use the config-default quantizer)."""
    default_hook = quant_config(cfg).hook()

    def hook_for(name):
        if qhooks is not None and name in qhooks:
            return qhooks[name]
        return default_hook

    stem_stride = 2 if cfg.image_size >= 128 else 1
    h = ops.conv(x, p["stem"], cfg, stem_stride, None)
    h = ops.each(torch.relu, ops.norm(h, p["stem"]["scale"],
                                      p["stem"]["bias"]))
    if cfg.image_size >= 128:
        h = ops.each(lambda t: max_pool_same(t, 3, 2), h)
    for si, (n_blocks, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = p[f"s{si}b{bi}"]
            name = f"s{si}b{bi}"
            y = ops.conv(h, blk["conv1"], cfg, stride,
                         hook_for(name + ".conv1"))
            y = ops.each(torch.relu, ops.norm(y, blk["scale1"],
                                              blk["bias1"]))
            y = ops.conv(y, blk["conv2"], cfg, 1, hook_for(name + ".conv2"))
            y = ops.norm(y, blk["scale2"], blk["bias2"])
            sc = h
            if "proj" in blk:
                sc = ops.conv(h, blk["proj"], cfg, stride, None)
            h = ops.each(_relu_sum, y, sc)
    return ops.head(ops.each(_spatial_mean, h), p["head"])


# --------------------------------------------------------------------------
# VGG
# --------------------------------------------------------------------------
def init_vgg(gen: torch.Generator, cfg: CNNConfig, device="cuda") -> Params:
    """He-normal 3x3 convs and a N(0, 0.01) head, drawn from ``gen`` (on its
    own device) and placed on ``device``."""
    p: Params = {}
    cin = 3
    for si, (n_convs, width) in enumerate(zip(cfg.stages, cfg.widths)):
        for ci in range(n_convs):
            p[f"s{si}c{ci}"] = {"w": _conv_init(gen, 3, cin, width, device),
                                "b": _zeros(width, device)}
            cin = width
    p["head"] = _head(gen, cin, cfg.n_classes, device)
    return p


def vgg_forward(p: Params, cfg: CNNConfig, x: torch.Tensor,
                ops: Ops = PLAIN) -> torch.Tensor:
    hook = quant_config(cfg).hook()
    h = x
    for si, n_convs in enumerate(cfg.stages):
        for ci in range(n_convs):
            h = ops.each(torch.relu, ops.conv(h, p[f"s{si}c{ci}"], cfg, 1,
                                              hook))
        h = ops.each(lambda t: max_pool_same(t, 2, 2), h)
    return ops.head(ops.each(_spatial_mean, h), p["head"])


def init_abstract(cfg: CNNConfig) -> Params:
    """The parameter tree's shapes and dtypes: empty meta tensors, no
    allocation (the LM's ``layers.ABSTRACT``; the dry run places them)."""
    from repro_torch.models.layers import ABSTRACT
    init = init_vgg if cfg.kind == "vgg" else init_resnet
    return init(ABSTRACT, cfg, device="meta")


def cnn_loss(p: Params, cfg: CNNConfig, batch,
             ops: Ops = PLAIN) -> Tuple[torch.Tensor, Dict]:
    if cfg.kind == "vgg":
        logits = vgg_forward(p, cfg, batch["images"], ops=ops)
    else:
        logits = resnet_forward(p, cfg, batch["images"], ops=ops)
    loss, acc = ops.loss(logits, batch["labels"])
    return loss, {"loss": loss, "acc": acc}


# --------------------------------------------------------------------------
# nn.Module wrappers: the same parameter tree, PyTorch's idiom
# --------------------------------------------------------------------------
class TreeModule(nn.Module):
    """A nested parameter dict as modules and parameters of the same names
    (``state_dict`` keys read ``s0b0.conv1.w``); ``requires_grad=False``
    freezes them (a served model's)."""

    def __init__(self, tree: Mapping[str, Any], requires_grad: bool = True):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, TreeModule(v, requires_grad))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=requires_grad))

    def tree(self) -> Params:
        out: Params = dict(self.named_parameters(recurse=False))
        out.update((k, m.tree()) for k, m in self.named_children())
        return out


class ResNet(TreeModule):
    """ResNet-18 family over a parameter tree (``init_resnet``'s, or the
    JAX package's through ``params_from_numpy``): ``forward(x,
    qhooks=None)`` is :func:`resnet_forward` over this module's
    parameters."""

    def __init__(self, cfg: CNNConfig, params: Params):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, qhooks=None):
        return resnet_forward(self.tree(), self.cfg, x, qhooks)


class VGG(TreeModule):
    """VGG-16 family over a parameter tree (``init_vgg``'s, or the JAX
    package's): ``forward(x)`` is :func:`vgg_forward` over this module's
    parameters."""

    def __init__(self, cfg: CNNConfig, params: Params):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x):
        return vgg_forward(self.tree(), self.cfg, x)
