"""The paper's CNNs in the port (``repro_torch.models.cnn``,
``repro_torch.configs``) against the JAX package's, with the JAX
parameters carried across by ``params_from_numpy`` and the same numpy
images."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.resnet18 as jconfigs  # noqa: E402
import repro.quant.fake_quant as jfq  # noqa: E402
from repro.api import ConvSpec as JConvSpec  # noqa: E402
from repro.api import plan as jplan  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
import repro_torch.quant.fake_quant as fq  # noqa: E402
from repro_torch.api import ConvSpec, lowering, plan  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.testing import DEFAULT_TOL  # noqa: E402

ALGOS = ["direct", "sfc6_6", "sfc6_7", "sfc4_4", "wino4"]
# the reduced VGG-16 of tests/test_cnn.py and the 128x128, 7x7/2-stem
# ResNet of its test_resnet_stride2_layers_lower_end_to_end
SMALL_VGG = dict(stages=(1, 1), widths=(8, 16), image_size=16, n_classes=10)
STEM_SMOKE = dict(name="stem-smoke", image_size=128, stem_kernel=7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    """The same configuration in both packages."""
    base = {"smoke": "SMOKE_CNN", "vgg": "VGG16", "stem": "SMOKE_CNN"}[name]
    extra = {"vgg": SMALL_VGG, "stem": STEM_SMOKE}.get(name, {})
    return (dataclasses.replace(getattr(jconfigs, base), **extra, **kw),
            dataclasses.replace(getattr(configs, base), **extra, **kw))


def _params(jcfg):
    init = jcnn.init_vgg if jcfg.kind == "vgg" else jcnn.init_resnet
    jp = init(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _images(cfg, batch=2, seed=0):
    return np.random.RandomState(seed).randn(
        batch, cfg.image_size, cfg.image_size, 3).astype(np.float32)


def _forwards(jcfg, cfg, jp, tp, x, **kw):
    if cfg.kind == "vgg":
        jy = jcnn.vgg_forward(jp, jcfg, jnp.asarray(x))
        y = cnn.vgg_forward(tp, cfg, torch.from_numpy(x))
    else:
        jy = jcnn.resnet_forward(jp, jcfg, jnp.asarray(x), **kw.get(
            "jax", {}))
        y = cnn.resnet_forward(tp, cfg, torch.from_numpy(x), **kw.get(
            "port", {}))
    return y.detach().numpy(), np.asarray(jy)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("net", ["smoke", "vgg"])
def test_fp32_forward_matches_jax(net, algo):
    """ResNet (SMOKE_CNN) and the reduced VGG-16, every algorithm in fp32:
    the logits within DEFAULT_TOL (rel L2) of the JAX package's."""
    jcfg, cfg = _cfgs(net, conv_algo=algo)
    jp, tp = _params(jcfg)
    y, jy = _forwards(jcfg, cfg, jp, tp, _images(cfg))
    assert y.shape == (2, cfg.n_classes)
    assert _rel(y, jy) <= DEFAULT_TOL


@pytest.mark.parametrize("net", ["smoke", "vgg"])
def test_int8_forward_matches_jax(net):
    """int8 sfc6_6 (dynamic fake quant through QuantConfig.hook()): the
    logits within 1e-3 (rel L2) of the JAX package's.  The two transforms
    differ in the last bits, which can flip a value at a .5 tie of the int8
    grid (see the stem case); here none did (rel L2 2e-7)."""
    jcfg, cfg = _cfgs(net, conv_algo="sfc6_6", quant="int8")
    jp, tp = _params(jcfg)
    y, jy = _forwards(jcfg, cfg, jp, tp, _images(cfg))
    assert _rel(y, jy) <= 1e-3
    # and the int8 network stays close to its fp32 self, as in JAX's test
    jfp, fp = _cfgs(net, conv_algo="sfc6_6")
    y_fp, _ = _forwards(jfp, fp, jp, tp, _images(cfg))
    assert _rel(y, y_fp) < 0.15


def test_per_layer_qhooks_match_jax():
    """qhooks: an fp32 network with 4-bit fake quant at one layer and int8
    at another, the rest fp32, as the JAX package applies them."""
    jcfg, cfg = _cfgs("smoke", conv_algo="sfc6_6")
    jp, tp = _params(jcfg)
    jh = {"s0b0.conv2": jfq.INT4_FREQ.hook(), "s1b0.conv1":
          jfq.INT8_TENSOR.hook()}
    th = {"s0b0.conv2": fq.INT4_FREQ.hook(), "s1b0.conv1":
          fq.INT8_TENSOR.hook()}
    x = _images(cfg)
    y, jy = _forwards(jcfg, cfg, jp, tp, x, jax={"qhooks": jh},
                      port={"qhooks": th})
    assert _rel(y, jy) <= DEFAULT_TOL
    y_fp, _ = _forwards(jcfg, cfg, jp, tp, x)
    assert _rel(y, y_fp) > 1e-4          # the hooks did something


def test_stem_case_lowers_and_matches_jax():
    """The 128x128 case with the 7x7/2 stem: its stride-2 convs lower, the
    fp32 forward matches the JAX package's within DEFAULT_TOL and the
    lowering-disabled forward within 1e-3 as JAX's test asserts, and int8
    stays within 0.15 (rel L2) of fp32.

    int8 against JAX: the hook is bit for bit JAX's on the transform-domain
    operands JAX's own forward hands each hooked layer.  The networks' own
    transforms differ in the last bits (summation order); dynamic scales
    then move values across .5 ties of the int8 grid (ROADMAP, C4), and
    six fake-quant layers carry the flips on, so the logits are held to
    1e-3 rel L2 (3.8e-4 here)."""
    jcfg, cfg = _cfgs("stem", conv_algo="sfc6_6")
    jp, tp = _params(jcfg)
    x = _images(cfg, batch=1)
    y, jy = _forwards(jcfg, cfg, jp, tp, x)
    assert _rel(y, jy) <= DEFAULT_TOL
    stem = ConvSpec(rank=2, kernel_size=7, stride=2, in_channels=3,
                    out_channels=8, spatial=(128, 128))
    assert plan(stem, backend="reference", algo="sfc6_6").path == "lowered"
    with lowering.disabled():
        assert plan(stem, backend="reference", algo="sfc6_6").path \
            == "direct"
        y_pre = cnn.resnet_forward(tp, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_pre, rtol=1e-3, atol=1e-3)
    jq, q = _cfgs("stem", conv_algo="sfc6_6", quant="int8")
    seen, jhook = [], jfq.INT8_FREQ.hook()

    def recording(tx, tw):
        txq, twq = jhook(tx, tw)
        seen.append([np.array(v) for v in (tx, tw, txq, twq)])
        return txq, twq

    names = [f"s{si}b0.conv{ci}" for si in (0, 1) for ci in (1, 2)]
    jyq = np.asarray(jcnn.resnet_forward(jp, jq, jnp.asarray(x), qhooks={
        n: recording for n in names}))
    assert len(seen) == 6                # s1b0.conv1 lowers: three sub-convs
    hook = fq.INT8_FREQ.hook()
    for tx, tw, txq, twq in seen:
        got = hook(torch.from_numpy(tx), torch.from_numpy(tw))
        np.testing.assert_array_equal(got[0].numpy(), txq)
        np.testing.assert_array_equal(got[1].numpy(), twq)
    yq = cnn.resnet_forward(tp, q, torch.from_numpy(x)).numpy()
    assert _rel(yq, jyq) <= 1e-3
    assert _rel(yq, y) < 0.15


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_cnn_loss_and_its_gradients_match_jax_grad():
    """cnn_loss on SMOKE_CNN int8 sfc6_6: the loss and accuracy as JAX's,
    and the gradient of every parameter (the STE through every fake-quant
    hook) within DEFAULT_TOL of the largest gradient of jax.grad."""
    jcfg, cfg = _cfgs("smoke", conv_algo="sfc6_6", quant="int8")
    jp, tp = _params(jcfg)
    x = _images(cfg)
    labels = np.array([0, 1], np.int32)
    jbatch = {"images": jnp.asarray(x), "labels": jnp.asarray(labels)}
    jloss, jmetrics = jcnn.cnn_loss(jp, jcfg, jbatch)
    jgrad = _flat(jax.grad(lambda p: jcnn.cnn_loss(p, jcfg, jbatch)[0])(jp))
    leaves = _flat(tp)
    for v in leaves.values():
        v.requires_grad_()
    loss, metrics = cnn.cnn_loss(tp, cfg, {
        "images": torch.from_numpy(x), "labels": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert float(metrics["acc"]) == float(jmetrics["acc"])
    assert set(leaves) == set(jgrad)
    scale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for name, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad[name]),
                                   rtol=0, atol=DEFAULT_TOL * scale,
                                   err_msg=name)
    assert sum(float(v.grad.abs().sum()) for v in leaves.values()) > 0


def test_repeated_backward_through_a_plan_matches_jax_grad():
    """The prepared-weight cache must not serve a transform computed in an
    earlier forward while autograd records (JAX never caches a tracer): a
    forward under no_grad, then two forward/backward passes through the
    same plan and weights each give jax.grad's gradient.  Before the
    repair the no_grad transform came back from the cache and the weights
    got no gradient."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 12, 12, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 6).astype(np.float32)
    jp = jplan(JConvSpec.for_conv2d(x.shape, w.shape), algo="sfc6_6")
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jp.apply(jnp.asarray(x), v) ** 2))(jnp.asarray(w)))
    p = plan(ConvSpec.for_conv2d(x.shape, w.shape), backend="reference",
             algo="sfc6_6")
    wt = torch.from_numpy(w).requires_grad_()
    with torch.no_grad():
        p.apply(torch.from_numpy(x), wt)
    for _ in range(2):
        wt.grad = None
        (p.apply(torch.from_numpy(x), wt) ** 2).sum().backward()
        assert wt.grad is not None
        np.testing.assert_allclose(wt.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_norm_matches_jax_population_variance():
    from repro.models.cnn import _norm_apply as jnorm
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 5, 4) * 2 + 1).astype(np.float32)
    s, b = rng.rand(4).astype(np.float32), rng.randn(4).astype(np.float32)
    want = np.asarray(jnorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = cnn._norm_apply(torch.from_numpy(x), torch.from_numpy(s),
                          torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,stride", [(3, 2), (2, 2)])
@pytest.mark.parametrize("extent", [13, 14])
def test_same_max_pool_matches_reduce_window(extent, window, stride):
    """The SAME max-pool of both networks on an odd (13x13) and an even
    extent: XLA's padding puts the odd pixel after the image."""
    x = np.random.RandomState(extent).randn(2, extent, extent, 3).astype(
        np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, window, window, 1),
        (1, stride, stride, 1), "SAME"))
    got = cnn.max_pool_same(torch.from_numpy(x), window, stride).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("net", ["smoke", "vgg", "resnet18", "vgg16",
                                 "cifar"])
def test_init_has_the_jax_layout(net):
    """init_* builds JAX's parameter tree (names and shapes) from a torch
    Generator, on the device asked for; the nn.Module holds the same tree
    and its forward is the function's."""
    full = {"resnet18": jconfigs.RESNET18, "vgg16": jconfigs.VGG16,
            "cifar": jconfigs.CIFAR_RESNET18}
    if net in full:
        jcfg = full[net]
        cfg = getattr(configs, {"resnet18": "RESNET18", "vgg16": "VGG16",
                                "cifar": "CIFAR_RESNET18"}[net])
    else:
        jcfg, cfg = _cfgs(net)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jinit = jcnn.init_vgg if cfg.kind == "vgg" else jcnn.init_resnet
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    init = cnn.init_vgg if cfg.kind == "vgg" else cnn.init_resnet
    tp = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == want
    assert all(v.device.type == "cpu" and v.dtype == torch.float32
               for v in _flat(tp).values())
    module = (cnn.VGG if cfg.kind == "vgg" else cnn.ResNet)(cfg, tp)
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want
    if net in ("smoke", "vgg"):
        x = torch.from_numpy(_images(cfg))
        fwd = cnn.vgg_forward if cfg.kind == "vgg" else cnn.resnet_forward
        with torch.no_grad():
            assert torch.equal(module(x), fwd(tp, cfg, x))


def test_config_rejects_an_unregistered_algorithm():
    with pytest.raises(ValueError, match="not registered"):
        dataclasses.replace(configs.SMOKE_CNN, conv_algo="sfc9_9")
    assert configs.RESNET18.stem_kernel == 7 and configs.VGG16.kind == "vgg"
