"""The dry run of the port (``repro_torch.launch.dryrun``,
``launch.dryrun_cnn``, ``launch.mesh.make_production_mesh``) and the
sharded CNN train step.

  * ``make_production_mesh``: (32, 8) over ('data', 'model') and
    (2, 32, 8) over ('pod', 'data', 'model'); a ValueError without that
    many GPUs; meta devices with ``device="meta"``;
  * the bytes each coordinate holds once a cell is placed (the train
    state, the parameters and each decode shape's cache), for all ten
    archs at full width on both production meshes, equal to the bytes
    reckoned from the JAX package's ``params_pspecs``,
    ``opt_state_pspecs`` and ``cache_pspecs`` sanitized on a stand-in
    mesh of the same shape (placing only: no step runs);
  * the bytes a step copies between coordinates, by kind: the dry run on
    meta meshes against ``model_split.copied()`` of the same step on a
    CPU mesh (a meta mesh that stands for one card, as the CPU mesh
    repeats one device), 0 weight bytes on (1, m);
  * the rows alike: the analysis that runs one row of each class and
    replays it equal, coordinate by coordinate, to running every row;
  * a prefill's and a decode step's outputs counted on the coordinates
    that hold them, as JAX's compiled steps place them;
  * the sharded CNN step against the unsharded ``make_train_step`` over
    ``cnn_loss``: bit for bit on (1, 1), else the loss within 1e-5 and
    each gradient leaf within 1e-4 relative L2 (a leaf whose gradient is
    rounding, under 1e-3 of the largest leaf's, within 1e-6 of that);
    CIFAR ResNet-18 with int8 in float64 as well, within 1e-12 and 1e-6;
  * the CNN dry run's FLOPs against ``FlopCounterMode`` over the
    unsharded step: equal on (1, 1), and on data rows apart by exactly
    the FLOPs of measuring each row's transform-domain absmax, cold
    caches or warm.
"""
import dataclasses
import functools
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.distributed import lm_spmd, model_split, sharding  # noqa
from repro_torch.launch import dryrun, dryrun_cnn, hlo_analysis  # noqa
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import build, cnn  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import steps  # noqa: E402

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the production mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    m = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="meta")
    want = {"pod": 2, "data": 32, "model": 8} if multi_pod \
        else {"data": 32, "model": 8}
    assert m.shape == want and m.axis_names == tuple(want)
    assert m.size == (512 if multi_pod else 256)
    assert all(d.type == "meta" for d in m.devices.flat)
    # each coordinate of a meta mesh is a card of its own
    assert len({m.home(c) for c in m.coords()}) == m.size
    if torch.cuda.device_count() < m.size:
        with pytest.raises(ValueError, match="needs"):
            mesh_lib.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError, match="meta"):
        mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_peaks_have_one_owner():
    from repro_torch.api import costmodel
    assert costmodel.PEAK_HBM_BYTES is mesh_lib.HBM_BW
    assert costmodel.PEAK_INT8_OPS is mesh_lib.PEAK_INT8_OPS
    assert (mesh_lib.PEAK_BF16_FLOPS, mesh_lib.HBM_BW, mesh_lib.NVLINK_BW,
            mesh_lib.NET_BW) == (989e12, 3.35e12, 450e9, 50e9)


# --------------------------------------------------------------------------
# the bytes placed, against the JAX package's rules
# --------------------------------------------------------------------------
def _stand_in(multi_pod):
    names = AXES[3] if multi_pod else AXES[2]
    sizes = (2, 32, 8) if multi_pod else (32, 8)
    return types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 axis_names=names)


def _jax_bytes(abstract, pspecs, mesh) -> int:
    """The bytes one device holds of ``abstract`` placed by ``pspecs``,
    each spec sanitized against its leaf: every device holds one block."""
    leaves = jax.tree_util.tree_leaves(abstract)
    specs = jax.tree_util.tree_leaves(
        pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(specs)
    total = 0
    for leaf, spec in zip(leaves, specs):
        spec = jsharding.sanitize_pspec(spec, leaf.shape, mesh)
        cut = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    cut *= mesh.shape[a]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // cut
    return total


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    """The JAX package's abstract train state and each decode shape's
    cache (both meshes share them: only the specs read the mesh)."""
    jm = jbuild(jconfigs.get_config(arch))
    caches = {name: jm.cache_abstract(shape)
              for name, shape in jconfigs.SHAPES.items()
              if shape.kind == "decode" and (arch, name) in configs.cells()}
    return jm, jsteps.abstract_train_state(jm, JAdamW(lr=3e-4)), caches


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_placed_bytes_match_jax_rules(arch, multi_pod):
    stand = _stand_in(multi_pod)
    jm, jstate, jcaches = _jax_abstract(arch)
    jcfg = jm.cfg
    jp = jsharding.params_pspecs(jstate.params, jcfg, stand)
    jspecs = jsteps.TrainState(
        params=jp, opt=jsharding.opt_state_pspecs(jstate.opt, jp),
        rng=jax.sharding.PartitionSpec())
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="meta")
    model = build(configs.get_config(arch))
    for name, shape in configs.SHAPES.items():
        if (arch, name) not in configs.cells():
            continue
        _, _, placed = dryrun.place_cell(model, shape, mesh)
        got = dryrun.placed_bytes(placed)
        assert len(got) == mesh.size
        if shape.kind == "train":
            want = _jax_bytes(jstate, jspecs, stand)
            params = dryrun.placed_bytes(placed.params)
            assert set(params.values()) == {
                _jax_bytes(jstate.params, jp, stand)}
        elif shape.kind == "prefill":
            want = _jax_bytes(jstate.params, jp, stand)
        else:
            jcache = jcaches[name]
            want = _jax_bytes(jstate.params, jp, stand) + _jax_bytes(
                jcache, jsharding.cache_pspecs(jcache, jcfg, stand), stand)
        assert set(got.values()) == {want}, (name, set(got.values()), want)


# --------------------------------------------------------------------------
# copies between coordinates, against a CPU mesh
# --------------------------------------------------------------------------
B, S = 4, 16


def _batch(cfg, device, batch=B):
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (batch, S), generator=g,
                        dtype=torch.int32)
    out = {"tokens": tok, "labels": tok}
    if cfg.family == "vlm":
        out["vision"] = torch.randn(batch, cfg.n_vision_tokens,
                                    cfg.d_model, generator=g)
    if cfg.family == "encdec":
        out["frames"] = torch.randn(batch, S, cfg.d_model, generator=g)
    return {k: v.to(device) for k, v in out.items()}


def _meta_mesh(shape, one_card=False):
    return mesh_lib.make_forced_host_mesh(shape, AXES[len(shape)],
                                          device="meta", one_card=one_card)


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-3b", (2, 2)), ("stablelm-3b", (1, 4)),
    ("stablelm-3b", (2, 1, 2)), ("mixtral-8x7b", (2, 2)),
    ("mamba2-1.3b", (1, 4)), ("mamba2-1.3b", (2, 1, 2))])
def test_copies_on_meta_match_cpu_mesh(arch, shape):
    cfg = configs.get_smoke_config(arch)
    model, opt = build(cfg), AdamW(lr=1e-3)
    step = steps.make_train_step(model, opt)
    cpu = mesh_lib.make_forced_host_mesh(shape, AXES[len(shape)],
                                         device="cpu")
    state = steps.init_train_state(
        model, opt, 0, "cpu", shardings=lm_spmd.state_shardings(
            model, opt, cpu))
    model_split.reset_copied()
    step(state, _batch(cfg, "cpu"))
    want = model_split.copied()
    got = {}
    for one_card in (True, False):
        meta = _meta_mesh(shape, one_card)
        placed = sharding.place(steps.abstract_train_state(model, opt),
                                lm_spmd.state_shardings(model, opt, meta))
        _, s = hlo_analysis.analyze(step, placed, _batch(cfg, "meta"),
                                    mesh=meta)
        got[one_card] = s.copied
    assert got[True] == want
    if shape[-2] == 1:                       # one data row
        assert want["weights"] == 0
    # a card a coordinate recomputes whole layers in the backward, which
    # sends their activations again; it fetches and reduces the same
    assert got[False]["weights"] == want["weights"]
    assert got[False]["gradients"] == want["gradients"]
    assert got[False]["activations"] >= want["activations"]


# --------------------------------------------------------------------------
# rows alike: one row run and replayed, against every row run
# --------------------------------------------------------------------------
def _per_coord(s):
    return {c: (st.flops, st.traffic, st.args, st.peak,
                tuple(st.recv.values()), tuple(st.counts.values()),
                tuple(st.sent_link.values()), tuple(st.recv_link.values()))
            for c, st in s.per_coord.items()}


@functools.lru_cache(maxsize=None)
def _warm(arch, kind):
    """One step of ``arch``'s ``kind`` on a (4, 2) meta mesh, run once
    whichever test asks first: it fills the tables a step caches on the
    meta device, which both meshes' rows (batch 2 a row) read alike, so
    that every analysis of the cell sees them warm."""
    step, args, _ = dryrun.place_cell(
        build(configs.get_smoke_config(arch)),
        configs.ShapeConfig("smoke", S, 8, kind), _meta_mesh((4, 2)))
    step(*args)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch,kind", [
    ("stablelm-3b", "train"), ("mixtral-8x7b", "train"),
    ("mamba2-1.3b", "train"), ("stablelm-3b", "prefill"),
    ("mixtral-8x7b", "decode")])
def test_rows_alike_equal_every_row(arch, shape, kind):
    cfg = configs.get_smoke_config(arch)
    model = build(cfg)
    mesh = _meta_mesh(shape)
    step, args, _ = dryrun.place_cell(
        model, configs.ShapeConfig("smoke", S, 8, kind), mesh)
    _warm(arch, kind)
    _, every = hlo_analysis.analyze(step, *args, mesh=mesh)
    _, alike = hlo_analysis.analyze(step, *args, mesh=mesh, rows_alike=True)
    assert _per_coord(alike) == _per_coord(every)
    assert alike.copied == every.copied
    assert alike.dot_flops_by_site == every.dot_flops_by_site


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_outputs_counted_where_they_lie(kind, batch):
    """A prefill and a decode cell on a (2, 4) meta mesh: the bytes each
    coordinate holds of the step's outputs equal the placement's
    reckoning (the logits' batch over 'data' and vocab over 'model', the
    next tokens' batch over 'data'; at a batch 'data' does not divide,
    computed by the first row and held by every coordinate), and so do
    the bytes copied to place them (the next tokens along 'model', the
    first row's blocks along 'data')."""
    cfg = configs.get_smoke_config("stablelm-3b")
    model = build(cfg)
    mesh = _meta_mesh((2, 4))
    step, args, _ = dryrun.place_cell(
        model, configs.ShapeConfig("smoke", S, batch, kind), mesh)
    result, s = hlo_analysis.analyze(step, *args, mesh=mesh)
    D, M, V = 2, 4, cfg.padded_vocab
    b = batch // D if batch % D == 0 else batch
    logits = b * (S if kind == "prefill" else 1) * V // M * 4
    tokens = b * 4 if kind == "decode" else 0
    got = dryrun._outputs(result, args)
    assert got == {c: logits + tokens for c in mesh.coords()}
    assert dryrun.record(s, got)["memory"]["output_size_in_bytes"] \
        == logits + tokens
    if batch % D == 0:
        want = D * (M - 1) * tokens
    else:
        want = (D - 1) * M * logits + (D * M - 1) * tokens
    assert s.copied["outputs"] == want


def test_record_of_a_cell():
    cfg = dataclasses.replace(configs.get_smoke_config("stablelm-3b"),
                              n_layers=2)
    rec = dryrun.lower_cell("stablelm-3b",
                            configs.ShapeConfig("smoke", S, 8, "train"),
                            False, mesh=_meta_mesh((4, 2)), cfg=cfg)
    assert rec["mesh"] == "4x2" and rec["n_chips"] == 8
    assert rec["model_flops"] == 6.0 * cfg.active_param_count() * S * 8
    mem = rec["memory"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["fits"] is True
    assert rec["la_flops"] >= rec["la_mean"]["flops"] > 0
    assert rec["t_compute_ms"] == rec["la_flops"] / 989e12 * 1e3
    assert rec["bound_by"] in ("compute", "memory", "nvlink", "network")
    assert rec["card"] == mesh_lib.CARD


# --------------------------------------------------------------------------
# the sharded CNN step
# --------------------------------------------------------------------------
class _Loss:
    def __init__(self, cfg):
        self.cfg = cfg

    def loss(self, params, batch):
        return cnn.cnn_loss(params, self.cfg, batch)


def _cnn_case(base, algo, batch, dtype=torch.float32):
    cfg = dataclasses.replace(base, conv_algo=algo,
                              quant="int8" if algo != "direct" else "none")
    g = torch.Generator().manual_seed(0)
    init = cnn.init_vgg if cfg.kind == "vgg" else cnn.init_resnet
    params = tree_util.tree_map(lambda t: t.to(dtype), init(g, cfg, "cpu"))
    data = {"images": torch.randn(batch, cfg.image_size, cfg.image_size, 3,
                                  generator=g).to(dtype),
            "labels": torch.randint(0, cfg.n_classes, (batch,),
                                    generator=g, dtype=torch.int32)}
    return cfg, params, data


class _Kept(AdamW):
    """AdamW that keeps the gradients the step hands it."""

    def apply(self, params, grads, state):
        self.grads = grads
        return super().apply(params, grads, state)


@functools.lru_cache(maxsize=None)
def _cnn_reference(name, algo, batch, dtype=torch.float32):
    """The unsharded ``make_train_step`` over ``cnn_loss``: its loss, the
    gradients it applied and the parameters after it."""
    base = {"smoke": configs.SMOKE_CNN,
            "cifar": configs.CIFAR_RESNET18}[name]
    cfg, params, data = _cnn_case(base, algo, batch, dtype)
    opt = _Kept(lr=1e-3)
    state = steps.TrainState(params, opt.init(params), torch.tensor(0))
    new, metrics = steps.make_train_step(_Loss(cfg), opt)(state, data)
    return cfg, params, data, metrics["loss"], opt.grads, new.params


def _leaf_rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


CNN_MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
# CIFAR ResNet-18 with int8 in float32 is held on (1, 1) only.  Split over
# rows or C_out blocks, its sums and products round apart from the
# unsharded ones (1e-7); an element that moves across a rounding edge of
# the int8 grid moves by a whole step, and one that overtakes the absmax
# takes the scale's gradient: the loss ends 2.7e-4 apart on (2, 1) at
# batch 4, a norm's gradient 0.4.  In float64 those moves vanish and the
# same step on every mesh is the unsharded one to the float32 rounding of
# the gradients it returns (3e-8, the loss equal): CIFAR_F64's bounds.
CNN_CASES = [(n, a, b, m, torch.float32) for n, a, b in [
    ("smoke", "sfc6_7", 8), ("smoke", "direct", 8), ("cifar", "direct", 4),
    ("cifar", "sfc6_7", 2)] for m in CNN_MESHES
    if not (n == "cifar" and a == "sfc6_7" and m != (1, 1))] + [
    ("cifar", "sfc6_7", 2, m, torch.float64) for m in CNN_MESHES[1:]]
CIFAR_F64 = (1e-12, 1e-6)


@pytest.mark.parametrize("name,algo,batch,shape,dtype", CNN_CASES)
def test_sharded_cnn_step(name, algo, batch, shape, dtype):
    cfg, params, data, ref_loss, ref_grads, ref_params = _cnn_reference(
        name, algo, batch, dtype)
    opt = AdamW(lr=1e-3)
    mesh = mesh_lib.make_forced_host_mesh(shape, device="cpu")
    state = dryrun_cnn.place_state(cfg, opt, mesh, params)
    loss, _, leaves = dryrun_cnn.value_and_grad(cfg, state.params, data)
    got = dict(sharding._with_paths(lm_spmd.gradients(leaves)))
    want = dict(sharding._with_paths(ref_grads))
    assert set(got) == set(want)
    if shape == (1, 1):
        # train_step's update, from these gradients
        new, _ = lm_spmd.apply_gradients(opt, state, leaves, {})
        new_p = dict(sharding._with_paths(new.params))
        want_p = dict(sharding._with_paths(ref_params))
        assert torch.equal(loss, ref_loss)
        assert all(torch.equal(got[k].gather(), want[k]) for k in want)
        assert all(torch.equal(new_p[k].gather(), want_p[k]) for k in want)
        return
    loss_tol, leaf_tol = CIFAR_F64 if dtype == torch.float64 \
        else (1e-5, 1e-4)
    assert abs(float(loss) - float(ref_loss)) \
        <= loss_tol * abs(float(ref_loss))
    top = max(float(torch.linalg.norm(g)) for g in want.values())
    for k, g in want.items():
        g = g.to(torch.float32)
        n = float(torch.linalg.norm(g))
        if n > 1e-3 * top:
            assert _leaf_rel(got[k].gather(), g) <= leaf_tol, k
        else:
            assert float(torch.linalg.norm(got[k].gather() - g)) \
                <= 1e-6 * top, k


class _Convs(cnn.Ops):
    """The plain operations, noting each quantized conv's input."""

    def __init__(self):
        self.quantized = []

    def conv(self, h, p, cfg, stride, qhook):
        if qhook is not None:
            self.quantized.append((tuple(h.shape), tuple(p["w"].shape),
                                   stride, h.requires_grad))
        return super().conv(h, p, cfg, stride, qhook)


@functools.lru_cache(maxsize=None)
def _unsharded_flops(cfg, batch):
    """FlopCounterMode's FLOPs of the unsharded train step over
    ``cnn_loss`` on meta, and the quantized convs' (input, weight,
    stride, whether the input takes a gradient)."""
    from torch.utils.flop_counter import FlopCounterMode
    ops, opt = _Convs(), AdamW(lr=1e-3)

    class Loss:
        def loss(self, params, b):
            return cnn.cnn_loss(params, cfg, b, ops=ops)
    params = cnn.init_abstract(cfg)
    state = steps.TrainState(params, opt.init(params),
                             torch.empty((), dtype=torch.int64,
                                         device="meta"))
    data = {"images": torch.empty(batch, cfg.image_size, cfg.image_size, 3,
                                  device="meta"),
            "labels": torch.empty(batch, dtype=torch.int32, device="meta")}
    with FlopCounterMode(display=False) as fc:
        steps.make_train_step(Loss(), opt)(state, data)
    return fc.get_total_flops(), tuple(ops.quantized)


@functools.lru_cache(maxsize=None)
def _absmax_flops(cfg, convs):
    """The FLOPs of measuring the transform-domain absmax of each
    quantized conv's input, forward, and backward where the input takes
    a gradient (not the images): the sharded step's global activation
    scales."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.api import ConvSpec, plan
    total = 0
    for x_shape, w_shape, stride, grad in convs:
        x = torch.empty(x_shape, device="meta", requires_grad=grad)
        p = plan(ConvSpec.for_conv2d(x_shape, w_shape, stride=stride,
                                     padding="SAME"),
                 backend="reference", algo=cfg.conv_algo)
        with FlopCounterMode(display=False) as fc:
            amaxes = dryrun_cnn._amaxes(p, x, cfg.act_granularity)
            if grad:
                torch.autograd.grad(sum(a.sum() for a in amaxes), x)
        total += fc.get_total_flops()
    return total


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
@pytest.mark.parametrize("model,algo", [
    ("resnet18", "sfc6_7"), ("vgg16", "sfc6_7"), ("resnet18", "direct")])
def test_cnn_dry_run_flops(model, algo, shape):
    """Cold: the transform matrices are built inside the analysis, and a
    table cached there must not draw the operations that read it to the
    mesh's first coordinate (they did: ResNet-18 sfc6_7 on 32x8 read 29.7
    TFLOP at (0, 0), against 0.15)."""
    from repro_torch.core import conv2d as c2d
    per_row = 1
    cfg = dryrun_cnn.cnn_config(model, algo)
    want, convs = _unsharded_flops(cfg, per_row)
    if shape[0] > 1:
        want += _absmax_flops(cfg, convs)
    assert bool(convs) == (algo != "direct")
    c2d._matrices.cache_clear()
    rec = dryrun_cnn.lower_cnn(model, algo, False, mesh=_meta_mesh(shape),
                               cfg=cfg, batch=per_row * shape[0])
    assert rec["la_flops"] == rec["la_mean"]["flops"] == want


def test_cnn_param_pspec():
    mesh = _meta_mesh((2, 4))
    p = cnn.init_abstract(configs.RESNET18)
    specs = dict(sharding._with_paths(sharding.tree_map_with_path(
        lambda path, leaf: dryrun_cnn.cnn_param_pspec(path, leaf, mesh), p)))
    assert specs[("stem", "w")] == sharding.P(None, None, None, "model")
    assert specs[("head", "w")] == sharding.P(None, "model")
    assert specs[("stem", "scale")] == sharding.P(None)
    # a C_out the axis does not divide stays whole
    odd = torch.empty(3, 3, 8, 6, device="meta")
    assert dryrun_cnn.cnn_param_pspec(("w",), odd, mesh) \
        == sharding.P(None, None, None, None)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1, 2)])
def test_cnn_dry_run_copies_match_cpu_mesh(shape):
    cfg, params, data = _cnn_case(configs.SMOKE_CNN, "sfc6_7", 8)
    opt = AdamW(lr=1e-3)
    cpu = mesh_lib.make_forced_host_mesh(shape, AXES[len(shape)],
                                         device="cpu")
    model_split.reset_copied()
    dryrun_cnn.train_step(cfg, opt, dryrun_cnn.place_state(cfg, opt, cpu,
                                                           params), data)
    want = model_split.copied()
    rec = dryrun_cnn.lower_cnn("smoke", "sfc6_7", False,
                               mesh=_meta_mesh(shape), cfg=cfg, batch=8)
    assert rec["copied"] == want
    # each conv block computes where it lies: no weight byte moves
    assert want["weights"] == 0 and want["gradients"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["la_flops"] > 0 and rec["shape"] == "train_b8"


def test_fused_double_buffer_same_bits():
    """The JAX flag's two-slot strip DMA is what B4 always does: either
    value runs the same kernel (its plain version on the CPU), with the
    same bits."""
    from repro_torch.api import registry
    from repro_torch.kernels import sfc_fused_conv2d
    algo = registry.get_algorithm("sfc6_7")
    g = torch.Generator().manual_seed(5)
    t = algo.t
    x = torch.randn(2, 14, 14, 8, generator=g)
    wq = torch.randint(-127, 128, (t * t, 8, 16), generator=g,
                       dtype=torch.int8)
    act = torch.rand(t, t, generator=g) + 0.5
    ws = torch.rand(t, t, 16, generator=g) * 1e-2
    assert torch.equal(
        sfc_fused_conv2d(x, wq, act, ws, algo, double_buffer=True),
        sfc_fused_conv2d(x, wq, act, ws, algo, double_buffer=False))
