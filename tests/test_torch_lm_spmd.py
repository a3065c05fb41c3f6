"""The sharded LM train step (``repro_torch.distributed.lm_spmd``)
against the JAX package's single-device step, and the sharded state
through the ``Trainer`` and its checkpoints (elastic restore).

For a data axis of n, the JAX reference runs ``value_and_grad(
model.loss)`` and ``AdamW.apply`` on one device with
``repro.distributed.act_sharding.data_shards`` monkeypatched to return
n: the JAX package's own shard-local MoE semantics (capacity per shard,
the aux loss over all tokens) on one device.  Smoke configs in fp32 on
CPU meshes (1, 1), (2, 1), (1, 2), (2, 2), (4, 1) and (1, 4), batch
4 x 16, each step run with every whole gather of a leaf that ``'model'``
cuts made to raise (each weight block computes where it lies):

  * the loss within 1e-5 relative; each leaf's gradient within 1e-4 rel
    L2 (a leaf zero in exact arithmetic within 1e-6 of the largest max
    |g|); the parameters after one AdamW step within 1e-5 rel L2.  The
    step's learning rate is 1e-4: AdamW's first update is g / (|g| +
    eps), which turns the gradients' rounding differences on elements of
    small |g| into update differences in proportion to the learning rate
    (at 1e-3, deepseek-v3's MTP router moves 1.15e-5 rel L2 apart on
    (4, 1), its gradients 8.5e-7 apart);
  * every block on its coordinate's device with the spec's shape;
  * the weight bytes the step copies exactly the all-gather over the
    data axes of every data-cut leaf, once a fetch (a rematerialised
    layer's twice): 0 on one data row;
  * on (1, 1) the loss and gradients bit for bit the port's
    single-device step's, on (1, m) within the bounds above of it (the
    row blocks' partial sums come in another order);
  * two runs of a step bit for bit alike; ``microbatches=2`` against
    JAX's ``make_train_step(microbatches=2)`` ((1, 1): the port's
    unsharded microbatched step bit for bit); ``grad_compression=True``
    within one int8 step (1.01 max |g| / 127) of the uncompressed
    gradients, bit for bit across runs and, on (1, 1), the unsharded
    compressed step's.

The dense, ssm and hybrid families are held here (with the Trainer and
checkpoint tests), the moe, vlm and encdec families in
``test_torch_lm_spmd_families.py``.
"""
import contextlib
import dataclasses
import functools
import gc
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.distributed import act_sharding as jacts  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.api import serving_cache  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.distributed import (lm_spmd, model_split,  # noqa: E402
                                     sharding)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_forced_host_mesh  # noqa: E402
from repro_torch.models import build, transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim import grad_compression as gcomp  # noqa: E402
from repro_torch.train import (TrainState, Trainer,  # noqa: E402
                               TrainerConfig, TransientError,
                               abstract_train_state, init_train_state,
                               make_train_step)
from repro_torch.train.steps import _value_and_grad  # noqa: E402

MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4))
LR = 1e-4
LOSS_REL = 1e-5
LEAF_REL = 1e-4
DEAD = 1e-6
UPDATE_REL = 1e-5
GATES = {"gate": 0.5, "ffn_gate": -0.7}
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated():
    serving_cache.clear()
    yield
    serving_cache.clear()
    transformer.clear_compute_cache()


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _arrays(cfg, batch=B, seed=0):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (batch, S)).astype(
               np.int32),
           "labels": rng.randint(0, cfg.vocab_size, (batch, S)).astype(
               np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.randn(batch, cfg.n_vision_tokens,
                                  cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.randn(batch, S, cfg.d_model).astype(np.float32)
    return out


def _cfgs(arch):
    kw = {"compute_dtype": "float32"}
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg, _ = _cfgs(arch)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        cross = jp["cross_blocks"]
        cross["xattn"]["gate"] = jnp.full_like(cross["xattn"]["gate"],
                                               GATES["gate"])
        cross["ffn_gate"] = jnp.full_like(cross["ffn_gate"],
                                          GATES["ffn_gate"])
    return jp


@functools.lru_cache(maxsize=None)
def jax_step(arch, n, batch=B):
    """JAX's single-device loss, gradients and AdamW step with
    ``data_shards`` = n, as numpy."""
    jcfg, cfg = _cfgs(arch)
    jm, jp = jbuild(jcfg), _jax_params(arch)
    jb = {k: jnp.asarray(v) for k, v in _arrays(cfg, batch).items()}
    orig = jacts.data_shards
    jacts.data_shards = lambda: n
    try:
        (loss, _), g = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            jp, jb)
    finally:
        jacts.data_shards = orig
    opt = JAdamW(lr=LR)
    new, _, _ = opt.apply(jp, g, opt.init(jp))
    as_np = lambda t: [np.asarray(a) for a in                # noqa: E731
                       jax.tree_util.tree_leaves(t)]
    names = ["/".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(g)]
    return float(loss), names, as_np(g), as_np(new)


def placed_state(arch, shape):
    """The JAX parameters placed on a CPU mesh of ``shape`` by the port's
    state shardings, with fresh moments."""
    _, cfg = _cfgs(arch)
    model, opt = build(cfg), AdamW(lr=LR)
    params = params_from_numpy(_jax_params(arch), "cpu")
    mesh = make_forced_host_mesh(shape, device="cpu")
    shardings = lm_spmd.state_shardings(model, opt, mesh)
    state = TrainState(params, opt.init(params),
                       torch.tensor(0, dtype=torch.int64))
    return model, opt, mesh, shardings, sharding.place(state, shardings)


def check_placement(state, shardings):
    """Each block on its coordinate's device with the spec's shape."""
    for sh, s in zip(tree_util.leaves(state), tree_util.leaves(shardings)):
        assert tuple(sh.spec) == tuple(s.spec)
        for coord in s.mesh.coords():
            block = sh.shards[coord]
            assert block.device == s.mesh.device(coord)
            want = sharding.block_of(torch.empty(sh.shape, device="meta"),
                                     sh.spec, s.mesh, sh.block_index(coord))
            assert tuple(block.shape) == tuple(want.shape)


@contextlib.contextmanager
def no_whole_gathers():
    """Every whole gather of a leaf that ``'model'`` cuts into more than
    one block raises inside (``Sharded.gather`` and ``_Leaf.gather``)."""
    def guarded(orig, sharded):
        def gather(self, *args, **kwargs):
            sh = sharded(self)
            if sh.mesh.shape["model"] > 1 and any(
                    "model" in sharding._axes(e) for e in sh.spec):
                raise AssertionError(f"a model-split leaf gathered whole: "
                                     f"{sh}")
            return orig(self, *args, **kwargs)
        return gather
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model_split._Leaf, "gather",
                   guarded(model_split._Leaf.gather, lambda leaf: leaf.sh))
        mp.setattr(sharding.Sharded, "gather",
                   guarded(sharding.Sharded.gather, lambda sh: sh))
        yield


# the stacks a train step rematerialises (their layers fetched twice)
REMAT_STACKS = ("blocks", "dense_blocks", "cross_blocks")


def reckoned(params, mesh, batch, chunks=1) -> int:
    """The weight bytes a sharded train step copies: each row that
    computes a chunk (every data row where they divide it, else the
    first) gathers over the data axes (D - 1) / D of every leaf whose
    spec names ``'data'``, once a fetch; a rematerialised stack's layers
    are fetched again in the backward."""
    D = mesh.shape["data"]
    rows = D if (batch // chunks) % D == 0 else 1
    total = 0
    for path, sh in tree_util.flatten_with_path(params):
        if any("data" in sharding._axes(e) for e in sh.spec):
            nbytes = int(np.prod(sh.shape)) * sh.shards.flat[0].element_size()
            fetches = 2 if path[0] in REMAT_STACKS else 1
            total += chunks * rows * fetches * nbytes * (D - 1) // D
    return total


def _leaves_close(got, want, name=""):
    """Each gradient leaf within LEAF_REL rel L2, a leaf zero in exact
    arithmetic within DEAD of the largest max |g|."""
    gmax = max(np.abs(g).max() for g in want)
    for i, (a, b) in enumerate(zip(got, want)):
        if np.abs(b).max() <= DEAD * gmax:
            assert np.abs(a - b).max() <= DEAD * gmax, (name, i)
        else:
            assert _rel_l2(a, b) <= LEAF_REL, (name, i, _rel_l2(a, b))


def check_against_jax(arch, shape, batch=B):
    model, opt, mesh, shardings, state = placed_state(arch, shape)
    check_placement(state, shardings)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg, batch).items()}
    model_split.reset_copied()
    with no_whole_gathers():
        loss, _, leaves = lm_spmd.value_and_grad(model, state.params, b)
    assert model_split.copied()["weights"] == reckoned(state.params, mesh,
                                                   batch)
    grads = [g.gather() for g in tree_util.leaves(
        lm_spmd.gradients(leaves))]
    with no_whole_gathers():
        new, metrics = make_train_step(model, opt)(state, b)
    check_placement(new, shardings)
    # data_shards reaches only the MoE dispatch: the other families share
    # one reference across the data axes
    n = shape[0] if cfg.n_experts else 1
    jloss, names, jg, jnew = jax_step(arch, n, batch)
    assert abs(float(loss) - jloss) <= LOSS_REL * abs(jloss)
    assert float(metrics["loss"]) == float(loss)
    gmax = max(np.abs(g).max() for g in jg)
    for name, got, want in zip(names, grads, jg):
        if np.abs(want).max() <= DEAD * gmax:
            assert np.abs(got.numpy() - want).max() <= DEAD * gmax, name
        else:
            assert _rel_l2(got.numpy(), want) <= LEAF_REL, \
                (name, _rel_l2(got.numpy(), want))
    for name, got, want in zip(names, tree_util.leaves(new.params), jnew):
        assert _rel_l2(got.gather().numpy(), want) <= UPDATE_REL, \
            (name, _rel_l2(got.gather().numpy(), want))
    assert int(new.opt.step.gather()) == 1


def check_bitwise_one_row(arch, shape):
    """A mesh of one data row against the port's single-device step: on
    (1, 1) the loss and gradients bit for bit; on (1, m), where the row
    blocks' partial sums come in another order, within LOSS_REL and
    LEAF_REL."""
    model, _, _, _, state = placed_state(arch, shape)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg).items()}
    params = params_from_numpy(_jax_params(arch), "cpu")
    loss1, _, g1 = _value_and_grad(model, params, b)
    loss, _, leaves = lm_spmd.value_and_grad(model, state.params, b)
    got = [g.gather() for g in tree_util.leaves(lm_spmd.gradients(leaves))]
    want = tree_util.leaves(g1)
    if shape == (1, 1):
        assert torch.equal(loss, loss1)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        return
    assert abs(float(loss) - float(loss1)) <= LOSS_REL * abs(float(loss1))
    _leaves_close([a.numpy() for a in got], [w.numpy() for w in want], arch)


ARCHS = ("qwen3-14b", "mamba2-1.3b", "zamba2-1.2b")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(arch, shape):
    check_against_jax(arch, shape)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_data_row_is_bitwise_single_device(arch, shape):
    check_bitwise_one_row(arch, shape)


def test_fresh_sharded_state_is_the_unsharded_init():
    """``init_train_state(..., shardings=)`` draws the unsharded init's
    values, each block owning its memory, one copy a device."""
    _, cfg = _cfgs("zamba2-1.2b")
    model, opt = build(cfg), AdamW(lr=LR)
    mesh = make_forced_host_mesh((2, 2), device="cpu")
    shardings = lm_spmd.state_shardings(model, opt, mesh)
    state = init_train_state(model, opt, 3, "cpu", shardings=shardings)
    ref = init_train_state(model, opt, 3, "cpu")
    check_placement(state, shardings)
    for got, want in zip(tree_util.leaves(state), tree_util.leaves(ref)):
        assert torch.equal(got.gather(), want)
    # K is replicated over the model axis: one copy on the one device
    wk = state.params["shared_block"]["attn"]["wk"]
    assert tuple(wk.spec) == ("data", None, None)
    assert wk.shards[0, 0] is wk.shards[0, 1]
    assert wk.shards[0, 0] is not wk.shards[1, 0]
    storages = {sh.shards[c].untyped_storage().data_ptr()
                for sh in tree_util.leaves(state.params)
                for c in mesh.coords()}
    assert len(storages) >= len(tree_util.leaves(state.params))


def test_init_train_state_keeps_no_drawn_layer(monkeypatch):
    """``init_train_state(..., shardings=)`` on (2, 2): a stack keeps only
    its first drawn layer's structure (meta tensors), never its tensors,
    once the layer is placed; the state is the unsharded init's."""
    _, cfg = _cfgs("mixtral-8x7b")
    model, opt = build(cfg), AdamW(lr=LR)
    mesh = make_forced_host_mesh((2, 2), device="cpu")
    kept = []
    add = lm_spmd._StackSink.add

    def spy(self, i, layer):
        add(self, i, layer)
        kept.extend(a.device.type for a in tree_util.leaves(self.like))
    monkeypatch.setattr(lm_spmd._StackSink, "add", spy)
    state = init_train_state(model, opt, 5, "cpu",
                             shardings=lm_spmd.state_shardings(model, opt,
                                                               mesh))
    assert kept and set(kept) == {"meta"}
    ref = init_train_state(model, opt, 5, "cpu")
    for got, want in zip(tree_util.leaves(state.params),
                         tree_util.leaves(ref.params)):
        assert torch.equal(got.gather(), want)


def test_threadsafe_checkpoint_recomputes_once():
    """``transformer.checkpoint_threadsafe``: a layer's saved tensors,
    unpacked by several threads at once (as autograd's device threads
    unpack a layer whose blocks lie on several cards), come from one
    recomputation; the gradients are the plain layer's bit for bit."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(16, 16, generator=gen, requires_grad=True)
    x = torch.randn(4, 16, generator=gen, requires_grad=True)
    calls = []

    def layer(a):
        calls.append(1)
        return torch.tanh(a @ w) @ w.T * torch.sigmoid(a)

    frame = transformer._Frame(layer, (x,))
    with torch.autograd.graph.saved_tensors_hooks(frame.pack, frame.unpack):
        layer(x)
    assert frame.count > 2 and len(calls) == 1
    start = threading.Barrier(frame.count)
    got = [None] * frame.count

    def unpack(i):
        start.wait()
        got[i] = frame.unpack(i)
    threads = [threading.Thread(target=unpack, args=(i,))
               for i in range(frame.count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 2 and all(g is not None for g in got)
    y = transformer.checkpoint_threadsafe(layer, x)
    gx, gw = torch.autograd.grad(y.sum(), [x, w])
    rx, rw = torch.autograd.grad(layer(x).sum(), [x, w])
    assert torch.equal(gx, rx) and torch.equal(gw, rw)


@pytest.mark.parametrize("devices", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-1.2b"])
def test_sharded_step_keeps_nothing_alive(arch, devices, monkeypatch):
    """After a sharded step's gradients are dropped, no row, no leaf's
    gradient blocks and no tensor of its graph outlive it: nothing in the
    fetches, the rows or the rematerialised layers holds its own graph
    (a cycle through autograd's nodes that Python's collector cannot
    free, a whole gradient a step).  ``devices`` 2: each row's layers
    rematerialised as where its blocks lie on two cards
    (``transformer.checkpoint_threadsafe``)."""
    monkeypatch.setattr(model_split.Forward, "_devices",
                        lambda self: devices)
    model, _, _, _, state = placed_state(arch, (1, 2))
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg).items()}

    def alive():
        gc.collect()
        objs = gc.get_objects()
        return (sum(isinstance(o, model_split._Row) for o in objs),
                sum(isinstance(o, model_split._Leaf) for o in objs),
                sum(isinstance(o, torch.Tensor) for o in objs))
    before = None
    for _ in range(3):
        out = lm_spmd.value_and_grad(model, state.params, b)
        del out
        # the first step fills one-time caches (RoPE's frequencies)
        now = alive()
        assert now[:2] == (0, 0) and now == (before or now)
        before = now


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_sharded_remat_follows_the_policy(shape, monkeypatch):
    """The sharded step's layers: on a row whose blocks lie on one device,
    ``torch.utils.checkpoint`` under ``REPRO_TORCH_REMAT_POLICY`` (with
    ``dots``, the products' outputs saved); where they lie on several,
    ``transformer.checkpoint_threadsafe`` (full remat); the gradients of
    all three bit for bit alike."""
    arch = "qwen3-14b"
    model, _, _, _, state = placed_state(arch, shape)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg).items()}
    saved, routes = [], []
    save_dots, threadsafe = transformer._save_dots, \
        transformer.checkpoint_threadsafe

    def spy_dots(ctx, op, *args, **kwargs):
        out = save_dots(ctx, op, *args, **kwargs)
        saved.append(out == transformer.ckpt.CheckpointPolicy.MUST_SAVE)
        return out

    def spy_threadsafe(fn, *args):
        routes.append("threadsafe")
        return threadsafe(fn, *args)
    monkeypatch.setattr(transformer, "_save_dots", spy_dots)
    monkeypatch.setattr(transformer, "checkpoint_threadsafe",
                        spy_threadsafe)

    def grads(policy, devices):
        monkeypatch.setenv(transformer.REMAT_POLICY_ENV, policy)
        monkeypatch.setattr(model_split.Forward, "_devices",
                            lambda self: devices)
        _, _, leaves = lm_spmd.value_and_grad(model, state.params, b)
        return [g.gather() for g in tree_util.leaves(
            lm_spmd.gradients(leaves))]
    full = grads("full", 1)
    assert not saved and not routes
    dots = grads("dots", 1)
    assert any(saved) and not routes
    saved.clear()
    several = grads("dots", 2)
    assert not saved and routes
    for ref in (dots, several):
        assert all(torch.equal(x, y) for x, y in zip(full, ref))


def _step_bits(model, opt, state, b, **kw):
    """One sharded step's loss, gradients (compressed with
    ``grad_compression``), new parameters (on the host) and metrics: the
    step ``make_train_step`` takes over a placed state, its gradients and
    update run with every whole gather of a model-split leaf refused."""
    with no_whole_gathers():
        loss, metrics, leaves = lm_spmd.value_and_grad(
            model, state.params, b, kw.get("microbatches", 1))
        if kw.get("grad_compression"):
            lm_spmd.compress(leaves)
        new, metrics = lm_spmd.apply_gradients(opt, state, leaves, metrics)
    grads = [g.gather() for g in tree_util.leaves(
        lm_spmd.gradients(leaves))]
    return (loss, grads, [p.gather() for p in tree_util.leaves(new.params)],
            metrics)


def check_train_step(model, opt, state, b, new, **kw):
    """``make_train_step(model, opt, **kw)`` over the placed state runs,
    refusing whole gathers, and updates it to ``new`` bit for bit."""
    with no_whole_gathers():
        got, _ = make_train_step(model, opt, **kw)(state, b)
    assert all(torch.equal(p.gather(), w) for p, w in
               zip(tree_util.leaves(got.params), new))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mixtral-8x7b",
                                  "deepseek-v3-671b"])
def test_sharded_train_step_replays_bit_for_bit(arch, shape):
    """Two runs of the sharded step from one state: the loss, every
    gradient block and every updated parameter bit for bit (partial sums
    in block order, each fanned-out tensor's gradients in one order, no
    atomics)."""
    model, opt, _, _, state = placed_state(arch, shape)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg).items()}
    (la, ga, pa, _), (lb, gb, pb, _) = (_step_bits(model, opt, state, b)
                                        for _ in range(2))
    check_train_step(model, opt, state, b, pa)
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


@functools.lru_cache(maxsize=None)
def jax_microbatched(arch, n, mb=2):
    """JAX's ``make_train_step(microbatches=mb)`` with ``data_shards`` =
    n: the loss and new parameters, and the chunks' mean gradients."""
    jcfg, cfg = _cfgs(arch)
    jm, jp = jbuild(jcfg), _jax_params(arch)
    jb = {k: jnp.asarray(v) for k, v in _arrays(cfg).items()}
    opt = JAdamW(lr=LR)
    orig = jacts.data_shards
    jacts.data_shards = lambda: n
    try:
        state = jsteps.TrainState(jp, opt.init(jp), jax.random.PRNGKey(1))
        new, metrics = jax.jit(jsteps.make_train_step(
            jm, opt, microbatches=mb))(state, jb)
        vg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
        grads = None
        for i in range(mb):
            chunk = {k: v[i * B // mb:(i + 1) * B // mb]
                     for k, v in jb.items()}
            _, g = vg(jp, chunk)
            g = [np.asarray(a, np.float32)
                 for a in jax.tree_util.tree_leaves(g)]
            grads = g if grads is None else [a + c for a, c in
                                             zip(grads, g)]
    finally:
        jacts.data_shards = orig
    return (float(metrics["loss"]), [g / mb for g in grads],
            [np.asarray(a) for a in jax.tree_util.tree_leaves(new.params)])


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b"])
def test_microbatched_sharded_step_matches_jax(arch, shape):
    """``make_train_step(..., microbatches=2)`` over a placed state: each
    chunk split over the data rows (batch 4: chunks of 2), its gradients
    summed in float32 and halved; against JAX's microbatched step with
    ``data_shards`` the data axis's size; on (1, 1) bit for bit the
    port's unsharded microbatched step."""
    model, opt, mesh, shardings, state = placed_state(arch, shape)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg).items()}
    model_split.reset_copied()
    loss, grads, new, metrics = _step_bits(model, opt, state, b,
                                           microbatches=2)
    assert model_split.copied()["weights"] == reckoned(state.params, mesh, B,
                                                   chunks=2)
    assert float(metrics["loss"]) == float(loss)
    check_train_step(model, opt, state, b, new, microbatches=2)
    jloss, jg, jnew = jax_microbatched(arch, shape[0] if cfg.n_experts
                                       else 1)
    assert abs(float(loss) - jloss) <= LOSS_REL * abs(jloss)
    _leaves_close([g.numpy() for g in grads], jg, arch)
    for got, want in zip(new, jnew):
        assert _rel_l2(got.numpy(), want) <= UPDATE_REL
    if shape == (1, 1):
        params = params_from_numpy(_jax_params(arch), "cpu")
        plain = make_train_step(model, opt, microbatches=2)(
            TrainState(params, opt.init(params),
                       torch.tensor(0, dtype=torch.int64)), b)
        assert torch.equal(plain[1]["loss"], metrics["loss"])
        assert all(torch.equal(a, w) for a, w in
                   zip(new, tree_util.leaves(plain[0].params)))


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_sharded_step(arch, shape):
    """``grad_compression=True`` over a placed state: each compressed
    gradient element within 1.01 max |g| / 127 of the uncompressed
    sharded gradient (one int8 step of its leaf), the same bits on a
    second run, and on (1, 1) the unsharded compressed step's bits
    (gradients and updated parameters)."""
    model, opt, _, _, state = placed_state(arch, shape)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg).items()}
    _, raw, _, _ = _step_bits(model, opt, state, b)
    _, got, new, _ = _step_bits(model, opt, state, b, grad_compression=True)
    _, again, new2, _ = _step_bits(model, opt, state, b,
                                   grad_compression=True)
    check_train_step(model, opt, state, b, new, grad_compression=True)
    for g, q in zip(raw, got):
        step = g.abs().max() / 127.0
        assert (q - g).abs().max() <= 1.01 * step
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x, y) for x, y in zip(new, new2))
    if shape == (1, 1):
        params = params_from_numpy(_jax_params(arch), "cpu")
        _, _, g1 = _value_and_grad(model, params, b)
        want = [gcomp.roundtrip_leaf(g) for g in tree_util.leaves(g1)]
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        plain, _ = make_train_step(model, opt, grad_compression=True)(
            TrainState(params, opt.init(params),
                       torch.tensor(0, dtype=torch.int64)), b)
        assert all(torch.equal(x, y) for x, y in
                   zip(new, tree_util.leaves(plain.params)))


# --------------------------------------------------------------------------
# the Trainer and elastic restore
# --------------------------------------------------------------------------
def _batches(cfg, step):
    a = _arrays(cfg, seed=100 + step)
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _sharded_trainer(tmp_path, cfg, shape, fault_hook=None, steps=5):
    model, opt = build(cfg), AdamW(lr=1e-3)
    mesh = make_forced_host_mesh(shape, device="cpu")
    trainer = Trainer(model, opt, TrainerConfig(
        total_steps=steps, checkpoint_every=2, checkpoint_dir=str(tmp_path),
        keep_checkpoints=2, log_every=10 ** 9), mesh=mesh,
        state_shardings=lm_spmd.state_shardings(model, opt, mesh),
        fault_hook=fault_hook, device="cpu")
    return trainer


def test_sharded_trainer_replays_a_fault_bitwise(tmp_path):
    """A sharded Trainer on (2, 2) with a TransientError at step 3
    restores the step-2 checkpoint onto its mesh and replays the clean
    run's losses bit for bit; its losses are the unsharded Trainer's
    within 1e-5."""
    _, cfg = _cfgs("qwen3-14b")
    clean = _sharded_trainer(tmp_path / "clean", cfg, (2, 2))
    rep = clean.run(lambda s: _batches(cfg, s), 0)
    pending = {3}

    def fault(step):
        if step in pending:
            pending.discard(step)
            raise TransientError("injected")
    faulty = _sharded_trainer(tmp_path / "fault", cfg, (2, 2), fault)
    rep2 = faulty.run(lambda s: _batches(cfg, s), 0)
    assert rep2.restarts == 1
    assert rep2.losses == rep.losses[:3] + rep.losses[2:]
    plain = Trainer(build(cfg), AdamW(lr=1e-3), TrainerConfig(
        total_steps=5, checkpoint_every=5,
        checkpoint_dir=str(tmp_path / "plain"), log_every=10 ** 9),
        device="cpu").run(lambda s: _batches(cfg, s), 0)
    for a, b in zip(rep.losses, plain.losses):
        assert abs(a - b) <= 1e-5 * abs(b)


def test_elastic_restore_across_meshes_and_packages(tmp_path):
    """A state saved from (2, 2) restores onto (4, 1), (1, 1) and one
    device bit for bit, through ``restore_elastic``; the JAX package's
    Checkpointer restores it bit for bit; and a JAX-written state
    restores onto a port mesh bit for bit."""
    _, cfg = _cfgs("mixtral-8x7b")
    trainer = _sharded_trainer(tmp_path / "run", cfg, (2, 2), steps=2)
    trainer.run(lambda s: _batches(cfg, s), 0)
    trainer.ckpt.wait()
    model, opt = trainer.model, trainer.optimizer
    saved, step = trainer.ckpt.restore(abstract_train_state(model, opt),
                                       shardings=trainer.state_shardings)
    assert step == 2
    want = [a.gather() for a in tree_util.leaves(saved)]
    for shape in ((4, 1), (1, 1)):
        mesh = make_forced_host_mesh(shape, device="cpu")
        got, step = trainer.restore_elastic(
            0, lm_spmd.state_shardings(model, opt, mesh))
        assert step == 2
        check_placement(got, lm_spmd.state_shardings(model, opt, mesh))
        for a, b in zip(tree_util.leaves(got), want):
            assert torch.equal(a.gather(), b)
    plain, _ = Checkpointer(str(tmp_path / "run")).restore(
        init_train_state(model, opt, 0, "cpu"))
    for a, b in zip(tree_util.leaves(plain), want):
        assert torch.equal(a, b)
    # the JAX package's reader over the port's sharded checkpoint
    jcfg = jconfigs.get_smoke_config("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    jabs = jsteps.abstract_train_state(jbuild(jcfg), JAdamW(lr=1e-3))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jabs)
    template = template._replace(rng=np.zeros((), np.int64))
    jstate, jstep = JCheckpointer(str(tmp_path / "run")).restore(template)
    assert jstep == 2
    jl = jax.tree_util.tree_leaves(jstate)
    assert len(jl) == len(want)
    for a, b in zip(jl, want):
        assert np.array_equal(np.asarray(a), b.numpy())
    # and a JAX-written bf16 state onto a port mesh
    jparams = jbuild(dataclasses.replace(jcfg, param_dtype="bfloat16")
                     ).init(jax.random.PRNGKey(1))
    JCheckpointer(str(tmp_path / "jax")).save(7, jparams, blocking=True)
    bf = build(dataclasses.replace(cfg, param_dtype="bfloat16"))
    mesh = make_forced_host_mesh((2, 2), device="cpu")
    shardings = sharding.sanitized_shardings(
        sharding.params_pspecs(bf.init_abstract(), bf.cfg, mesh),
        bf.init_abstract(), mesh)
    got, step = Checkpointer(str(tmp_path / "jax")).restore(
        bf.init_abstract(), shardings=shardings)
    assert step == 7
    for a, b in zip(tree_util.leaves(got), jax.tree_util.tree_leaves(
            jparams)):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(
            a.gather().view(torch.int16).numpy().view(np.uint16),
            np.asarray(b).view(ml_dtypes.bfloat16).view(np.uint16))
