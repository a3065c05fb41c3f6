"""The sharded LM train step (``repro_torch.distributed.lm_spmd``)
against the JAX package's single-device step, and the sharded state
through the ``Trainer`` and its checkpoints (elastic restore).

For a data axis of n, the JAX reference runs ``value_and_grad(
model.loss)`` and ``AdamW.apply`` on one device with
``repro.distributed.act_sharding.data_shards`` monkeypatched to return
n: the JAX package's own shard-local MoE semantics (capacity per shard,
the aux loss over all tokens) on one device.  Smoke configs in fp32 on
CPU meshes (1, 1), (2, 1), (1, 2), (2, 2) and (4, 1), batch 4 x 16:

  * the loss within 1e-5 relative; each leaf's gradient within 1e-4 rel
    L2 (a leaf zero in exact arithmetic within 1e-6 of the largest max
    |g|); the parameters after one AdamW step within 1e-5 rel L2.  The
    step's learning rate is 1e-4: AdamW's first update is g / (|g| +
    eps), which turns the gradients' rounding differences on elements of
    small |g| into update differences in proportion to the learning rate
    (at 1e-3, deepseek-v3's MTP router moves 1.15e-5 rel L2 apart on
    (4, 1), its gradients 8.5e-7 apart);
  * every block on its coordinate's device with the spec's shape;
  * on (1, m) meshes the loss and gradients bit for bit the port's
    single-device step's.

The dense, ssm and hybrid families are held here (with the Trainer and
checkpoint tests), the moe, vlm and encdec families in
``test_torch_lm_spmd_families.py``.
"""
import dataclasses
import functools

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
from repro_torch.distributed import lm_spmd, sharding  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_forced_host_mesh  # noqa: E402
from repro_torch.models import build, transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import (TrainState, Trainer,  # noqa: E402
                               TrainerConfig, TransientError,
                               abstract_train_state, init_train_state,
                               make_train_step)
from repro_torch.train.steps import _value_and_grad  # noqa: E402

MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1))
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


def check_against_jax(arch, shape, batch=B):
    model, opt, mesh, shardings, state = placed_state(arch, shape)
    check_placement(state, shardings)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg, batch).items()}
    loss, _, leaves = lm_spmd.value_and_grad(model, state.params, b)
    grads = [g.gather() for g in tree_util.leaves(
        lm_spmd.gradients(leaves))]
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
    """A mesh of one data row: the loss and gradients bit for bit the
    port's single-device step's."""
    model, _, _, _, state = placed_state(arch, shape)
    _, cfg = _cfgs(arch)
    b = {k: torch.from_numpy(v) for k, v in _arrays(cfg).items()}
    params = params_from_numpy(_jax_params(arch), "cpu")
    loss1, _, g1 = _value_and_grad(model, params, b)
    loss, _, leaves = lm_spmd.value_and_grad(model, state.params, b)
    assert torch.equal(loss, loss1)
    for got, want in zip(tree_util.leaves(lm_spmd.gradients(leaves)),
                         tree_util.leaves(g1)):
        assert torch.equal(got.gather(), want)


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
