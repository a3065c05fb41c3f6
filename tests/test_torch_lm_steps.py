"""The port's LM steps, Trainer, checkpoints and launcher
(``repro_torch.train``, ``repro_torch.launch.train``) against the JAX
package's, on numpy inputs from seeds, in fp32 compute unless stated:

  * ``make_train_step`` against JAX's (three AdamW steps; microbatches 2
    against the full batch; int8 gradient compression over a bf16 tree),
    ``make_serve_step`` and ``make_prefill_step`` against JAX's, and over
    parameters placed on a (1, 1) mesh their ``Sharded`` outputs' one
    block bit for bit the unsharded steps';
  * the ``Trainer`` on an LM (the loss decreases, as
    ``tests/test_trainer.py::test_loss_decreases`` requires; a resume after
    a fault is bit for bit), LM train states with bf16 leaves across the
    packages' checkpoints, and the ``launch.train`` launcher on every
    family (and its refusal of ``--device cuda`` without a card).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.api import serving_cache, tuning  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build, transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import (TrainState, Trainer,  # noqa: E402
                               TrainerConfig, TransientError,
                               init_train_state, make_prefill_step,
                               make_serve_step, make_train_step)

FAMILY_ARCHS = {"dense": "stablelm-3b", "moe": "mixtral-8x7b",
                "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b",
                "vlm": "llama-3.2-vision-11b", "encdec": "whisper-tiny"}
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated(tmp_path):
    serving_cache.clear()
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    yield
    tuning.set_cache_path(None)
    serving_cache.clear()
    transformer.clear_compute_cache()


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _arrays(cfg, B=2, S=16, seed=0):
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.randn(B, cfg.n_vision_tokens,
                                  cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
    return out


def _port_batch(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _jax_batch(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


# --------------------------------------------------------------------------
# train, serve and prefill steps against JAX's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-1.3b",
                                  "mixtral-8x7b"])
def test_train_steps_match_jax(arch):
    """Three AdamW steps from the same parameters and batches: the losses
    within 1e-5, the parameters within 1e-5 rel L2 a leaf (AdamW divides
    by each gradient's RMS, so a leaf whose gradient is zero in exact
    arithmetic moves by rounding noise of size lr a step in either
    package: such leaves are held to 3 lr)."""
    jcfg, cfg = _cfgs(arch)
    jm, m = jbuild(jcfg), build(cfg)
    jopt, opt = JAdamW(lr=LR), AdamW(lr=LR)
    jstate = jsteps.init_train_state(jm, jopt, jax.random.PRNGKey(0))
    params = params_from_numpy(jstate.params, "cpu")
    state = TrainState(params, opt.init(params),
                       torch.tensor(0, dtype=torch.int64))
    jstep = jax.jit(jsteps.make_train_step(jm, jopt))
    step = make_train_step(m, opt)
    start = [a.clone() for a in tree_util.leaves(params)]
    for i in range(3):
        arrays = _arrays(cfg, seed=10 + i)
        jstate, jmetrics = jstep(jstate, _jax_batch(arrays))
        state, metrics = step(state, _port_batch(arrays))
        assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) \
            <= 1e-5 * abs(float(jmetrics["loss"])), i
        assert abs(float(metrics["grad_norm"])
                   - float(jmetrics["grad_norm"])) \
            <= 1e-4 * float(jmetrics["grad_norm"]), i
    assert int(state.opt.step) == 3
    jleaves = jax.tree_util.tree_leaves_with_path(jstate.params)
    for (path, want), got, s in zip(jleaves, tree_util.leaves(state.params),
                                    start):
        name = "/".join(k.key for k in path)
        want = np.asarray(want)
        moved = np.abs(want - s.numpy()).max()
        if moved <= 3 * LR * 1.01:
            assert np.abs(got.numpy() - s.numpy()).max() <= 3 * LR * 1.01
            continue
        assert _rel_l2(got.numpy(), want) <= 1e-5, name


class _Recording:
    """An optimizer that keeps the gradients it is given."""

    def __init__(self):
        self.grads = []

    def init(self, params):
        return ()

    def apply(self, params, grads, state):
        self.grads.append(grads)
        return params, state, {}


def test_microbatches_equal_the_full_batch():
    _, cfg = _cfgs("stablelm-3b")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _port_batch(_arrays(cfg, B=4, S=16, seed=3))
    rec = _Recording()
    state = TrainState(params, (), torch.tensor(0))
    _, m1 = make_train_step(model, rec)(state, batch)
    _, m2 = make_train_step(model, rec, microbatches=2)(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) \
        <= 1e-6 * float(m1["loss"])
    for a, b in zip(tree_util.leaves(rec.grads[0]),
                    tree_util.leaves(rec.grads[1])):
        assert b.dtype == torch.float32
        assert _rel_l2(b.numpy(), a.numpy()) <= 1e-5


def test_grad_compression_runs_over_a_bf16_lm_tree():
    _, cfg = _cfgs("deepseek-v3-671b", param_dtype="bfloat16")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _port_batch(_arrays(cfg, seed=4))
    plain, squeezed = _Recording(), _Recording()
    state = TrainState(params, (), torch.tensor(0))
    make_train_step(model, plain)(state, batch)
    make_train_step(model, squeezed, grad_compression=True)(state, batch)
    for g, q, p in zip(tree_util.leaves(plain.grads[0]),
                       tree_util.leaves(squeezed.grads[0]),
                       tree_util.leaves(params)):
        assert q.dtype == g.dtype == p.dtype == torch.bfloat16
        assert torch.isfinite(q.float()).all()
        # stochastic int8: within one quantization step of the gradient
        step = g.float().abs().max() / 127.0
        assert (q.float() - g.float()).abs().max() <= 1.01 * step + 1e-2 \
            * g.float().abs().max()


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b",
                                  "whisper-tiny"])
def test_serve_and_prefill_steps_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jm, m = jbuild(jcfg), build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = params_from_numpy(jp, "cpu")
    arrays = _arrays(cfg, B=2, S=8, seed=5)
    mem = arrays.get("frames")
    jmem = None if mem is None else jnp.asarray(mem)
    tmem = None if mem is None else torch.from_numpy(mem)
    logits = make_prefill_step(m)(p, torch.from_numpy(arrays["tokens"]),
                                  tmem)
    jlogits = jsteps.make_prefill_step(jm)(jp, jnp.asarray(arrays["tokens"]),
                                          jmem)
    assert _rel_l2(logits.numpy(), jlogits) <= 1e-5
    jserve, serve = jsteps.make_serve_step(jm), make_serve_step(m)
    jcache = jm.init_cache(jp, 2, 8, jmem)
    cache = m.init_cache(p, 2, 8, tmem)
    tok = arrays["tokens"][:, :1]
    for t in range(6):
        pos = np.full((2,), t, np.int32)
        jnext, jlg, jcache = jserve(jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos))
        nxt, lg, cache = serve(p, cache, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
        assert _rel_l2(lg.numpy(), jlg) <= 1e-4, t
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        tok = np.asarray(jnext)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b",
                                  "whisper-tiny"])
def test_placed_steps_on_one_coordinate_are_the_unsharded_steps(arch):
    """Over parameters placed on a (1, 1) mesh the steps return
    ``Sharded`` outputs (the logits and next tokens each one block, on
    the coordinate's device) whose blocks are the unsharded steps'
    tensors bit for bit; the next tokens feed the next step as they
    lie."""
    from repro_torch.distributed import serve_spmd, sharding
    from repro_torch.launch.mesh import make_forced_host_mesh
    _, cfg = _cfgs(arch)
    m = build(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = make_forced_host_mesh((1, 1), device="cpu")
    placed = sharding.place(p, serve_spmd.param_shardings(m, mesh))
    arrays = _arrays(cfg, B=2, S=8, seed=5)
    tok = torch.from_numpy(arrays["tokens"])
    mem = arrays.get("frames")
    mem = None if mem is None else torch.from_numpy(mem)
    got = make_prefill_step(m)(placed, tok, mem)
    assert isinstance(got, sharding.Sharded) and got.shards.size == 1
    assert torch.equal(got.shards[0, 0], make_prefill_step(m)(p, tok, mem))
    serve = make_serve_step(m)
    cache = m.init_cache(placed, 2, 8, mem)
    plain = m.init_cache(p, 2, 8, mem)
    nxt, pnxt = tok[:, :1], tok[:, :1]
    for t in range(3):
        pos = torch.full((2,), t, dtype=torch.int32)
        nxt, lg, cache = serve(placed, cache, nxt, pos)
        pnxt, plg, plain = serve(p, plain, pnxt, pos)
        assert torch.equal(lg.shards[0, 0], plg)
        assert torch.equal(nxt.shards[0, 0], pnxt)
        assert nxt.shards[0, 0].dtype == torch.int32


# --------------------------------------------------------------------------
# the Trainer, checkpoints and the launcher
# --------------------------------------------------------------------------
def _trainer(tmp_path, arch="stablelm-3b", fault_hook=None, lr=1e-2,
             **kw):
    cfg = configs.get_smoke_config(arch)
    trainer = Trainer(build(cfg), AdamW(lr=lr), TrainerConfig(
        checkpoint_dir=str(tmp_path), log_every=10 ** 9, **kw),
        fault_hook=fault_hook, device="cpu")
    return trainer, launch_train.token_batches(cfg, 4, 32, "cpu")


def test_trainer_loss_decreases(tmp_path):
    """tests/test_trainer.py::test_loss_decreases on the port."""
    trainer, batches = _trainer(tmp_path, total_steps=30,
                                checkpoint_every=10)
    rep = trainer.run(batches, 0)
    assert rep.steps_run == 30
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5]) - 0.1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x7b"])
def test_trainer_resume_is_bit_for_bit(tmp_path, arch):
    clean, batches = _trainer(tmp_path / "clean", arch, total_steps=6,
                              checkpoint_every=2)
    want = clean.run(batches, 0).losses
    pending = {3}

    def fault(step):
        if step in pending:
            pending.discard(step)
            raise TransientError("injected")
    faulty, _ = _trainer(tmp_path / "fault", arch, fault_hook=fault,
                         total_steps=6, checkpoint_every=2)
    rep = faulty.run(batches, 0)
    assert rep.restarts == 1 and rep.steps_run == 3 + 6 - 2
    assert rep.losses[:3] == want[:3]
    assert rep.losses[3:] == want[2:]


def _lm_states():
    """The same LM train state (deepseek-v3's smoke config with bf16
    parameters) in both packages, AdamW's moments after one update of
    unit gradients in JAX's."""
    jcfg, cfg = _cfgs("deepseek-v3-671b", param_dtype="bfloat16")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jopt = JAdamW(lr=LR)
    jp, jo, _ = jax.jit(jopt.apply)(
        jp, jax.tree_util.tree_map(jnp.ones_like, jp), jopt.init(jp))
    jtree = {"params": jp, "opt": jo}
    params = params_from_numpy(jp, "cpu")
    opt = AdamW(lr=LR)
    ttree = {"params": params, "opt": opt.init(params)}
    return jtree, ttree, build(cfg), opt


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_a_jax_lm_state_restores_in_the_port(tmp_path):
    jtree, ttree, _, _ = _lm_states()
    JCheckpointer(str(tmp_path)).save(4, jtree, blocking=True)
    restored, step = Checkpointer(str(tmp_path)).restore(ttree)
    assert step == 4
    jleaves = jax.tree_util.tree_leaves(jtree)
    got = tree_util.leaves(restored)
    assert len(got) == len(jleaves)
    assert any(t.dtype == torch.bfloat16 for t in got)
    for t, j in zip(got, jleaves):
        assert t.shape == np.asarray(j).shape
        np.testing.assert_array_equal(_bits(t), _bits(j))
    assert int(restored["opt"].step) == 1


def test_a_port_lm_state_restores_in_jax(tmp_path):
    jtree, ttree, model, opt = _lm_states()
    state = TrainState(ttree["params"], ttree["opt"], torch.tensor(0))
    state, _ = make_train_step(model, opt)(
        state, _port_batch(_arrays(model.cfg, seed=7)))
    ttree = {"params": state.params, "opt": state.opt}
    ck = Checkpointer(str(tmp_path))
    ck.save(8, ttree, blocking=True)
    ck.close()
    jrestored, step = JCheckpointer(str(tmp_path)).restore(jtree)
    assert step == 8
    jleaves = jax.tree_util.tree_leaves(jrestored)
    assert len(jleaves) == len(tree_util.leaves(ttree))
    for j, t in zip(jleaves, tree_util.leaves(ttree)):
        assert np.asarray(j).dtype == (ml_dtypes.bfloat16
                                       if t.dtype == torch.bfloat16
                                       else t.numpy().dtype)
        np.testing.assert_array_equal(_bits(j), _bits(t))


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_train_launcher_runs_each_family(family, tmp_path, capsys):
    rep = launch_train.main(["--arch", FAMILY_ARCHS[family], "--smoke",
                             "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16", "--checkpoint-dir",
                             str(tmp_path)])
    assert rep.steps_run == 2 and all(np.isfinite(rep.losses))
    assert "done: 2 steps on cpu" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).latest_step() == 2


def test_train_launcher_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        launch_train.main(["--arch", "mamba2-1.3b", "--smoke",
                           "--checkpoint-dir", str(tmp_path)])


def test_init_train_state_draws_on_the_generators_device():
    _, cfg = _cfgs("mamba2-1.3b")
    state = init_train_state(build(cfg), AdamW(), 0, "cpu")
    assert all(a.device.type == "cpu"
               for a in tree_util.leaves(state.params))
    want = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    for a, b in zip(tree_util.leaves(state.params), tree_util.leaves(want)):
        assert torch.equal(a, b)
