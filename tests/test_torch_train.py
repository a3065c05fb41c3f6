"""The port's train steps and trainer (``repro_torch.train``) against the
JAX package's, on the paper's CNNs through a duck-typed model adapter,
with the JAX parameters carried across by ``params_from_numpy``.

A note on the comparisons: the conv biases that feed a normalization
(``stem/b``, ``conv1/b``, ``conv2/b``) have a gradient that is zero in
exact arithmetic and rounding noise in either package; AdamW divides by
its RMS, so their updates are noise of size ``lr`` in both.  Those leaves
are held to that size; every other leaf to the stated tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs.resnet18 as jconfigs  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train.steps import init_train_state as jinit_train_state  # noqa: E402
from repro.train.steps import make_train_step as jmake_train_step  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.data import (ImagePipelineConfig,  # noqa: E402
                              SyntheticImagePipeline)
from repro_torch.interop import (adamw_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import AdamW, AdamWState  # noqa: E402
from repro_torch.testing import DEFAULT_TOL  # noqa: E402
from repro_torch.train import (TrainState, Trainer,  # noqa: E402
                               TrainerConfig, TransientError,
                               init_train_state, make_train_step)
from repro_torch.tree import flatten_with_path  # noqa: E402

LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CNNModel:
    """The port's CNN as ``make_train_step`` and ``Trainer`` take a model."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, gen):
        init = cnn.init_vgg if self.cfg.kind == "vgg" else cnn.init_resnet
        return init(gen, self.cfg, device=gen.device)

    def loss(self, params, batch):
        return cnn.cnn_loss(params, self.cfg, batch)


class JCNNModel:
    """The same adapter over the JAX package's CNN."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, key):
        return jcnn.init_resnet(key, self.cfg)

    def loss(self, params, batch):
        return jcnn.cnn_loss(params, self.cfg, batch)


class Recording:
    """An optimizer that keeps the gradients it is given and changes
    nothing (duck-typed, in either package)."""

    def __init__(self):
        self.grads = []

    def init(self, params):
        return ()

    def apply(self, params, grads, state):
        self.grads.append(grads)
        return params, state, {}


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.SMOKE_CNN, **kw),
            dataclasses.replace(configs.SMOKE_CNN, **kw))


def _flat(tree):
    return {"/".join(str(p) for p in path): np.asarray(
        leaf.detach() if isinstance(leaf, torch.Tensor) else leaf,
        np.float32) for path, leaf in flatten_with_path(tree)}


def _jflat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dead(name):
    """A conv bias that feeds a normalization: zero gradient in exact
    arithmetic."""
    return name.endswith(("stem/b", "conv1/b", "conv2/b"))


def _assert_params_close(got, want, start, steps, rel=1e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if _dead(k):
            bound = steps * LR * 1.01
            assert np.abs(g - start[k]).max() <= bound, k
            assert np.abs(w - start[k]).max() <= bound, k
            continue
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= rel, (k, err)


def _batches(cfg, n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, cfg.image_size, cfg.image_size, 3).astype(
        np.float32), rng.randint(0, cfg.n_classes, batch).astype(np.int32))
        for _ in range(n)]


def _tb(x, y):
    return {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}


def _jb(x, y):
    return {"images": jnp.asarray(x), "labels": jnp.asarray(y)}


def _jax_value_and_grad(jcfg, params, x, y):
    """JAX's loss and gradient of ``cnn_loss``, compiled."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jcnn.cnn_loss(p, jcfg, b)[0]))
    return fn(params, _jb(x, y))


def _states(jcfg, opt, jopt):
    js = jinit_train_state(JCNNModel(jcfg), jopt, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.params),
                           "cpu")
    return js, TrainState(tp, opt.init(tp), torch.tensor(0))


@pytest.mark.parametrize("algo", ["direct", "sfc6_6"])
def test_three_train_steps_match_jax(algo):
    jcfg, cfg = _cfgs(conv_algo=algo)
    opt, jopt = AdamW(lr=LR, weight_decay=1e-4), \
        JAdamW(lr=LR, weight_decay=1e-4)
    js, ts = _states(jcfg, opt, jopt)
    start = _flat(ts.params)
    step = make_train_step(CNNModel(cfg), opt)
    jstep = jax.jit(jmake_train_step(JCNNModel(jcfg), jopt))
    for x, y in _batches(cfg, 3):
        ts, m = step(ts, _tb(x, y))
        js, jm = jstep(js, _jb(x, y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert set(m) == set(jm) == {"loss", "acc", "grad_norm", "lr"}
    _assert_params_close(_flat(ts.params), _jflat(js.params), start, 3)
    assert int(ts.opt.step) == int(js.opt.step) == 3


def test_int8_first_step_gradients_match_jax():
    """Dynamic int8 sfc6_6 (the STE through every hook): the first step's
    gradients within DEFAULT_TOL of the largest of JAX's."""
    jcfg, cfg = _cfgs(conv_algo="sfc6_6", quant="int8")
    rec, jrec = Recording(), Recording()
    js = jinit_train_state(JCNNModel(jcfg), jrec, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.params),
                           "cpu")
    (x, y), = _batches(cfg, 1, batch=2)
    _, m = make_train_step(CNNModel(cfg), rec)(
        TrainState(tp, (), torch.tensor(0)), _tb(x, y))
    jloss, jgrads = _jax_value_and_grad(jcfg, js.params, x, y)
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    got, want = _flat(rec.grads[0]), _jflat(jgrads)
    assert set(got) == set(want)
    scale = max(np.abs(g).max() for g in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=DEFAULT_TOL * scale, err_msg=k)


def test_microbatches_equal_the_full_batch():
    jcfg, cfg = _cfgs(conv_algo="sfc6_6")
    full, split = Recording(), Recording()
    js = jinit_train_state(JCNNModel(jcfg), full, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.params),
                           "cpu")
    state = TrainState(tp, (), torch.tensor(0))
    (x, y), = _batches(cfg, 1, batch=4)
    # a norm over the batch couples the images: each half normalises by its
    # own statistics, as in the JAX package's accumulation
    _, m = make_train_step(CNNModel(cfg), split, microbatches=2)(
        state, _tb(x, y))
    halves = [make_train_step(CNNModel(cfg), full)(state, _tb(x[i:i + 2],
                                                              y[i:i + 2]))[1]
              for i in (0, 2)]
    assert set(m) == {"loss"}
    np.testing.assert_allclose(float(m["loss"]), np.mean(
        [float(h["loss"]) for h in halves]), rtol=1e-6)
    got = _flat(split.grads[0])
    want = {k: (a + b) / 2 for (k, a), b in zip(
        _flat(full.grads[0]).items(), _flat(full.grads[1]).values())}
    scale = max(np.abs(g).max() for g in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
    # and the JAX package's accumulation gives the same loss
    jrec = Recording()
    _, jm = jmake_train_step(JCNNModel(jcfg), jrec, microbatches=2)(
        js, _jb(x, y))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)


def test_resume_from_jax_optimizer_state():
    """Two JAX steps, then the params and the AdamW state carried across:
    the port's next step is JAX's next step."""
    jcfg, cfg = _cfgs(conv_algo="direct")
    opt, jopt = AdamW(lr=LR, weight_decay=1e-4), \
        JAdamW(lr=LR, weight_decay=1e-4)
    js, _ = _states(jcfg, opt, jopt)
    jstep = jax.jit(jmake_train_step(JCNNModel(jcfg), jopt))
    batches = _batches(cfg, 3)
    for x, y in batches[:2]:
        js, _ = jstep(js, _jb(x, y))
    np_opt = jax.tree_util.tree_map(np.asarray, js.opt)
    carried = adamw_state_from_numpy(np_opt, device="cpu")
    assert isinstance(carried, AdamWState) and int(carried.step) == 2
    assert carried.step.dtype == torch.int32
    ts = TrainState(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, js.params), "cpu"), carried, torch.tensor(0))
    start = _flat(ts.params)
    ts, m = make_train_step(CNNModel(cfg), opt)(ts, _tb(*batches[2]))
    js, jm = jstep(js, _jb(*batches[2]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(ts.opt.step) == 3
    _assert_params_close(_flat(ts.params), _jflat(js.params), start, 1)
    # the moments too (the dead biases' first moments are noise as well)
    for tree, jtree in ((ts.opt.mu, js.opt.mu), (ts.opt.nu, js.opt.nu)):
        got, want = _flat(tree), _jflat(jtree)
        for k, w in want.items():
            if not _dead(k):
                err = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w),
                                                       1e-30)
                assert err <= 1e-5, (k, err)


def test_stem_gradients_through_the_lowered_plan_match_jax_grad():
    """A 128-px ResNet whose 7x7/2 stem and 3x3/2 transition lower onto
    polyphase sfc6_6 sub-convs: every gradient within DEFAULT_TOL of the
    largest of jax.grad's."""
    kw = dict(image_size=128, widths=(4, 8), stages=(1, 1), stem_kernel=7,
              conv_algo="sfc6_6")
    jcfg, cfg = _cfgs(**kw)
    rec, jrec = Recording(), Recording()
    js = jinit_train_state(JCNNModel(jcfg), jrec, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, js.params),
                           "cpu")
    (x, y), = _batches(cfg, 1, batch=2)
    from repro_torch.api import ConvSpec, plan
    stem = plan(ConvSpec.for_conv2d(x.shape, tp["stem"]["w"].shape, stride=2),
                backend="reference", algo="sfc6_6")
    assert stem.path == "lowered"
    make_train_step(CNNModel(cfg), rec)(TrainState(tp, (), torch.tensor(0)),
                                        _tb(x, y))
    got, want = _flat(rec.grads[0]), _jflat(_jax_value_and_grad(
        jcfg, js.params, x, y)[1])
    scale = max(np.abs(g).max() for g in want.values())
    assert np.abs(want["stem/w"]).max() > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=DEFAULT_TOL * scale, err_msg=k)


# ---------------------------------------------------------------------------
# the Trainer, as tests/test_trainer.py runs the JAX package's
# ---------------------------------------------------------------------------
def _trainer_setup(tmp_path, **kw):
    cfg = configs.SMOKE_CNN
    pipe = SyntheticImagePipeline(ImagePipelineConfig(
        cfg.image_size, cfg.n_classes, global_batch=8, seed=3))

    def batches(i):
        b = pipe.batch(i)
        return {"images": torch.from_numpy(b["images"]),
                "labels": torch.from_numpy(b["labels"])}

    tc = TrainerConfig(checkpoint_dir=str(tmp_path), log_every=1000, **kw)
    return CNNModel(cfg), batches, tc


def test_trainer_loss_decreases(tmp_path):
    model, batches, tc = _trainer_setup(tmp_path, total_steps=30,
                                        checkpoint_every=10)
    rep = Trainer(model, AdamW(lr=LR), tc, device="cpu").run(batches, 0)
    assert rep.steps_run == 30 and rep.restarts == 0
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5]) - 0.1
    assert len(rep.step_times) == 30


def test_trainer_fault_injection_and_resume(tmp_path):
    """A transient failure mid-run rolls back to the last checkpoint and
    completes; the replayed steps give the losses they gave before."""
    fail_at = {17}

    def fault_hook(step):
        if step in fail_at:
            fail_at.discard(step)     # fail exactly once
            raise TransientError("injected node failure")

    model, batches, tc = _trainer_setup(tmp_path, total_steps=25,
                                        checkpoint_every=5)
    trainer = Trainer(model, AdamW(lr=LR), tc, fault_hook=fault_hook,
                      device="cpu")
    rep = trainer.run(batches, 0)
    assert rep.restarts == 1
    assert rep.steps_run == 17 + (25 - 15)     # resumed from step 15
    assert trainer.ckpt.latest_step() == 25
    # steps 15 and 16 ran twice, from the same state on the same batches
    np.testing.assert_allclose(rep.losses[17:19], rep.losses[15:17],
                               rtol=1e-6)


def test_trainer_non_finite_loss_rolls_back(tmp_path):
    model, batches, tc = _trainer_setup(tmp_path, total_steps=8,
                                        checkpoint_every=4)
    poisoned = {6}

    def nan_at_six(i):
        b = batches(i)
        if i in poisoned:
            poisoned.discard(i)
            b["images"] = torch.full_like(b["images"], float("nan"))
        return b

    rep = Trainer(model, AdamW(lr=LR), tc, device="cpu").run(nan_at_six, 0)
    assert rep.restarts == 1 and rep.steps_run == 6 + 4
    assert all(np.isfinite(rep.losses))


def test_trainer_repeated_failure_aborts(tmp_path):
    def always_fail(step):
        raise TransientError("dead node")
    model, batches, tc = _trainer_setup(tmp_path, total_steps=10,
                                        max_retries=2)
    trainer = Trainer(model, AdamW(lr=LR), tc, fault_hook=always_fail,
                      device="cpu")
    with pytest.raises(RuntimeError, match="giving up"):
        trainer.run(batches, 0)


def test_trainer_restart_resumes_from_checkpoint(tmp_path):
    """Simulated preemption: a fresh Trainer on the same directory continues
    from the saved step instead of restarting from scratch."""
    model, batches, tc = _trainer_setup(tmp_path, total_steps=10,
                                        checkpoint_every=5)
    Trainer(model, AdamW(lr=LR), tc, device="cpu").run(batches, 0)
    tc2 = dataclasses.replace(tc, total_steps=20)
    t2 = Trainer(model, AdamW(lr=LR), tc2, device="cpu")
    state, step = t2.init_or_restore(0)
    assert step == 10 and int(state.opt.step) == 10
    rep = t2.run(batches, 0)
    assert rep.steps_run == 10        # only the remaining steps


def test_trainer_grad_compression_still_converges(tmp_path):
    model, batches, tc = _trainer_setup(tmp_path, total_steps=30,
                                        checkpoint_every=50,
                                        grad_compression=True)
    rep = Trainer(model, AdamW(lr=LR), tc, device="cpu").run(batches, 0)
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5]) - 0.05


def test_init_train_state_draws_from_the_seed():
    model = CNNModel(configs.SMOKE_CNN)
    a = init_train_state(model, AdamW(), 7, device="cpu")
    b = init_train_state(model, AdamW(), 7, device="cpu")
    c = init_train_state(model, AdamW(), 8, device="cpu")
    fa, fb, fc = _flat(a.params), _flat(b.params), _flat(c.params)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert not np.array_equal(fa["stem/w"], fc["stem/w"])
    assert int(a.opt.step) == 0 and int(a.rng) == 7
