"""The port's optimizers and gradient compression (``repro_torch.optim``)
against the JAX package's, on the same numpy parameters and gradients."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as joptim  # noqa: E402

import repro_torch.optim as optim  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SHAPES = {"conv": {"w": (3, 3, 4, 8), "b": (8,)}, "head": {"w": (8, 5)}}


def _tree(rng, shapes=SHAPES, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (rng.randn(*v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _torch(tree, dtype=torch.float32):
    return _map(lambda a: torch.tensor(a, dtype=dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return _map(lambda a: jnp.asarray(a, dtype), tree)


def _numpy(tree):
    return [np.asarray(a.float() if isinstance(a, torch.Tensor) else
                       np.asarray(a, np.float32), np.float32)
            for a in (leaves(tree) if isinstance(tree, dict) else tree)]


def _jleaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]


def _run_both(make, steps=5, grad_scale=1.0, param_dtype=(torch.float32,
                                                           jnp.float32)):
    """The same optimizer over ``steps`` steps of the same gradients in
    both packages: (port params, port state, port metrics), and JAX's."""
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=grad_scale) for _ in range(steps)]
    opt, jopt = make(optim), make(joptim)
    p, jp = _torch(p0, param_dtype[0]), _jax(p0, param_dtype[1])
    s, js = opt.init(p), jopt.init(jp)
    for g in grads:
        p, s, m = opt.apply(p, _torch(g), s)
        jp, js, jm = jopt.apply(jp, _jax(g), js)
    return (p, s, m), (jp, js, jm)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clipped",
                                                       "unclipped"])
@pytest.mark.parametrize("schedule", ["float", "cosine"])
def test_adamw_five_steps_match_jax(clip_norm, schedule):
    def make(mod):
        lr = 3e-3 if schedule == "float" else mod.cosine_schedule(3e-3, 2, 5)
        return mod.AdamW(lr=lr, weight_decay=1e-2, clip_norm=clip_norm)
    (p, s, m), (jp, js, jm) = _run_both(make)
    # random gradients of 376 unit normals: the norm (~19) is above 1,
    # under 1e3
    assert (float(jm["grad_norm"]) > clip_norm) == (clip_norm == 1.0)
    for got, want in zip(_numpy(p) + _numpy(s.mu) + _numpy(s.nu),
                         _jleaves(jp) + _jleaves(js.mu) + _jleaves(js.nu)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert int(s.step) == int(js.step) == 5 and s.step.dtype == torch.int32
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)


def test_weight_decay_acts_on_floating_params_only():
    # zero gradients: the update is lr * weight_decay * p alone
    opt = optim.AdamW(lr=0.1, weight_decay=0.5)
    jopt = joptim.AdamW(lr=0.1, weight_decay=0.5)
    w = np.array([1.0, -2.0, 4.0], np.float32)
    n = np.array([3, 4], np.int32)
    p = {"w": torch.tensor(w), "n": torch.tensor(n)}
    jp = {"w": jnp.asarray(w), "n": jnp.asarray(n)}
    zeros = {"w": torch.zeros(3), "n": torch.zeros(2)}
    jzeros = {"w": jnp.zeros(3), "n": jnp.zeros(2)}
    new, _, _ = opt.apply(p, zeros, opt.init(p))
    jnew, _, _ = jopt.apply(jp, jzeros, jopt.init(jp))
    np.testing.assert_allclose(new["w"].numpy(), w * (1 - 0.1 * 0.5),
                               rtol=1e-6)
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-7)
    assert new["n"].dtype == torch.int32
    np.testing.assert_array_equal(new["n"].numpy(), n)
    np.testing.assert_array_equal(new["n"].numpy(), np.asarray(jnew["n"]))


def test_bf16_params_keep_float32_moments():
    (p, s, _), (jp, js, _) = _run_both(
        lambda mod: mod.AdamW(lr=1e-2), param_dtype=(torch.bfloat16,
                                                     jnp.bfloat16))
    assert all(a.dtype == torch.bfloat16 for a in leaves(p))
    assert all(a.dtype == torch.float32 for a in leaves(s.mu) + leaves(s.nu))
    for got, want in zip(_numpy(s.mu) + _numpy(s.nu),
                         _jleaves(js.mu) + _jleaves(js.nu)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the float32 update rounds to the same bf16 value, bar a rare tie
    got = np.concatenate([a.ravel() for a in _numpy(p)])
    want = np.concatenate([a.ravel() for a in _jleaves(jp)])
    ulp = np.abs(want) * 2.0 ** -7
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got == want) > 0.99
    assert np.asarray(jp["head"]["w"]).dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_with_momentum_matches_jax(momentum):
    (p, s, m), (jp, js, jm) = _run_both(
        lambda mod: mod.SGD(lr=0.05, momentum=momentum))
    for got, want in zip(_numpy(p) + _numpy(s.mu),
                         _jleaves(jp) + _jleaves(js.mu)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert s.nu == () and js.nu == () and m == jm == {}
    assert int(s.step) == int(js.step) == 5


def test_global_norm_matches_jax():
    rng = np.random.RandomState(3)
    t = _tree(rng)
    got = optim.global_norm(_torch(t))
    np.testing.assert_allclose(float(got),
                               float(joptim.global_norm(_jax(t))),
                               rtol=1e-6)
    assert got.dtype == torch.float32
    assert float(optim.global_norm({"a": torch.tensor([3.0]),
                                    "b": torch.tensor([4.0])})) == 5.0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 40, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    lr = optim.cosine_schedule(2e-3, warmup=10, total=100)
    jlr = joptim.cosine_schedule(2e-3, warmup=10, total=100)
    got = float(lr(torch.tensor(step, dtype=torch.int32)))
    np.testing.assert_allclose(got, float(jlr(jnp.asarray(step, jnp.int32))),
                               rtol=1e-6, atol=1e-12)
    if step == 0:
        assert got == 0.0                       # warm-up starts at 0
    if step == 10:
        assert got == pytest.approx(2e-3, rel=1e-6)   # the peak
    if step >= 100:
        assert got == pytest.approx(0.0, abs=1e-12)   # the end


def test_error_feedback_unbiased_accumulation():
    """Sum of compressed grads + final residual == sum of true grads (as
    the JAX package's test)."""
    rng = np.random.RandomState(0)
    res = optim.init_residuals({"w": torch.zeros(32)})
    gen = torch.Generator().manual_seed(0)
    total_true, total_sent = np.zeros(32), np.zeros(32)
    for _ in range(20):
        g = {"w": torch.tensor(rng.randn(32), dtype=torch.float32)}
        cg, res = optim.compress_with_feedback(g, res, gen)
        total_true += g["w"].numpy()
        total_sent += cg["w"].numpy()
    gap = np.abs(total_true - (total_sent + res["w"].numpy()))
    assert gap.max() < 1e-4
    assert res["w"].dtype == torch.float32


@pytest.mark.parametrize("seed", range(8))
def test_compression_error_is_bounded_by_the_scale(seed):
    """One step's residual is within one int8 step, and the rounding is
    unbiased: over many draws the mean sent value approaches the true one
    in both packages (their noise cannot match draw for draw)."""
    from repro_torch.optim import grad_compression as gc
    from repro.optim import grad_compression as jgc
    rng = np.random.RandomState(seed)
    g = rng.randn(64).astype(np.float32)
    cg, new_res = optim.compress_with_feedback(
        {"w": torch.tensor(g)}, optim.init_residuals({"w": torch.zeros(64)}),
        torch.Generator().manual_seed(seed))
    scale = np.abs(g).max() / 127
    assert np.abs(new_res["w"].numpy()).max() <= scale + 1e-6
    # the int8 grid and its scale are the JAX package's
    q, s = gc.quantize_int8(torch.tensor(g), torch.Generator().manual_seed(
        seed))
    jq, js = jgc.quantize_int8(jnp.asarray(g), jax.random.PRNGKey(seed))
    assert q.dtype == torch.int8 and np.asarray(jq).dtype == np.int8
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() \
        <= 1
    # unbiased: the mean of 400 round trips is within 5 standard errors
    # (each draw's error is uniform within one step: sd <= scale / 2)
    gen = torch.Generator().manual_seed(seed + 100)
    mean = np.mean([gc.dequantize_int8(*gc.quantize_int8(
        torch.tensor(g), gen)).numpy() for _ in range(400)], axis=0)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), 400)
    jmean = np.mean([np.asarray(jgc.dequantize_int8(*jgc.quantize_int8(
        jnp.asarray(g), k))) for k in keys], axis=0)
    bound = 5 * (scale / 2) / np.sqrt(400)
    assert np.abs(mean - g).max() <= bound
    assert np.abs(jmean - g).max() <= bound
