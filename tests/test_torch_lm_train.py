"""LM training in the port (A15) against the JAX package, on numpy inputs
from seeds, in fp32 compute unless stated:

  * ``flash_attention``'s gradients (dq, dk, dv) against ``jax.grad``
    through the JAX package's custom VJP, over
    ``test_torch_lm.py::test_flash_attention_matches_jax``'s cases, within
    1e-5 rel L2; the Function saves O(S·D), autograd through the plain
    loop O(S²);
  * C14: ``ssd_chunked`` at chunk 256 keeps the forward bits of the old
    formula (exp, then select) and JAX's forward within 1e-5; its gradient
    is finite and within 1e-4 of JAX's gradient at chunk 16, where JAX's
    own dt gradient at chunk 256 is not finite (pinned);
  * C13: autograd through the rank-1 conv's weights bypasses the serving
    cache (two backward passes over the same leaves; the gradient after a
    ``no_grad`` forward is a fresh run's; a warm hit still hits);
  * per-layer remat (``full`` and ``dots``) against none, per family, bit
    for bit; the serving forward is not wrapped; the recomputation takes
    the fp32 guard; ``full_fp32_backward`` lets other threads join.

The steps, the Trainer, the checkpoints and the launcher are held in
``test_torch_lm_steps.py``.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.api import serving_cache, tuning  # noqa: E402
from repro_torch.core import precision  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build, ssm, transformer  # noqa: E402

# one architecture of each family
FAMILY_ARCHS = {"dense": "stablelm-3b", "moe": "mixtral-8x7b",
                "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b",
                "vlm": "llama-3.2-vision-11b", "encdec": "whisper-tiny"}
GATES = {"gate": 0.5, "ffn_gate": -0.7}


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


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _grads(model, params, batch):
    """Loss and the gradient of every leaf (tree order), by autograd."""
    live = tree_util.tree_map(lambda a: a.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_util.leaves(live))


def _saved_bytes(fn):
    """``fn()`` and the bytes autograd saves for its backward outside any
    checkpoint."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


# --------------------------------------------------------------------------
# flash attention's backward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("Hkv,g,Dv,causal,window,q_offset,chunk", [
    (2, 2, 16, True, 0, 0, 8), (4, 1, 8, True, 0, 0, 16),
    (2, 2, 16, True, 7, 0, 8), (1, 4, 32, True, 0, 0, 33),
    (2, 1, 16, False, 0, 0, 10), (2, 2, 16, True, 0, 5, 8)])
def test_flash_attention_gradients_match_jax(Hkv, g, Dv, causal, window,
                                             q_offset, chunk):
    rng = np.random.RandomState(0)
    B, Sq, Sk, D = 2, 28 if q_offset else 33, 33, 16
    qg = rng.randn(B, Sq, Hkv, g, D).astype(np.float32)
    k = rng.randn(B, Sk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Sk, Hkv, Dv).astype(np.float32)
    dout = rng.randn(B, Sq, Hkv, g, Dv).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)
    live = [_t(a).requires_grad_() for a in (qg, k, v)]
    out = attn.flash_attention(*live, **kw)
    got = torch.autograd.grad(out, live, _t(dout))
    want = jax.grad(lambda q, kk, vv: jnp.sum(
        jattn.flash_attention(q, kk, vv, **kw) * dout),
        argnums=(0, 1, 2))(qg, k, v)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _rel_l2(a.numpy(), b) <= 1e-5, (name, _rel_l2(a.numpy(), b))


def test_flash_attention_gradients_keep_the_input_dtypes():
    rng = np.random.RandomState(1)
    qg, k, v = (torch.tensor(rng.randn(*s), dtype=torch.bfloat16)
                .requires_grad_() for s in ((1, 9, 2, 2, 8), (1, 9, 2, 8),
                                            (1, 9, 2, 4)))
    out = attn.flash_attention(qg, k, v, chunk=4)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), (qg, k, v))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [qg.shape, k.shape, v.shape]


def test_flash_attention_saves_no_score_matrix():
    """The Function saves q, k, v, m, l and the f32 output: O(S·D); the
    plain loop under autograd saves every chunk's scores: O(S²)."""
    rng = np.random.RandomState(2)
    B, S, Hkv, g, D = 1, 256, 2, 2, 8
    qg, k, v = (_t(rng.randn(*s).astype(np.float32)).requires_grad_()
                for s in ((B, S, Hkv, g, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    _, saved = _saved_bytes(lambda: attn.flash_attention(qg, k, v,
                                                         chunk=32))
    rows = B * S * Hkv * g
    want = 4 * (qg.numel() + k.numel() + v.numel() + 2 * rows + rows * D)
    assert saved == want

    def plain():
        kp, vp, chunk, n = attn._flash_prep(k, v, 32)
        _, l, acc = attn._flash_fwd_scan(qg, kp, vp, S, S, chunk, n, True,
                                         0, 0, 1 / np.sqrt(D))
        return acc / l[..., None]
    _, plain_saved = _saved_bytes(plain)
    assert plain_saved >= 4 * rows * S     # at least one f32 score per pair
    assert plain_saved > 10 * saved


# --------------------------------------------------------------------------
# C14: SSD's gradient at the published chunk
# --------------------------------------------------------------------------
def _ssd_inputs(S=512, H=4, P=8, N=16):
    """The reproduction's inputs: dt = softplus(N(0, 1)), A = -1."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(1, S, H))).astype(np.float32)
    A = -np.ones(H, np.float32)
    Bm = rng.randn(1, S, N).astype(np.float32)
    Cm = rng.randn(1, S, N).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    gy = rng.randn(1, S, H, P).astype(np.float32)
    return (x, dt, A, Bm, Cm, D), gy


def _exp_then_select(monkeypatch):
    """``ssd_chunked`` with its decay kernel built the old way,
    ``where(mask, exp(seg), 0)``: the module's ``torch`` seen through a
    shim whose ``where(mask, seg, -inf)`` selects after the exponential
    (``exp`` of that shim's result passes it on)."""
    class Old:
        pass

    class Shim:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def where(cond, a, b):
            if isinstance(b, float) and b == float("-inf"):
                old = Old()
                old.value = torch.where(cond, torch.exp(a), 0.0)
                return old
            return torch.where(cond, a, b)

        @staticmethod
        def exp(a):
            return a.value if isinstance(a, Old) else torch.exp(a)
    monkeypatch.setattr(ssm, "torch", Shim())


def test_ssd_chunk_256_keeps_its_forward_bits(monkeypatch):
    inputs, _ = _ssd_inputs()
    y, state = ssm.ssd_chunked(*map(_t, inputs), 256)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, inputs), 256)
    assert _rel_l2(y.numpy(), jy) <= 1e-5
    assert _rel_l2(state.numpy(), jstate) <= 1e-5
    _exp_then_select(monkeypatch)
    y_old, state_old = ssm.ssd_chunked(*map(_t, inputs), 256)
    assert torch.equal(y, y_old) and torch.equal(state, state_old)


def test_ssd_gradient_at_chunk_256_is_finite_and_matches_jax():
    inputs, gy = _ssd_inputs()

    def jloss(*args, chunk):
        return jnp.sum(jssm.ssd_chunked(*args, chunk)[0] * gy)
    jargs = tuple(map(jnp.asarray, inputs))
    want = jax.grad(lambda *a: jloss(*a, chunk=16),
                    argnums=tuple(range(6)))(*jargs)
    # the reference-side hazard: JAX's own dt gradient at chunk 256
    jax256 = jax.grad(lambda *a: jloss(*a, chunk=256), argnums=1)(*jargs)
    assert not np.isfinite(np.asarray(jax256)).all()
    live = [_t(a).requires_grad_() for a in inputs]
    y, _ = ssm.ssd_chunked(*live, 256)
    got = torch.autograd.grad(y, live, _t(gy))
    for name, a, b in zip(("x", "dt", "A", "B", "C", "D"), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel_l2(a.numpy(), b) <= 1e-4, (name, _rel_l2(a.numpy(), b))


def test_ssd_gradient_is_finite_at_every_chunk():
    inputs, gy = _ssd_inputs(S=256)
    for chunk in (16, 64, 128, 256):
        live = [_t(a).requires_grad_() for a in inputs]
        y, _ = ssm.ssd_chunked(*live, chunk)
        for gr in torch.autograd.grad(y, live, _t(gy)):
            assert torch.isfinite(gr).all(), chunk


# --------------------------------------------------------------------------
# C13: the serving cache under autograd
# --------------------------------------------------------------------------
def _mamba():
    _, cfg = _cfgs("mamba2-1.3b")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _port_batch(_arrays(cfg))
    return cfg, model, params, batch


def test_two_backward_passes_over_the_same_leaves():
    cfg, model, params, batch = _mamba()
    live = tree_util.tree_map(lambda a: a.detach().requires_grad_(), params)
    model.loss(live, batch)[0].backward()
    first = live["blocks"]["mixer"]["conv_w"].grad.clone()
    model.loss(live, batch)[0].backward()
    assert torch.equal(live["blocks"]["mixer"]["conv_w"].grad, 2 * first)
    # autograd's calls prepared inline and counted nothing
    assert serving_cache.stats() == {"hits": 0, "misses": 0, "prepares": 0,
                                     "evictions": 0, "size": 0}


def test_gradient_after_a_no_grad_forward_is_a_fresh_runs():
    cfg, model, params, batch = _mamba()
    _, fresh = _grads(model, params, batch)
    with torch.no_grad():
        model.loss(params, batch)
    assert serving_cache.stats()["size"] == cfg.n_layers
    _, after = _grads(model, params, batch)
    names = [p for p, _ in tree_util.flatten_with_path(params)]
    conv = names.index(("blocks", "mixer", "conv_w"))
    assert after[conv].abs().max() > 0
    for name, a, b in zip(names, fresh, after):
        assert torch.equal(a, b), name


def test_a_warm_serving_hit_still_hits():
    cfg, model, params, batch = _mamba()
    with torch.no_grad():
        y1 = model.forward(params, batch["tokens"])
    warm = serving_cache.stats()
    _grads(model, params, batch)
    with torch.no_grad():
        y2 = model.forward(params, batch["tokens"])
    after = serving_cache.stats()
    assert after["prepares"] == warm["prepares"] == cfg.n_layers
    assert after["hits"] == warm["hits"] + cfg.n_layers
    assert torch.equal(y1, y2)


# --------------------------------------------------------------------------
# per-layer remat
# --------------------------------------------------------------------------
def _family_model(family, **kw):
    jcfg, cfg = _cfgs(FAMILY_ARCHS[family], **kw)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    if cfg.family == "vlm":
        with torch.no_grad():
            params["cross_blocks"]["xattn"]["gate"].fill_(GATES["gate"])
            params["cross_blocks"]["ffn_gate"].fill_(GATES["ffn_gate"])
    return cfg, model, params, _port_batch(_arrays(cfg, seed=2))


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_remat_gives_the_same_loss_and_gradients(family, monkeypatch):
    cfg, model, params, batch = _family_model(family)
    orig = transformer.lm_hidden
    monkeypatch.setattr(transformer, "lm_hidden",
                        lambda *a, **k: orig(*a, **{**k, "remat": False}))
    (loss0, g0), saved0 = _saved_bytes(lambda: _grads(model, params, batch))
    monkeypatch.setattr(transformer, "lm_hidden", orig)
    runs = {}
    for policy in ("full", "dots"):
        monkeypatch.setenv(transformer.REMAT_POLICY_ENV, policy)
        runs[policy] = _saved_bytes(lambda: _grads(model, params, batch))
    for policy, ((loss, g), saved) in runs.items():
        assert torch.equal(loss, loss0), policy
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), policy
        # the layers' activations are the checkpoints' own, not autograd's
        assert saved < saved0, (policy, saved, saved0)


def test_serving_forward_is_not_rematerialised(monkeypatch):
    cfg, model, params, batch = _family_model("hybrid")
    want = model.forward(params, batch["tokens"])

    def refuse(*a, **k):
        raise AssertionError("a forward that records nothing checkpointed")
    monkeypatch.setattr(transformer.ckpt, "checkpoint", refuse)
    with torch.no_grad():
        got = model.forward(params, batch["tokens"])
    assert torch.equal(got, want)
    # a tree that requires no grad records nothing either
    assert torch.equal(model.forward(params, batch["tokens"]), want)


def test_recomputation_enters_the_fp32_guard(monkeypatch):
    """The checkpointed layer takes ``full_fp32_matmul`` inside itself, so
    its recomputation in the backward runs under the guard."""
    cfg, model, params, batch = _family_model("dense")
    entries = {"forward": 0, "backward": 0}
    phase = ["forward"]
    orig = transformer.full_fp32_matmul

    def counting():
        entries[phase[0]] += 1
        return orig()
    monkeypatch.setattr(transformer, "full_fp32_matmul", counting)
    live = tree_util.tree_map(lambda a: a.detach().requires_grad_(), params)
    loss, _ = model.loss(live, batch)
    phase[0] = "backward"
    torch.autograd.grad(loss, tree_util.leaves(live))
    assert entries["backward"] == cfg.n_layers


def test_remat_policy_is_full_or_dots(monkeypatch):
    monkeypatch.delenv(transformer.REMAT_POLICY_ENV, raising=False)
    assert transformer.remat_policy() == "full"
    monkeypatch.setenv(transformer.REMAT_POLICY_ENV, "dots")
    assert transformer.remat_policy() == "dots"
    monkeypatch.setenv(transformer.REMAT_POLICY_ENV, "offload")
    with pytest.raises(ValueError, match="full or dots"):
        transformer.remat_policy()


def test_a_backward_block_lets_other_threads_join():
    """Inside ``full_fp32_backward`` another thread's guard (autograd's
    device thread, in a backward on the card) enters at once, and the
    caller's setting comes back only after it has left."""
    matmul = torch.backends.cuda.matmul
    name, tf32, ieee = (("fp32_precision", "tf32", "ieee")
                        if hasattr(matmul, "fp32_precision")
                        else ("allow_tf32", True, False))
    before = getattr(matmul, name)
    joined, release, seen = threading.Event(), threading.Event(), []

    def other():
        with precision.full_fp32_matmul():
            joined.set()
            release.wait(10)
            seen.append(getattr(matmul, name))

    try:
        setattr(matmul, name, tf32)
        th = threading.Thread(target=other)
        with precision.full_fp32_backward():
            assert getattr(matmul, name) == ieee
            th.start()
            assert joined.wait(10)
            closer = threading.Timer(0.2, release.set)
            closer.start()
        assert not th.is_alive() or release.is_set()
        th.join(10)
        assert not th.is_alive()
        assert seen == [ieee]
        assert getattr(matmul, name) == tf32
    finally:
        release.set()
        setattr(matmul, name, before)
