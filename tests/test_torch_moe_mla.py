"""The port's MoE FFN, MLA, cross-attention decode, whisper encoder, MTP
loss and vlm forward (``repro_torch.models``) against the JAX package's.

The same numpy inputs, and the JAX package's parameters carried across by
``params_from_numpy``, go through both in fp32, held within 1e-4:

  * ``moe_block`` at capacity factors 1.25, 0.5 (tokens dropped) and
    E / k (lossless), with the shared expert (deepseek-v3's smoke config)
    and without (mixtral's); a router with planted ties, which the JAX
    ``top_k`` breaks to the lower expert; the aux loss;
  * ``mla_block``, ``init_mla_cache`` and the absorbed ``mla_decode``, and
    decode against the prefill block (1e-3);
  * ``decode._cross_decode``, ``encoder_forward``, the MTP term of
    ``lm_loss`` and the vlm forward with its gates nonzero;
  * ``launch.serve.main`` serves 12 requests of each of the four smoke
    configs on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build, decode, mla, moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

TOL = 1e-4
MOE_ARCHS = ["deepseek-v3-671b", "mixtral-8x7b"]


@pytest.fixture(autouse=True)
def _isolated():
    yield
    transformer.clear_compute_cache()


def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # a router of unit scale: sharper routing, so capacity decides drops
    jp["router"] = jnp.asarray(_randn(seed + 1, *jp["router"].shape))
    return jp


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("capacity", ["1.25", "0.5", "lossless"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax(arch, capacity):
    jcfg, cfg = _cfgs(arch)
    jp = _moe_params(jcfg)
    own = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in own.items() if k != "shared"} \
        == {k: tuple(v.shape) for k, v in jp.items() if k != "shared"}
    assert ("shared" in own) == ("shared" in jp) \
        == bool(cfg.n_shared_experts)
    cf = (cfg.n_experts / cfg.n_experts_active if capacity == "lossless"
          else float(capacity))
    x = _randn(2, 2, 16, cfg.d_model)
    out, aux = moe.moe_block(params_from_numpy(jp, "cpu"), cfg, _t(x),
                             capacity_factor=cf)
    jout, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    assert out.shape == x.shape and out.dtype == torch.float32
    _close(out, jout)
    _close(aux, jaux, 1e-6)
    if capacity == "0.5":
        # tokens went over capacity: the lossless answer differs
        full, _ = moe.moe_block(params_from_numpy(jp, "cpu"), cfg, _t(x),
                                capacity_factor=cfg.n_experts
                                / cfg.n_experts_active)
        assert float((full - out).abs().max()) > 1e-3


def test_top_k_breaks_ties_to_the_lower_index():
    rng = np.random.RandomState(3)
    # few distinct values over 256 experts: many ties, at the top too
    probs = rng.randint(0, 4, (64, 256)).astype(np.float32) / 4
    vals, idx = moe._top_k(_t(probs), 8)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("capacity", [0.5, 1.25])
def test_router_ties_dispatch_as_jax(capacity):
    """Experts 2k and 2k + 1 share a router column: every token's
    probabilities tie in pairs, and which of a tied pair a token goes to
    (and so which tokens go over capacity) is JAX's choice."""
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jp = _moe_params(jcfg, seed=4)
    r = np.asarray(jp["router"]).copy()
    r[:, 1::2] = r[:, 0::2]
    jp["router"] = jnp.asarray(r)
    x = _randn(5, 2, 16, cfg.d_model)
    out, aux = moe.moe_block(params_from_numpy(jp, "cpu"), cfg, _t(x),
                             capacity_factor=capacity)
    jout, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x),
                                capacity_factor=capacity)
    _close(out, jout)
    _close(aux, jaux, 1e-6)
    # the tied pairs: the top expert of every token is the even one
    logits = (_t(x).reshape(-1, cfg.d_model) @ _t(r)).float()
    _, ids = moe._top_k(torch.softmax(logits, -1), cfg.n_experts_active)
    assert bool((ids[:, 0] % 2 == 0).all())


def test_aux_loss_matches_jax_under_skewed_routing():
    jcfg, cfg = _cfgs("mixtral-8x7b")
    jp = _moe_params(jcfg, seed=6)
    r = np.asarray(jp["router"]).copy()
    r[:, 0] += 2.0        # expert 0 takes most tokens first
    jp["router"] = jnp.asarray(r)
    x = np.abs(_randn(7, 3, 11, cfg.d_model))
    _, aux = moe.moe_block(params_from_numpy(jp, "cpu"), cfg, _t(x))
    _, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x))
    _close(aux, jaux, 1e-6)
    assert float(aux) > 1.0       # balanced routing gives 1


def test_moe_combine_replays_bit_for_bit():
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    p = params_from_numpy(_moe_params(jcfg), "cpu")
    x = _t(_randn(8, 2, 16, cfg.d_model))
    a, _ = moe.moe_block(p, cfg, x)
    b, _ = moe.moe_block(p, cfg, x)
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------
def _mla_params(jcfg, seed=0):
    jp = jmla.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.RandomState(seed)
    for k in ("q_a_norm", "kv_a_norm"):
        jp[k] = jnp.asarray(1.0 + 0.1 * rng.randn(*jp[k].shape), jnp.float32)
    return jp, params_from_numpy(jp, "cpu")


def test_mla_block_matches_jax():
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jp, p = _mla_params(jcfg)
    own = mla.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    B, S = 2, 13
    x = _randn(9, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    got = mla.mla_block(p, cfg, _t(x), _t(pos))
    want = jmla.mla_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want)


def test_mla_decode_matches_jax_and_the_block():
    """Step by step over 11 tokens: outputs and latent caches against JAX,
    and the absorbed decode against the expanded prefill block (1e-3)."""
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jp, p = _mla_params(jcfg, seed=1)
    B, S = 2, 11
    x = _randn(10, B, S, cfg.d_model)
    pos_all = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    block = mla.mla_block(p, cfg, _t(x), _t(pos_all))
    jc = jmla.init_mla_cache(jcfg, B, S, jnp.float32)
    c = mla.init_mla_cache(cfg, B, S, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jo, jc = jmla.mla_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc,
                                 jnp.asarray(pos))
        o, c = mla.mla_decode(p, cfg, _t(x[:, t:t + 1]), c, _t(pos))
        _close(o, jo)
        _close(o[:, 0], block[:, t], 1e-3)
    _close(c["c_kv"], jc["c_kv"])
    _close(c["k_rope"], jc["k_rope"])


# --------------------------------------------------------------------------
# cross-attention decode, encoder, MTP, vlm
# --------------------------------------------------------------------------
def _models(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, cfg, jm, build(cfg), jp


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cross_decode_matches_jax(arch):
    jcfg, cfg, jm, m, jp = _models(arch)
    p = params_from_numpy(jp, "cpu")
    xp = jax.tree_util.tree_map(lambda a: a[0], jp["cross_blocks"])
    own = transformer.layer(p["cross_blocks"], 0)
    B = 2
    mem = _randn(11, B, 9, cfg.d_model)
    x = _randn(12, B, 1, cfg.d_model)
    jk, jv = jdecode._cross_kv(xp["xattn"], jcfg, jnp.asarray(mem))
    k, v = decode._cross_kv(own["xattn"], cfg, _t(mem))
    _close(k, jk, 1e-5)
    _close(v, jv, 1e-5)
    got = decode._cross_decode(_t(x), own["ln"], own["xattn"], cfg, k, v)
    want = jdecode._cross_decode(jnp.asarray(x), xp["ln"], xp["xattn"],
                                 jcfg, jk, jv)
    _close(got, want)


def test_encoder_forward_matches_jax():
    jcfg, cfg, jm, m, jp = _models("whisper-tiny")
    frames = _randn(13, 2, 17, cfg.d_model)
    got = transformer.encoder_forward(params_from_numpy(jp, "cpu"), cfg,
                                      _t(frames))
    want = jtfm.encoder_forward(jp, jcfg, jnp.asarray(frames))
    assert got.shape == (2, 17, cfg.d_model)
    _close(got, want)


def test_mtp_term_matches_jax():
    jcfg, cfg, jm, m, jp = _models("deepseek-v3-671b")
    assert cfg.mtp_depth
    rng = np.random.RandomState(14)
    toks = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    loss, metrics = m.loss(params_from_numpy(jp, "cpu"),
                           {"tokens": _t(toks), "labels": _t(labels)})
    jloss, jmetrics = jm.loss(jp, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)})
    _close(metrics["mtp"], jmetrics["mtp"])
    _close(metrics["ce"], jmetrics["ce"])
    _close(loss, jloss)
    # the loss is ce + 0.3 mtp + the aux term
    _close(loss, metrics["ce"] + 0.3 * metrics["mtp"]
           + cfg.router_aux_coef * metrics["aux"], 1e-6)


def test_vlm_forward_with_gates_matches_jax():
    """The gates start at zero, where a wrong cross path would pass: set
    them to 0.5 (attention) and -0.7 (FFN) in both trees."""
    jcfg, cfg, jm, m, jp = _models("llama-3.2-vision-11b")
    toks = np.random.RandomState(15).randint(0, cfg.vocab_size, (2, 10))
    vision = _randn(16, 2, cfg.n_vision_tokens, cfg.d_model)
    closed = m.forward(params_from_numpy(jp, "cpu"), _t(toks), _t(vision))
    cross = jp["cross_blocks"]
    cross["xattn"]["gate"] = jnp.full_like(cross["xattn"]["gate"], 0.5)
    cross["ffn_gate"] = jnp.full_like(cross["ffn_gate"], -0.7)
    got = m.forward(params_from_numpy(jp, "cpu"), _t(toks), _t(vision))
    want = jm.forward(jp, jnp.asarray(toks), jnp.asarray(vision))
    _close(got, want)
    assert float((got - closed).abs().max()) > 1e-2


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x7b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_serve_main_serves_the_smoke_config_on_cpu(arch):
    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert stats.served == 12 and stats.steps > 0
    cfg = configs.get_smoke_config(arch)
    mem = serve.stub_memory(cfg, 4, 128, "cpu")
    want = {"vlm": (4, cfg.n_vision_tokens, cfg.d_model),
            "encdec": (4, 128, cfg.d_model)}.get(cfg.family)
    assert (None if mem is None else tuple(mem.shape)) == want
