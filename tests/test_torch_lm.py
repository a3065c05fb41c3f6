"""The port's LM serving path (``repro_torch.models``: layers, attention,
Mamba2 SSD, transformer, decode, registry) against the JAX package's.

The same numpy inputs, and the JAX package's parameters carried across by
``params_from_numpy``, go through both, in fp32 compute unless stated:

  * the primitives, the online-softmax attention (causal, sliding window,
    GQA, padded heads, q offsets, ragged chunks), ``decode_attention``
    (its ring buffer too) and ``cross_attention_block``: within 1e-5 or
    1e-4 as stated per test;
  * ``ssd_chunked`` (ragged S, ``init_state``), ``mamba2_block`` and
    ``mamba2_decode``: within 1e-4;
  * the smoke configs of every architecture (mamba2, zamba2, qwen3,
    qwen2.5, phi4-mini, stablelm, deepseek-v3, mixtral, llama-3.2-vision,
    whisper): ``init_lm``'s tree (paths, shapes, dtypes) equal to JAX's;
    forward logits, loss and the router's aux loss within 1e-4;
    teacher-forced decode within 1e-3 of the forward (JAX's own bound; the
    MoE forward lossless, as decode is); bf16 logits within twice JAX's own
    bf16-against-fp32 rel L2 of JAX's fp32 logits.  The vlm's gates start
    at zero, so its cross path is reached with gates 0.5 and -0.7 in both
    trees; the vlm and encdec take seeded vision embeddings and frames;
  * the serving cache: after ``warm_conv_plans`` a forward prepares
    nothing, and a forward on other weights (another tree, or the same
    tree updated in place) gives those weights' answer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models.transformer as jtfm  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.api import serving_cache, tuning  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.serve import warm_conv_plans  # noqa: E402
from repro_torch.models import LM, build  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers, moe, ssm, transformer  # noqa: E402

SERVED = ["mamba2-1.3b", "zamba2-1.2b", "qwen3-14b", "qwen2.5-32b",
          "phi4-mini-3.8b", "stablelm-3b", "deepseek-v3-671b",
          "mixtral-8x7b", "llama-3.2-vision-11b", "whisper-tiny"]
# the vlm's gates, set in both trees (both start at zero)
GATES = {"gate": 0.5, "ffn_gate": -0.7}
# a tiny dense config whose 24 query heads pad to 32 (phi4-mini's layout)
PADDED = dict(name="padded-smoke", family="dense", n_layers=2, d_model=32,
              n_heads=24, n_kv_heads=8, d_ff=64, vocab_size=256, head_dim=8)
WINDOWED = dict(name="window-smoke", family="dense", n_layers=2,
                d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
                vocab_size=512, head_dim=16, qk_norm=True, sliding_window=5)


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


@pytest.fixture(autouse=True)
def _isolated_port_tuning_cache(tmp_path):
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    yield
    tuning.set_cache_path(None)


def _cfgs(arch=None, **kw):
    """(JAX config, port config): a smoke config or ``kw`` alone, in fp32
    compute unless ``kw`` says otherwise."""
    kw = {"compute_dtype": "float32", **kw}
    if arch is None:
        return JModelConfig(**kw), ModelConfig(**kw)
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _carried(jparams):
    return params_from_numpy(jparams, "cpu")


def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S)
                                               ).astype(np.int32)


def _memory(cfg, B=2, S=16, seed=3):
    """The stub front end's output as tests/test_models.py draws it: vision
    embeddings (B, n_vision_tokens, d) for a vlm, frames (B, S, d) for an
    encdec, else None."""
    rng = np.random.RandomState(seed)
    if cfg.family == "vlm":
        return rng.randn(B, cfg.n_vision_tokens, cfg.d_model).astype(
            np.float32)
    if cfg.family == "encdec":
        return rng.randn(B, S, cfg.d_model).astype(np.float32)
    return None


def _jmem(mem):
    return None if mem is None else jnp.asarray(mem)


def _tmem(mem):
    return None if mem is None else _t(mem)


def _batch_of(cfg, toks, labels, mem):
    key = {"vlm": "vision", "encdec": "frames"}.get(cfg.family)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    b = {"tokens": _t(toks), "labels": _t(labels)}
    if key:
        jb[key], b[key] = jnp.asarray(mem), _t(mem)
    return jb, b


def _set_gates(jp):
    """The vlm's cross-attention and FFN gates, nonzero."""
    cross = jp["cross_blocks"]
    cross["xattn"]["gate"] = jnp.full_like(cross["xattn"]["gate"],
                                           GATES["gate"])
    cross["ffn_gate"] = jnp.full_like(cross["ffn_gate"], GATES["ffn_gate"])
    return jp


@pytest.fixture
def lossless():
    """Both packages' MoE FFN at capacity E / k: no token dropped, as the
    decode step runs it (tests/test_models.py's test_decode_matches_forward
    patches the JAX module the same way)."""
    jorig, orig = jmoe.moe_block, moe.moe_block
    jmoe.moe_block = lambda p, c, x, capacity_factor=None: jorig(
        p, c, x, capacity_factor=c.n_experts / max(c.n_experts_active, 1))
    jtfm.moe.moe_block = jmoe.moe_block
    moe.moe_block = lambda p, c, x, capacity_factor=None: orig(
        p, c, x, capacity_factor=c.n_experts / max(c.n_experts_active, 1))
    yield
    jmoe.moe_block = jtfm.moe.moe_block = jorig
    moe.moe_block = orig


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        jc, c = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        assert dataclasses.asdict(jc) == dataclasses.asdict(c)
        assert (jc.param_count(), jc.active_param_count(), jc.padded_vocab) \
            == (c.param_count(), c.active_param_count(), c.padded_vocab)
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.cells() == jconfigs.cells()
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["rmsnorm", "swiglu", "rope", "ce",
                                "ce_masked"])
def test_layers_match_jax(fn):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    if fn == "rmsnorm":
        s = rng.randn(16).astype(np.float32)
        got = layers.rmsnorm(_t(x), _t(s), 1e-5)
        want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5)
    elif fn == "swiglu":
        w = [rng.randn(*shape).astype(np.float32) * 0.3
             for shape in ((16, 24), (16, 24), (24, 16))]
        got = layers.swiglu(_t(x), *map(_t, w))
        want = jlayers.swiglu(jnp.asarray(x), *map(jnp.asarray, w))
    elif fn == "rope":
        pos = rng.randint(0, 500, (2, 7)).astype(np.int32)
        got = layers.apply_rope(_t(x), _t(pos), 1e6)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    else:
        logits = rng.randn(2, 7, 50).astype(np.float32) * 3
        labels = rng.randint(0, 50, (2, 7)).astype(np.int32)
        mask = (rng.rand(2, 7) > 0.3).astype(np.float32) \
            if fn == "ce_masked" else None
        got = layers.cross_entropy_loss(
            _t(logits), _t(labels), None if mask is None else _t(mask))
        want = jlayers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))
    _close(got, want, 1e-5)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("Hkv,g,Dv,causal,window,q_offset,chunk", [
    (2, 2, 16, True, 0, 0, 8), (4, 1, 8, True, 0, 0, 16),
    (2, 2, 16, True, 7, 0, 8), (1, 4, 32, True, 0, 0, 33),
    (2, 1, 16, False, 0, 0, 10), (2, 2, 16, True, 0, 5, 8)])
def test_flash_attention_matches_jax(Hkv, g, Dv, causal, window, q_offset,
                                     chunk):
    rng = np.random.RandomState(0)
    B, Sq, Sk, D = 2, 28 if q_offset else 33, 33, 16
    qg = rng.randn(B, Sq, Hkv, g, D).astype(np.float32)
    k = rng.randn(B, Sk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Sk, Hkv, Dv).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)
    got = attn.flash_attention(_t(qg), _t(k), _t(v), **kw)
    want = jattn.flash_attention(jnp.asarray(qg), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    _close(got, want, 1e-5)


def _attn_params(jcfg, seed=0):
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.RandomState(seed)
    # the JAX init zeroes the biases and sets the norms to one: give them
    # values, the same on both sides, so the test reaches them
    for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if k in jp:
            jp[k] = jnp.asarray(1.0 * (k.endswith("norm"))
                                + 0.1 * rng.randn(*jp[k].shape),
                                jnp.float32)
    return jp, _carried(jp)


ATTN_CFGS = {"qwen3": ("qwen3-14b", {}), "qwen2.5": ("qwen2.5-32b", {}),
             "padded": (None, PADDED), "window": (None, WINDOWED)}


@pytest.mark.parametrize("which", list(ATTN_CFGS))
def test_attention_block_matches_jax(which):
    arch, kw = ATTN_CFGS[which]
    jcfg, cfg = _cfgs(arch, **kw)
    jp, p = _attn_params(jcfg)
    gen = torch.Generator().manual_seed(0)
    own = attn.init_attention(gen, cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    if which == "padded":
        assert jp["wq"].shape[1] == 32 and jp["wo"].shape[0] == 32
        assert not own["wo"][24:].any() and not own["wq"][:, 24:].any()
    rng = np.random.RandomState(2)
    S = 13
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    got = attn.attention_block(p, cfg, _t(x), _t(pos))
    want = jattn.attention_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("which", ["padded", "window"])
def test_decode_attention_matches_jax(which):
    """Step by step over 11 tokens: outputs and caches; the window's ring
    buffer (5 slots) wraps twice."""
    jcfg, cfg = _cfgs(None, **ATTN_CFGS[which][1])
    jp, p = _attn_params(jcfg, seed=1)
    rng = np.random.RandomState(3)
    B, S = 2, 11
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    jc = jattn.init_kv_cache(jcfg, B, S, jnp.float32)
    c = attn.init_kv_cache(cfg, B, S, torch.float32, "cpu")
    assert c["k"].shape == jc["k"].shape
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        jo, jc = jattn.decode_attention(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                        jc, jnp.asarray(pos))
        o, c = attn.decode_attention(p, cfg, _t(x[:, t:t + 1]), c, _t(pos))
        _close(o, jo, 1e-5)
    _close(c["k"], jc["k"], 1e-5)
    _close(c["v"], jc["v"], 1e-5)


@pytest.mark.parametrize("gated", [False, True])
def test_cross_attention_matches_jax(gated):
    jcfg, cfg = _cfgs("qwen3-14b")
    jp = jattn.init_cross_attention(jax.random.PRNGKey(4), jcfg, jnp.float32)
    jp["gate"] = jnp.asarray(0.7, jnp.float32)
    p = _carried(jp)
    own = attn.init_cross_attention(torch.Generator().manual_seed(0), cfg,
                                    torch.float32)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, cfg.d_model).astype(np.float32)
    mem = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    got = attn.cross_attention_block(p, cfg, _t(x), _t(mem), gated=gated)
    want = jattn.cross_attention_block(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(mem), gated=gated)
    _close(got, want, 1e-5)


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk,with_state", [(37, 16, False),
                                                (32, 16, False),
                                                (37, 16, True),
                                                (5, 8, True)])
def test_ssd_chunked_matches_jax(S, chunk, with_state):
    rng = np.random.RandomState(S + chunk)
    B, H, P, N = 2, 4, 8, 16
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = -np.exp(rng.randn(H) * 0.5).astype(np.float32)
    Bm = rng.randn(B, S, N).astype(np.float32)
    Cm = rng.randn(B, S, N).astype(np.float32)
    D = rng.randn(H).astype(np.float32)
    st = rng.randn(B, H, P, N).astype(np.float32) if with_state else None
    y, fs = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(D),
                            chunk, None if st is None else _t(st))
    jy, jfs = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)),
                               chunk,
                               None if st is None else jnp.asarray(st))
    assert y.shape == (B, S, H, P) and fs.shape == (B, H, P, N)
    _close(y, jy, 1e-4)
    _close(fs, jfs, 1e-4)


def _mamba_params(jcfg):
    jp = jssm.init_mamba2(jax.random.PRNGKey(6), jcfg, jnp.float32)
    rng = np.random.RandomState(6)
    H = jcfg.ssm_heads
    jp["A_log"] = jnp.asarray(rng.randn(H) * 0.5, jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.randn(H) * 0.5, jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.randn(*jp["conv_b"].shape) * 0.1,
                               jnp.float32)
    return jp, _carried(jp)


@pytest.mark.parametrize("use_sfc", [True, False])
def test_mamba2_block_and_decode_match_jax(use_sfc):
    jcfg, cfg = _cfgs("mamba2-1.3b", use_sfc_conv=use_sfc)
    jp, p = _mamba_params(jcfg)
    own = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg,
                          torch.float32)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    rng = np.random.RandomState(7)
    B, S = 2, 21
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    y = ssm.mamba2_block(p, cfg, _t(x))
    _close(y, jssm.mamba2_block(jp, jcfg, jnp.asarray(x)), 1e-4)
    jc = jssm.init_mamba2_cache(jcfg, B, jnp.float32)
    c = ssm.init_mamba2_cache(cfg, B, torch.float32, "cpu")
    for t in range(S):
        jo, jc = jssm.mamba2_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        o, c = ssm.mamba2_decode(p, cfg, _t(x[:, t:t + 1]), c)
        _close(o, jo, 1e-4)
        _close(o[:, 0], y[:, t], 1e-3)
    _close(c["state"], jc["state"], 1e-4)
    _close(c["conv"], jc["conv"], 1e-5)


# --------------------------------------------------------------------------
# whole models on the smoke configs
# --------------------------------------------------------------------------
def _models(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jm, m = jbuild(jcfg), build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if cfg.family == "vlm":
        jp = _set_gates(jp)
    return jcfg, cfg, jm, m, jp, _carried(jp)


@pytest.mark.parametrize("arch", SERVED)
def test_init_lm_tree_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    p = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")

    def layout(leaves):
        return [("/".join(map(str, path)), tuple(a.shape), str(a.dtype))
                for path, a in leaves]
    jleaves = [(tuple(k.key for k in path), a) for path, a in
               jax.tree_util.tree_leaves_with_path(jp)]
    want = layout(jleaves)
    got = [(path, shape, dtype.replace("torch.", "")) for path, shape, dtype
           in layout(tree_util.flatten_with_path(p))]
    assert got == want


@pytest.mark.parametrize("arch", SERVED)
def test_forward_and_loss_match_jax(arch):
    jcfg, cfg, jm, m, jp, p = _models(arch)
    toks = _tokens(cfg)
    labels = _tokens(cfg, seed=1)
    mem = _memory(cfg)
    logits = m.forward(p, _t(toks), _tmem(mem))
    jlogits = jax.jit(jm.forward)(jp, jnp.asarray(toks), _jmem(mem))
    assert logits.shape == (2, 16, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, 1e-4)
    jbatch, batch = _batch_of(cfg, toks, labels, mem)
    loss, metrics = m.loss(p, batch)
    jloss, jmetrics = jm.loss(jp, jbatch)
    _close(loss, jloss, 1e-4)
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], 1e-4)
    # the router's aux loss is the JAX package's, nonzero for moe
    assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", SERVED)
def test_decode_matches_forward(arch, lossless):
    """Teacher-forced decode against the forward, within 1e-3 (the bound of
    tests/test_models.py's test_decode_matches_forward; its MoE forward is
    lossless, as decode is)."""
    jcfg, cfg, jm, m, jp, p = _models(arch)
    B, S = 2, 12
    toks = _tokens(cfg, B, S)
    mem = _memory(cfg, B, S)
    full = m.forward(p, _t(toks), _tmem(mem))
    cache = m.init_cache(p, B, S, _tmem(mem))
    jcache = jm.init_cache(jp, B, S, _jmem(mem))
    assert [tuple(a.shape) for a in tree_util.leaves(cache)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jcache)]
    outs = []
    for t in range(S):
        lg, cache = m.decode_step(p, cache, _t(toks[:, t:t + 1]),
                                  torch.full((B,), t, dtype=torch.int32))
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    assert float((full - dec).abs().max()) < 1e-3
    _close(dec, jm.forward(jp, jnp.asarray(toks), _jmem(mem)), 1e-3)


@pytest.mark.parametrize("arch", SERVED)
def test_bf16_within_jax_spread(arch):
    """bf16 compute: JAX's and PyTorch's bf16 products do not round alike,
    so the port's bf16 logits are held to twice JAX's own rel L2 between
    its bf16 and fp32 logits."""
    jcfg, cfg, jm, m, jp, p = _models(arch, compute_dtype="bfloat16")
    toks = _tokens(cfg)
    mem = _memory(cfg)
    j32 = np.asarray(jax.jit(jbuild(dataclasses.replace(
        jcfg, compute_dtype="float32")).forward)(jp, jnp.asarray(toks),
                                                 _jmem(mem)))
    spread = _rel_l2(jax.jit(jm.forward)(jp, jnp.asarray(toks), _jmem(mem)),
                     j32)
    got = _rel_l2(m.forward(p, _t(toks), _tmem(mem)), j32)
    assert 0 < spread and got <= 2 * spread, (got, spread)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_mamba_sfc_conv_equals_direct_path(arch):
    """tests/test_models.py's test of the same name on the port."""
    jcfg, cfg = _cfgs(arch)
    p = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    toks = _t(_tokens(cfg, 2, 32))
    y1 = build(cfg).forward(p, toks)
    y2 = build(dataclasses.replace(cfg, use_sfc_conv=False)).forward(p, toks)
    _close(y1, y2, 1e-4)


def test_sliding_window_restricts_context():
    """tests/test_models.py's test of the same name on the port."""
    _, cfg = _cfgs("qwen3-14b", sliding_window=4, n_layers=1)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    t1 = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (1, 12)))
    t2 = t1.clone()
    t2[0, 0] = (t1[0, 0] + 1) % 64
    l1, l2 = model.forward(params, t1), model.forward(params, t2)
    _close(l1[0, -1], l2[0, -1], 1e-4)
    t3 = t1.clone()
    t3[0, 11] = (t1[0, 11] + 1) % 64
    assert float((l1[0, -1] - model.forward(params, t3)[0, -1]).abs().max()) \
        > 1e-4


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_serving_cache_warm_hits_and_new_weights_miss(arch):
    jcfg, cfg, jm, m, jp, p = _models(arch)
    B, S = 2, 16
    toks = _tokens(cfg, B, S)
    stats = warm_conv_plans(cfg, p, B, S)
    assert stats["size"] == stats["prepares"] == cfg.n_layers
    assert warm_conv_plans(cfg, p, B, S)["prepares"] == cfg.n_layers
    logits = m.forward(p, _t(toks))
    after = serving_cache.stats()
    assert after["prepares"] == cfg.n_layers        # the forward prepared none
    assert after["hits"] == stats["hits"] + 2 * cfg.n_layers
    _close(logits, jax.jit(jm.forward)(jp, jnp.asarray(toks)), 1e-4)
    # another tree: its own weights' answer
    jp2 = jm.init(jax.random.PRNGKey(1))
    _close(m.forward(_carried(jp2), _t(toks)),
           jax.jit(jm.forward)(jp2, jnp.asarray(toks)), 1e-4)
    # the same tree updated in place: prepared anew
    conv_w = p["blocks"]["mixer"]["conv_w"]
    with torch.no_grad():
        conv_w.mul_(-0.5)
    jp3 = dict(jp, blocks=dict(jp["blocks"], mixer=dict(
        jp["blocks"]["mixer"], conv_w=jp["blocks"]["mixer"]["conv_w"] * -0.5)))
    before = serving_cache.stats()["prepares"]
    _close(m.forward(p, _t(toks)),
           jax.jit(jm.forward)(jp3, jnp.asarray(toks)), 1e-4)
    assert serving_cache.stats()["prepares"] == before + cfg.n_layers


def test_compute_copy_is_made_once_per_tree_version():
    _, cfg = _cfgs("qwen3-14b", compute_dtype="bfloat16")
    p = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    c1 = transformer.cast_compute(p, cfg)
    assert c1 is transformer.cast_compute(p, cfg)
    assert c1["embed"].dtype == torch.bfloat16
    with torch.no_grad():
        p["embed"].add_(1.0)
    c2 = transformer.cast_compute(p, cfg)
    assert c2 is not c1
    assert torch.equal(c2["embed"], p["embed"].to(torch.bfloat16))
    # an fp32 compute config reads the tree itself
    _, cfg32 = _cfgs("qwen3-14b")
    assert transformer.cast_compute(p, cfg32) is p


def test_params_from_numpy_keeps_bf16():
    jcfg, _ = _cfgs("mamba2-1.3b", param_dtype="bfloat16")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    p = params_from_numpy(jp, "cpu")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            tree_util.leaves(p)):
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).replace("torch.", "") == str(a.dtype), path
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama-3.2-vision-11b"])
def test_params_from_numpy_carries_gates_and_bf16_experts(arch):
    """deepseek-v3's bf16 trees (its experts, MLA, MTP head) and the vlm's
    0-d gates cross unchanged, leaf for leaf."""
    jcfg, _ = _cfgs(arch, param_dtype="bfloat16")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    if jcfg.family == "vlm":
        jp = _set_gates(jp)
    p = params_from_numpy(jp, "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    leaves = tree_util.flatten_with_path(p)
    for (jpath, a), (path, b) in zip(jleaves, leaves):
        assert tuple(k.key for k in jpath) == path
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).replace("torch.", "") == str(a.dtype), path
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    assert len(jleaves) == len(tree_util.leaves(p))
    if jcfg.family == "vlm":
        assert p["cross_blocks"]["ffn_gate"].shape == (2,)
        assert float(p["cross_blocks"]["xattn"]["gate"][0]) == GATES["gate"]


def test_lm_module_holds_the_tree():
    jcfg, cfg, jm, m, jp, p = _models("zamba2-1.2b")
    lm = LM(cfg, p)
    assert "blocks.mixer.conv_w" in lm.state_dict()
    assert not any(q.requires_grad for q in lm.parameters())
    toks = _t(_tokens(cfg, 2, 8))
    _close(lm(toks), m.forward(p, toks), 0)
    cache = lm.init_cache(2, 8)
    lg, cache = lm.decode_step(cache, toks[:, :1],
                               torch.zeros(2, dtype=torch.int32))
    assert lg.shape == (2, 1, cfg.padded_vocab)
