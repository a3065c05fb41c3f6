"""The sharded serve and prefill steps (``repro_torch.distributed.
serve_spmd``) against the JAX package's single-device ``decode_step`` and
``forward``.

JAX's sharded paths fail on JAX 0.9 (ROADMAP, C5), so the reference is
its single-device step on the same numpy inputs: the smoke configs in
fp32, weights carried across by ``params_from_numpy``, a batch of 4 whose
rows start at staggered positions in caches pre-filled with seeded N(0, 1)
entries (the SSM states too; the cross K/V as ``init_cache`` computes
them), so that a few steps cross every ``'model'`` block boundary and
wrap mixtral's ring buffer (window 32).  On CPU meshes (1, 1), (2, 1),
(1, 2), (2, 2), (1, 4) and (1, 8) (mixtral's 4 experts on 8 blocks: the
experts' ``f`` split within each expert; deepseek's heads cut by the
blocks' edges):

  * each teacher-forced step's logits within 1e-5 rel L2 of JAX's, and
    each cache entry, gathered after the last step, within 1e-5 of JAX's;
    the logits and the next tokens placed as JAX's compiled steps place
    them (``serve_spmd.logits_spec``, ``batch_spec``: each coordinate
    holds its block, ``testing.assert_placed``), read through
    ``Sharded.gather``;
  * on (1, 1), logits (the one block) and cache bit for bit the port's
    unsharded step;
  * every cache block keeps its device and its memory across the steps,
    and the step copies no cache byte;
  * the weight bytes copied are exactly the all-gather over the data
    axes of the leaves the step reads (0 on one data row): each weight
    block computes where it lies;
  * the sharded prefill within 1e-5 of JAX's forward (the MoE dispatch in
    as many chunks as the mesh has data rows, as JAX's ``data_shards``),
    it and ``init_cache`` (the encoder, the cross K/V) run with every
    whole gather of a model-split leaf made to raise;
  * ``cache_shardings`` equal to JAX's sanitized ``cache_pspecs``.

Beside them: the decode steps and the prefill gather no model-split leaf
whole (a guard on every whole gather raises for one; the train step's
test is ``test_torch_lm_spmd_families.py``'s), two runs of the steps
bit for bit equal, ``init_params`` drawing the unsharded tree without
holding a drawn layer past its placement, batch 1 on (2, 1) (the batch
replicated), copies of a
block in other memory written alike, a first step whose only valid key
lies in the first block, and the refusals.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.distributed import act_sharding as jacts  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.api import serving_cache  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import (lm_spmd, model_split,  # noqa: E402
                                     serve_spmd, sharding)
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_forced_host_mesh  # noqa: E402
from repro_torch.models import build, transformer  # noqa: E402
from repro_torch.testing import assert_placed  # noqa: E402
from repro_torch.train import (make_prefill_step,  # noqa: E402
                               make_serve_step)
from test_torch_lm_spmd import no_whole_gathers  # noqa: E402

ARCHS = ("phi4-mini-3.8b", "mamba2-1.3b", "zamba2-1.2b", "mixtral-8x7b",
         "deepseek-v3-671b", "llama-3.2-vision-11b", "whisper-tiny")
MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (1, 8))
REL = 1e-5
GATES = {"gate": 0.5, "ffn_gate": -0.7}
B, L, STEPS = 4, 32, 4
# each row's first position: 4 steps cross the blocks' edges at 8, 16 and
# 24 (mixtral's ring of 32, from a max_len of 64: one row wraps, one has)
STARTS = {None: (5, 13, 21, 27), "ring": (5, 13, 30, 45)}
PREFILL_S = 8


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


def _cfgs(arch):
    kw = {"compute_dtype": "float32"}
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(configs.get_smoke_config(arch), **kw))


def _max_len(cfg) -> int:
    return 2 * L if cfg.sliding_window else L


def _memory(cfg, batch, rng):
    if cfg.family == "vlm":
        return rng.randn(batch, cfg.n_vision_tokens, cfg.d_model).astype(
            np.float32)
    if cfg.family == "encdec":
        return rng.randn(batch, 12, cfg.d_model).astype(np.float32)
    return None


def _is_cross(path) -> bool:
    return path[0] in ("cross_k", "cross_v")


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
def _params(arch):
    return params_from_numpy(_jax_params(arch), "cpu")


@functools.lru_cache(maxsize=None)
def reference(arch, batch=B, starts=None):
    """JAX's single-device decode from a pre-filled cache: the inputs (the
    tokens of each step, the first positions, the memory, the filled
    cache's leaves) and, as numpy, each step's logits and the final
    cache's leaves."""
    jcfg, cfg = _cfgs(arch)
    jm, jp = jbuild(jcfg), _jax_params(arch)
    rng = np.random.RandomState(7)
    mem = _memory(cfg, batch, rng)
    cache = jm.init_cache(jp, batch, _max_len(cfg),
                          None if mem is None else jnp.asarray(mem))
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(cache)]
    filled = [np.asarray(a) if _is_cross(p)
              else rng.randn(*a.shape).astype(np.asarray(a).dtype)
              for p, a in zip(paths, jax.tree_util.tree_leaves(cache))]
    tokens = rng.randint(0, cfg.vocab_size, (STEPS, batch, 1)).astype(
        np.int32)
    if starts is None:
        starts = STARTS["ring" if cfg.sliding_window else None][:batch]
    pos0 = np.asarray(starts, np.int32)
    jc = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(cache),
                                      [jnp.asarray(a) for a in filled])
    step = jax.jit(jm.decode_step)
    logits = []
    for t in range(STEPS):
        lg, jc = step(jp, jc, jnp.asarray(tokens[t]),
                      jnp.asarray(pos0 + t))
        logits.append(np.asarray(lg))
    return {"tokens": tokens, "pos0": pos0, "memory": mem,
            "filled": filled, "logits": logits,
            "final": [np.asarray(a) for a in jax.tree_util.tree_leaves(jc)]}


@functools.lru_cache(maxsize=None)
def jax_forward(arch, n):
    """JAX's forward over PREFILL_S tokens of the batch with the MoE
    dispatch in ``n`` chunks (``data_shards``)."""
    jcfg, cfg = _cfgs(arch)
    rng = np.random.RandomState(11)
    toks = rng.randint(0, cfg.vocab_size, (B, PREFILL_S)).astype(np.int32)
    mem = _memory(cfg, B, rng)
    orig = jacts.data_shards
    jacts.data_shards = lambda: n
    try:
        logits = jbuild(jcfg).forward(_jax_params(arch), jnp.asarray(toks),
                                      None if mem is None
                                      else jnp.asarray(mem))
    finally:
        jacts.data_shards = orig
    return toks, mem, np.asarray(logits)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _placed(arch, mesh):
    _, cfg = _cfgs(arch)
    model = build(cfg)
    return model, sharding.place(_params(arch),
                                 serve_spmd.param_shardings(model, mesh))


def _fill(cache, values, mesh=None):
    """Copy the filled leaves into a cache, placed (each block from its
    slice) or not; the cross K/V, computed by ``init_cache``, stay."""
    for (path, leaf), v in zip(tree_util.flatten_with_path(cache), values):
        if _is_cross(path):
            continue
        full = torch.from_numpy(v)
        if mesh is None:
            leaf.copy_(full)
            continue
        for idx, coords in leaf.unique().items():
            for c in coords:
                leaf.shards[c].copy_(
                    sharding.block_of(full, leaf.spec, mesh, idx))


def _blocks(cache):
    """(device, data_ptr) of every block of every cache leaf."""
    return [(str(b.device), b.data_ptr()) for sh in tree_util.leaves(cache)
            for b in sh.shards.flat]


# what a decode step reads: the top-level entries, less the cross K/V
# projections (``init_cache`` computes the cross cache from them)
DECODE_KEYS = ("embed", "final_norm", "lm_head", "blocks", "dense_blocks",
               "cross_blocks", "shared_block")
INIT_ONLY = {("cross_blocks", "xattn", "wk"), ("cross_blocks", "xattn", "wv")}


def _reckoned(placed, mesh, batch) -> int:
    """The weight bytes a decode step copies: each row that computes
    (every data row where they divide the batch, else the first) gathers
    over the data axes (D - 1) / D of every leaf it reads whose spec
    names ``'data'``; nothing else."""
    D = mesh.shape["data"]
    rows = D if batch % D == 0 else 1
    total = 0
    for path, sh in tree_util.flatten_with_path(placed):
        if path[0] not in DECODE_KEYS or tuple(path[-3:]) in INIT_ONLY:
            continue
        if any("data" in (e if isinstance(e, tuple) else (e,))
               for e in sh.spec if e is not None):
            nbytes = int(np.prod(sh.shape)) * sh.shards.flat[0].element_size()
            total += rows * nbytes * (D - 1) // D
    return total


def _decode(model, params, cache, ref):
    step = make_serve_step(model)
    out = []
    for t in range(STEPS):
        _, logits, cache = step(params, cache, _t(ref["tokens"][t]),
                                _t(ref["pos0"] + t))
        out.append(logits)
    return out, cache


def _whole(logits, mesh=None):
    """Placed logits or next tokens checked where their blocks lie (each
    coordinate its block of the spec JAX's compiled step gives),
    gathered on the CPU; a plain tensor as it is."""
    if mesh is None:
        return logits
    return assert_placed(logits, serve_spmd.output_spec(mesh, logits.shape))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_jax(arch, shape):
    ref = reference(arch)
    mesh = make_forced_host_mesh(shape, device="cpu")
    model, placed = _placed(arch, mesh)
    shardings = sharding.cache_shardings(
        model, ShapeConfig("decode", _max_len(model.cfg), B, "decode"), mesh)
    with no_whole_gathers():
        cache = model.init_cache(placed, B, _max_len(model.cfg),
                                 _t(ref["memory"]), shardings=shardings)
    _fill(cache, ref["filled"], mesh)
    before = _blocks(cache)
    model_split.reset_copied()
    logits, out = _decode(model, placed, cache, ref)
    assert out is cache and _blocks(cache) == before
    moved = model_split.copied()
    assert moved["cache"] == 0
    assert moved["weights"] == STEPS * _reckoned(placed, mesh, B)
    if shape[0] == 1:
        assert moved["weights"] == 0
    for t in range(STEPS):
        assert logits[t].shape == (B, 1, model.cfg.padded_vocab)
        got = _whole(logits[t], mesh)
        assert torch.isfinite(got).all()
        assert _rel_l2(got, ref["logits"][t]) <= REL, t
    for sh, want in zip(tree_util.leaves(cache), ref["final"]):
        assert _rel_l2(sh.gather("cpu"), want) <= REL
    if shape == (1, 1):
        plain = model.init_cache(_params(arch), B, _max_len(model.cfg),
                                 _t(ref["memory"]))
        _fill(plain, ref["filled"])
        want, plain = _decode(model, _params(arch), plain, ref)
        assert all(torch.equal(a.shards[0, 0], b)
                   for a, b in zip(logits, want))
        assert all(torch.equal(sh.gather("cpu"), p) for sh, p in
                   zip(tree_util.leaves(cache), tree_util.leaves(plain)))

    # the prefill over the same placement
    # the MoE dispatch groups by data row; the other families do not
    toks, mem, want = jax_forward(arch, shape[0] if model.cfg.n_experts
                                  else 1)
    model_split.reset_copied()
    with no_whole_gathers():
        got = make_prefill_step(model)(placed, _t(toks), _t(mem))
    if shape[0] == 1:
        assert model_split.copied()["weights"] == 0
    assert _rel_l2(_whole(got, mesh), want) <= REL


def _refuse_whole_gathers(monkeypatch):
    """Make every whole gather of a leaf that ``'model'`` cuts into more
    than one block raise (``Sharded.gather`` and ``_Leaf.gather``, which
    the steps' fetch of a leaf at the row takes)."""
    def guarded(orig, sharded):
        def gather(self, *args, **kwargs):
            sh = sharded(self)
            if sh.mesh.shape["model"] > 1 and any(
                    "model" in sharding._axes(e) for e in sh.spec):
                raise AssertionError(f"a model-split leaf gathered whole: "
                                     f"{sh}")
            return orig(self, *args, **kwargs)
        return gather
    monkeypatch.setattr(model_split._Leaf, "gather",
                        guarded(model_split._Leaf.gather, lambda leaf: leaf.sh))
    monkeypatch.setattr(sharding.Sharded, "gather",
                        guarded(sharding.Sharded.gather, lambda sh: sh))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_gathers_no_model_split_leaf(arch, shape, monkeypatch):
    """With every whole gather of a model-split leaf raising, the decode
    steps and the prefill (each weight block computed where it lies)
    still run and hold to JAX."""
    ref = reference(arch)
    mesh = make_forced_host_mesh(shape, device="cpu")
    model, placed = _placed(arch, mesh)
    cache = model.init_cache(placed, B, _max_len(model.cfg),
                             _t(ref["memory"]))
    _fill(cache, ref["filled"], mesh)
    _refuse_whole_gathers(monkeypatch)
    logits, cache = _decode(model, placed, cache, ref)
    toks, mem, want = jax_forward(arch, shape[0] if model.cfg.n_experts
                                  else 1)
    got = make_prefill_step(model)(placed, _t(toks), _t(mem))
    monkeypatch.undo()
    assert _rel_l2(_whole(got, mesh), want) <= REL
    for t in range(STEPS):
        assert _rel_l2(_whole(logits[t], mesh), ref["logits"][t]) <= REL
    for sh, want in zip(tree_util.leaves(cache), ref["final"]):
        assert _rel_l2(sh.gather("cpu"), want) <= REL


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mixtral-8x7b",
                                  "deepseek-v3-671b"])
def test_steps_replay_bit_for_bit(arch, shape):
    """The same steps from two copies of one filled cache give the same
    logits and caches, bit for bit: partial sums in block order, no
    atomics."""
    ref = reference(arch)
    mesh = make_forced_host_mesh(shape, device="cpu")
    model, placed = _placed(arch, mesh)
    runs = []
    for _ in range(2):
        cache = model.init_cache(placed, B, _max_len(model.cfg),
                                 _t(ref["memory"]))
        _fill(cache, ref["filled"], mesh)
        runs.append(_decode(model, placed, cache, ref))
    (la, ca), (lb, cb) = runs
    assert all(torch.equal(_whole(a, mesh), _whole(b, mesh))
               for a, b in zip(la, lb))
    assert all(torch.equal(a.gather("cpu"), b.gather("cpu")) for a, b in
               zip(tree_util.leaves(ca), tree_util.leaves(cb)))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_init_params_draws_the_unsharded_tree(arch, monkeypatch):
    """``init_params`` on (2, 2): the placed tree gathers to the unsharded
    ``Model.init`` draws, bit for bit, and a stack keeps no drawn layer's
    tensors once they are placed (only its structure, on the meta
    device; ``lm_spmd._StackSink``, which ``init_train_state`` uses
    too)."""
    _, cfg = _cfgs(arch)
    model = build(cfg)
    mesh = make_forced_host_mesh((2, 2), device="cpu")
    kept = []
    add = lm_spmd._StackSink.add

    def spy(self, i, layer):
        add(self, i, layer)
        kept.extend(a.device.type for a in tree_util.leaves(self.like))
    monkeypatch.setattr(lm_spmd._StackSink, "add", spy)
    placed = serve_spmd.init_params(
        model, 3, serve_spmd.param_shardings(model, mesh), "cpu")
    want = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert kept and set(kept) == {"meta"}
    for sh, w in zip(tree_util.leaves(placed), tree_util.leaves(want)):
        assert torch.equal(sh.gather("cpu"), w)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    shape = ShapeConfig("decode", L, B, "decode")
    jcache = jbuild(jcfg).cache_abstract(
        JShapeConfig("decode", L, B, "decode"))
    for m in MESHES:
        mesh = make_forced_host_mesh(m, device="cpu")
        got = [tuple(s.spec) for _, s in sharding._with_paths(
            sharding.cache_shardings(build(cfg), shape, mesh))]
        specs = jax.tree_util.tree_leaves(
            jsharding.cache_pspecs(jcache, jcfg, mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = [tuple(jsharding.sanitize_pspec(s, a.shape, mesh))
                for s, a in zip(specs, jax.tree_util.tree_leaves(jcache))]
        assert [tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                      for e in s) for s in want] == got


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b"])
def test_batch_1_on_two_rows(arch):
    """Batch 1 on (2, 1): the data axis does not divide it, the cache's
    batch is replicated and the first row computes it whole."""
    ref = reference(arch, 1, (9,))
    mesh = make_forced_host_mesh((2, 1), device="cpu")
    model, placed = _placed(arch, mesh)
    cache = model.init_cache(placed, 1, L)
    for sh in tree_util.leaves(cache):
        assert sh.spec[1] is None
    _fill(cache, ref["filled"], mesh)
    logits, cache = _decode(model, placed, cache, ref)
    for t in range(STEPS):
        assert _rel_l2(_whole(logits[t], mesh), ref["logits"][t]) <= REL
    for sh, want in zip(tree_util.leaves(cache), ref["final"]):
        assert _rel_l2(sh.gather("cpu"), want) <= REL


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b",
                                  "deepseek-v3-671b"])
def test_copies_in_other_memory_are_written_alike(arch):
    """Batch 1 on (2, 2): each block held twice, a copy a data row; each
    copy in memory of its own (as on distinct devices) gets the same
    writes, so every copy ends as JAX's cache."""
    ref = reference(arch, 1, (9,))
    mesh = make_forced_host_mesh((2, 2), device="cpu")
    model, placed = _placed(arch, mesh)
    cache = model.init_cache(placed, 1, L)
    for sh in tree_util.leaves(cache):
        for c in mesh.coords()[1:]:
            sh.shards[c] = sh.shards[c].clone()
    _fill(cache, ref["filled"], mesh)
    logits, cache = _decode(model, placed, cache, ref)
    for t in range(STEPS):
        assert _rel_l2(_whole(logits[t], mesh), ref["logits"][t]) <= REL
    for sh, want in zip(tree_util.leaves(cache), ref["final"]):
        for idx, coords in sh.unique().items():
            blocks = [sh.shards[c] for c in coords]
            assert len({b.data_ptr() for b in blocks}) == len(blocks) > 1
            for b in blocks:
                assert torch.equal(b, blocks[0])
        assert _rel_l2(sh.gather("cpu"), want) <= REL


def test_first_token_with_one_valid_block_is_finite():
    """Every row at position 0 on (1, 4): the three later blocks hold no
    valid key (max -inf, sum 0) and the merge stays finite, equal to the
    unsharded step."""
    arch = "phi4-mini-3.8b"
    mesh = make_forced_host_mesh((1, 4), device="cpu")
    model, placed = _placed(arch, mesh)
    cache = model.init_cache(placed, B, L)
    plain = model.init_cache(_params(arch), B, L)
    rng = np.random.RandomState(3)
    values = [rng.randn(*a.shape).astype(np.float32)
              for a in tree_util.leaves(plain)]
    _fill(cache, values, mesh)
    _fill(plain, values)
    tok = torch.from_numpy(rng.randint(0, model.cfg.vocab_size, (B, 1)))
    pos = torch.zeros(B, dtype=torch.int32)
    got, _ = model.decode_step(placed, cache, tok, pos)
    want, _ = model.decode_step(_params(arch), plain, tok, pos)
    got = _whole(got, mesh)
    assert torch.isfinite(got).all()
    assert _rel_l2(got, want) <= REL


def test_refusals():
    """A placed tree with an unplaced cache, a cache on another mesh, and
    a placement onto devices the host lacks all raise."""
    arch = "phi4-mini-3.8b"
    mesh = make_forced_host_mesh((1, 2), device="cpu")
    model, placed = _placed(arch, mesh)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    plain = build(model.cfg).init_cache(_params(arch), B, L)
    with pytest.raises(ValueError, match="both placed"):
        model.decode_step(placed, plain, tok, pos)
    other = make_forced_host_mesh((2, 1), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        model.init_cache(placed, B, L, shardings=sharding.cache_shardings(
            model, ShapeConfig("decode", L, B, "decode"), other))
    cache = model.init_cache(placed, 2, L)
    with pytest.raises(ValueError, match="batch"):
        model.decode_step(placed, cache, tok, pos)
    if not torch.cuda.is_available():
        card = make_forced_host_mesh((1, 2), device="cuda:0")
        with pytest.raises((RuntimeError, AssertionError)):
            sharding.place(_params(arch),
                           serve_spmd.param_shardings(model, card))
