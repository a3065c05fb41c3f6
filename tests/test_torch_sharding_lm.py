"""The LM half of the port's sharding rules (``repro_torch.distributed.
sharding``) and its abstract shapes (``Model.init_abstract``,
``cache_abstract``, ``batch_specs``, ``decode_specs``,
``train.abstract_train_state``) against the JAX package's, for all ten
LM configs at full size.

The rules read only ``mesh.shape`` and ``mesh.axis_names``, so both
packages run over a stand-in mesh of model size 1, 2, 4 and 16, with and
without a 2-way ``pod`` axis: that covers deepseek-v3's expert
parallelism (256 experts over 16) and mixtral's TP within an expert (8
experts on a 16-way axis).  The port's abstract trees are meta tensors
and allocate nothing.
"""
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import lm_spmd, sharding  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import abstract_train_state  # noqa: E402

ARCHS = list(jconfigs.ARCH_IDS)
MODEL_SIZES = (1, 2, 4, 16)
CACHE_SHAPE = ("decode_2k", 2048, 16, "decode")


def _mesh(model: int, pod: bool):
    """A stand-in mesh: the rules read only its shape and axis names."""
    names = ("pod", "data", "model") if pod else ("data", "model")
    sizes = (2, 2, model) if pod else (2, model)
    return types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 axis_names=names)


MESHES = [(m, pod) for m in MODEL_SIZES for pod in (False, True)]


def _norm(spec):
    """A spec as a plain tuple, a one-axis tuple entry as that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    return (jbuild(jconfigs.get_config(arch)).init_abstract(),
            build(configs.get_config(arch)).init_abstract())


@functools.lru_cache(maxsize=None)
def _cache_abstract(arch):
    return (jbuild(jconfigs.get_config(arch)).cache_abstract(
                JShapeConfig(*CACHE_SHAPE)),
            build(configs.get_config(arch)).cache_abstract(
                ShapeConfig(*CACHE_SHAPE)))


def _jax_specs(tree):
    return [_norm(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    return [_norm(s) for _, s in sharding._with_paths(tree)]


def _same_leaves(jtree, tree):
    jl, pl = jax.tree_util.tree_leaves(jtree), tree_util.leaves(tree)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert b.is_meta


@pytest.mark.parametrize("arch", ARCHS)
def test_init_abstract_matches_jax(arch):
    jtree, tree = _abstract(arch)
    _same_leaves(jtree, tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_abstract_and_specs_match_jax(arch):
    jm, m = jbuild(jconfigs.get_config(arch)), build(configs.get_config(arch))
    jcache, cache = _cache_abstract(arch)
    _same_leaves(jcache, cache)
    for kind, shape in (("batch", ("train", 512, 8, "train")),
                        ("decode", CACHE_SHAPE)):
        js, s = JShapeConfig(*shape), ShapeConfig(*shape)
        jspecs = jm.batch_specs(js) if kind == "batch" \
            else jm.decode_specs(js)
        specs = m.batch_specs(s) if kind == "batch" else m.decode_specs(s)
        assert sorted(jspecs) == sorted(specs)
        for k in jspecs:
            assert tuple(jspecs[k].shape) == tuple(specs[k].shape)
            assert str(jspecs[k].dtype) == \
                str(specs[k].dtype).replace("torch.", "")


@pytest.mark.parametrize("model,pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_pspecs_match_jax(arch, model, pod):
    mesh = _mesh(model, pod)
    jtree, tree = _abstract(arch)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    want = _jax_specs(jsharding.params_pspecs(jtree, jcfg, mesh))
    got = _port_specs(sharding.params_pspecs(tree, cfg, mesh))
    assert got == want


@pytest.mark.parametrize("model,pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_jax(arch, model, pod):
    mesh = _mesh(model, pod)
    jcache, cache = _cache_abstract(arch)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    want = _jax_specs(jsharding.cache_pspecs(jcache, jcfg, mesh))
    got = _port_specs(sharding.cache_pspecs(cache, cfg, mesh))
    assert got == want


def test_path_names_match_jax():
    """Paths as the JAX package's ``_path_str`` names them: dict keys,
    list indices as strings, ``AdamWState`` fields as ``.field``."""
    jstate = jsteps.abstract_train_state(
        jbuild(jconfigs.get_smoke_config("mixtral-8x7b")), JAdamW())
    state = abstract_train_state(
        build(configs.get_smoke_config("mixtral-8x7b")), AdamW())
    want = [jsharding._path_str(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(jstate.opt)]
    got = [p for p, _ in sharding._with_paths(state.opt)]
    assert got == want


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2.5-32b",
                                  "deepseek-v3-671b"])
def test_state_shardings_sanitized_as_jax(arch):
    """The train state's shardings on a (2, 16) mesh: each spec is JAX's
    ``sanitize_pspec`` of JAX's rule for that leaf (mixtral's 8 experts
    and every ragged dim fall back to replicated)."""
    mesh = _mesh(16, False)
    model, opt = build(configs.get_config(arch)), AdamW()
    state = abstract_train_state(model, opt)
    shardings = lm_spmd.state_shardings(model, opt, mesh)
    jtree = _abstract(arch)[0]
    jspecs = jax.tree_util.tree_leaves(
        jsharding.params_pspecs(jtree, jconfigs.get_config(arch), mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    jl = jax.tree_util.tree_leaves(jtree)
    want = [_norm(jsharding.sanitize_pspec(s, leaf.shape, mesh))
            for s, leaf in zip(jspecs, jl)]
    for part in (shardings.params, shardings.opt.mu, shardings.opt.nu):
        got = [_norm(s.spec) for _, s in sharding._with_paths(part)]
        assert got == want
    assert _norm(shardings.opt.step.spec) == ()
    assert _norm(shardings.rng.spec) == ()
    assert len(tree_util.leaves(state.params)) == len(want)


def test_sanitized_at_batch_1_and_8_kv_heads_on_16():
    """Batch 1 on a 2-way data axis and 8 KV heads on a 16-way model axis
    are replicated, as JAX's ``sanitize_pspec`` has them."""
    mesh = _mesh(16, True)
    cfg = configs.get_config("qwen3-14b")
    cache = build(cfg).cache_abstract(ShapeConfig("d", 2048, 1, "decode"))
    specs = sharding.cache_pspecs(cache, cfg, mesh)
    shardings = sharding.sanitized_shardings(specs, cache, mesh)
    k = shardings["layers"]["k"]
    assert _norm(k.spec) == (None, None, "model", None, None)
    batch = {"tokens": torch.empty((1, 16), device="meta")}
    b = sharding.sanitized_shardings(sharding.batch_pspecs(batch, mesh),
                                     batch, mesh)
    assert _norm(b["tokens"].spec) == (None, None)
    heads = {"wk": torch.empty((4096, 8, 128), device="meta")}
    got = sharding.sanitized_shardings({"wk": P("data", "model", None)},
                                       heads, mesh)
    want = jsharding.sanitize_pspec(
        jax.sharding.PartitionSpec("data", "model", None), (4096, 8, 128),
        mesh)
    assert _norm(got["wk"].spec) == _norm(want) == ("data", None, None)


# the dimension of each model-split leaf's layer that the split's
# operations cut (``distributed/model_split.py``): output columns, input
# rows, heads, vocab; the experts by expert (EP) or within each (TP)
SPLIT_DIMS = {"embed": (0,), "lm_head": (1,), "wq": (1,), "wo": (0,),
              "w_gate": (1, 0, 2), "w_up": (1, 0, 2), "w_down": (0, 1),
              "in_proj": (1,), "out_proj": (0,), "conv_w": (1,),
              "wq_a": (1,), "wq_b": (1,), "wkv_a": (1,), "wkv_b": (1,),
              "proj": (1,)}


@pytest.mark.parametrize("model", (2, 4, 16))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_split_takes_every_leaf(arch, model):
    """On a (2, model) mesh every leaf the state's shardings cut over
    ``'model'`` is cut on one dimension, by ``'model'`` alone, and that
    is the dimension the split's operation on it takes; the leaves
    ``'model'`` does not cut run at the row."""
    from repro_torch.distributed import model_split
    mesh = _mesh(model, False)
    m = build(configs.get_config(arch))
    shardings = lm_spmd.state_shardings(m, AdamW(), mesh)
    cut = 0
    for path, s in sharding._with_paths(shardings.params):
        stacked = any(k in sharding._STACK_KEYS for k in path)
        core = tuple(s.spec)[1:] if stacked else tuple(s.spec)
        dim = model_split._model_dim(core)
        if dim is None:
            continue
        cut += 1
        name = path[-1]
        assert name in SPLIT_DIMS and dim in SPLIT_DIMS[name], (path, dim)
        if name in ("w_gate", "w_up", "w_down") and len(core) == 3:
            # expert parallel where the axis divides the experts
            ep = m.cfg.n_experts % model == 0
            assert dim == (0 if ep else (1 if name == "w_down" else 2))
    assert cut > 0
