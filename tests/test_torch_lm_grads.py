"""The gradients of the port's LM loss (``repro_torch.models``) against
``jax.grad`` of the JAX package's, for every architecture of the zoo.

The smoke config of each architecture, in fp32 compute, with the JAX
package's parameters carried across by ``params_from_numpy``: the loss
within 1e-5 relative and each leaf's gradient within 1e-4 rel L2 of
JAX's.  A leaf whose JAX gradient is zero in exact arithmetic (its max
|g| at most 1e-6 of the largest leaf's) is held to the same 1e-6 of the
largest max |g|.  The vlm's gates start at zero and are set to 0.5 and
-0.7 in both trees, so its cross path is reached; the vlm and the encdec
take seeded vision embeddings and frames.  The port's layers are
rematerialised (the default), the JAX package's too.  The dense, ssm and
hybrid families are held here, the moe, vlm and encdec families in
``test_torch_lm_grads_families.py`` (the two files take about a minute
each, on separate workers).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.api import serving_cache  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import build, transformer  # noqa: E402

GATES = {"gate": 0.5, "ffn_gate": -0.7}
FAMILIES = ("moe", "vlm", "encdec")   # test_torch_lm_grads_families.py
LEAF_REL = 1e-4
DEAD = 1e-6


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


def _batches(cfg, B=2, S=16, seed=0):
    """(JAX batch, port batch) of seeded tokens, labels and memory."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    arrays = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        arrays["vision"] = rng.randn(B, cfg.n_vision_tokens,
                                     cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frames"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def check_grads(got, jgrads):
    """Each leaf of ``got`` (the port's, in tree order) against JAX's."""
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(got) == len(jleaves)
    gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in jleaves)
    for (path, want), g in zip(jleaves, got):
        name = "/".join(k.key for k in path)
        want = np.asarray(want)
        g = g.detach().numpy()
        assert g.shape == want.shape, name
        if np.abs(want).max() <= DEAD * gmax:
            assert np.abs(g - want).max() <= DEAD * gmax, name
        else:
            assert _rel_l2(g, want) <= LEAF_REL, (name, _rel_l2(g, want))


def jax_loss_and_grads(arch, seed=0):
    """The smoke config (fp32 compute), JAX's parameters and batch, and
    JAX's loss and gradients."""
    kw = {"compute_dtype": "float32"}
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **kw)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **kw)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    if cfg.family == "vlm":
        cross = jp["cross_blocks"]
        cross["xattn"]["gate"] = jnp.full_like(cross["xattn"]["gate"],
                                               GATES["gate"])
        cross["ffn_gate"] = jnp.full_like(cross["ffn_gate"],
                                          GATES["ffn_gate"])
    jb, b = _batches(cfg, seed=seed)
    (jloss, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)
    return cfg, jp, b, float(jloss), jg


def archs(families):
    return [a for a in jconfigs.ARCH_IDS
            if jconfigs.get_smoke_config(a).family in families]


def loss_gradients_match_jax(arch):
    cfg, jp, b, jloss, jg = jax_loss_and_grads(arch)
    live = tree_util.tree_map(lambda a: a.detach().requires_grad_(),
                              params_from_numpy(jp, "cpu"))
    loss, _ = build(cfg).loss(live, b)
    flat = tree_util.leaves(live)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    check_grads(grads, jg)


@pytest.mark.parametrize("arch", archs(("dense", "ssm", "hybrid")))
def test_loss_gradients_match_jax(arch):
    loss_gradients_match_jax(arch)
