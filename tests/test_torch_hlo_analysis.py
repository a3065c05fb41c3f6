"""The port's cost analysis (``repro_torch.launch.hlo_analysis``) against
the JAX package's loop-aware HLO analysis (``repro.launch.hlo_analysis``).

  * the JAX tests' cases as port tests: a 10-trip loop of 64x64 products,
    a 3x5 nested loop, ``tanh(a @ a) @ a`` with its traffic and parameter
    bytes, FLOPs that grow with the layers;
  * per arch, the unsharded smoke train step (batch 2 x 64) at 2 and 4
    layers: the port's ``analyze`` on meta tensors against JAX's
    ``analyze`` of the compiled JAX step, equal or apart by the exact gap
    each arch's comment explains; the prefill and the decode step of a
    dense, a moe and an ssm arch, equal (JAX's 4-layer figures from its
    2-layer compile where the layers are one loop, ``ONE_SCAN``);
  * the analysis of a step on CPU tensors is the analysis of the same step
    on meta tensors (the meta dry run sees what a real run does);
  * a table cached on a step's first call places no operation that reads
    it (a cold call is attributed as a warm one).

JAX's multi-device compile is never the reference: its dry run needs 512
forced host devices before ``jax`` is imported, which ``tests/
conftest.py`` keeps out of the test process.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.optim.optimizers import AdamW as JAdamW  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import steps  # noqa: E402

B, T = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the JAX tests' cases
# --------------------------------------------------------------------------
def test_loop_counts_every_trip():
    x = torch.ones(64, 64, device="meta")

    def f(c):
        for _ in range(10):
            c = c @ x
        return c

    _, s = analyze(f, x)
    assert s.flops == 10 * 2 * 64 ** 3


def test_nested_loop():
    x = torch.ones(32, 32, device="meta")

    def f(c):
        for _ in range(3):
            for _ in range(5):
                c = c @ x
        return c

    _, s = analyze(f, x)
    assert s.flops == 15 * 2 * 32 ** 3


def test_traffic_nonzero_and_param_bytes():
    a = torch.ones(128, 128)
    _, s = analyze(lambda a: torch.tanh(a @ a) @ a, a)
    assert s.flops == 2 * 2 * 128 ** 3
    assert s.traffic_bytes > 0
    assert s.param_bytes == 128 * 128 * 4


def test_views_are_free_and_storage_lives_until_freed():
    a = torch.ones(256, 256, device="meta")

    def f(a):
        v = a.t()[:128]                      # views: no traffic
        b = v * 2.0                          # 128 KiB made
        c = b + 1.0                          # 128 KiB more
        del b
        return c.sum()
    _, s = analyze(f, a)
    assert s.traffic_bytes == (128 * 256 * 4) * 4 + 4 + 128 * 256 * 4
    # b and c live together once, arguments beside them
    assert s.peak_bytes == 256 * 256 * 4 + 2 * 128 * 256 * 4


def test_table_made_on_first_use_places_no_operation():
    """A table a step builds on its first call and caches (made outside
    every coordinate's scope) counts at the mesh's first coordinate, but
    the products that read it count where their other operand lies."""
    from repro_torch.distributed.sharding import P, Sharded
    from repro_torch.launch.mesh import make_forced_host_mesh
    mesh = make_forced_host_mesh((1, 2), ("data", "model"), device="meta")
    x = Sharded.place(torch.empty(16, 32, device="meta"), P(None, "model"),
                      mesh, own=True)
    cache = {}

    def f(x):
        out = []
        for c in mesh.coords():
            if "table" not in cache:
                cache["table"] = torch.ones(16, 16, device="meta") * 2
            out.append(cache["table"] @ x.shards[c])
        return out
    _, s = analyze(f, x, mesh=mesh)
    assert [s.per_coord[c].flops for c in mesh.coords()] \
        == [2 * 16 * 16 * 16] * 2
    assert s.per_coord[(0, 0)].traffic > s.per_coord[(0, 1)].traffic


def _smoke_train_flops(arch, n_layers):
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              n_layers=n_layers)
    m, opt = build(cfg), AdamW(lr=1e-3)
    shape = configs.ShapeConfig("smoke", T, B, "train")
    _, s = analyze(steps.make_train_step(m, opt),
                   steps.abstract_train_state(m, opt), m.batch_specs(shape))
    return s.flops


def test_train_step_flops_scale_with_layers():
    flops = {L: _smoke_train_flops("stablelm-3b", L) for L in (2, 4)}
    assert flops[4] / flops[2] > 1.3


# --------------------------------------------------------------------------
# per arch, against JAX's analysis of the compiled step
# --------------------------------------------------------------------------
# The archs whose smoke steps JAX compiles with each layer stack as one
# loop of n_layers trips (the forward's, the rematerialised backward's)
# and no other loop of two trips: their 4-layer step is their 2-layer
# step's HLO with those loops' trip counts doubled, so one compile serves
# both depths (``test_deeper_step_from_one_compile`` holds the derivation
# to a compile at 4 layers).  Not so: llama-vision (a loop a cross group),
# deepseek (its dense layers and MTP block beside the MoE stack), whisper
# (the encoder's loops).
ONE_SCAN = ("qwen2.5-32b", "qwen3-14b", "stablelm-3b", "phi4-mini-3.8b",
            "mixtral-8x7b", "zamba2-1.2b", "mamba2-1.3b")


@functools.lru_cache(maxsize=None)
def _jax_hlo(arch, n_layers, kind) -> str:
    """The optimised HLO of JAX's compiled smoke step."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                              n_layers=n_layers)
    m = jbuild(cfg)
    shape = jconfigs.ShapeConfig("smoke", T, B, kind)
    if kind == "train":
        opt = JAdamW(lr=1e-3)
        low = jax.jit(jsteps.make_train_step(m, opt)).lower(
            jsteps.abstract_train_state(m, opt), m.batch_specs(shape))
    elif kind == "prefill":
        b = m.batch_specs(shape)
        low = jax.jit(jsteps.make_prefill_step(m)).lower(
            m.init_abstract(), b["tokens"], b.get("vision", b.get("frames")))
    else:
        d = m.decode_specs(shape)
        low = jax.jit(jsteps.make_serve_step(m)).lower(
            m.init_abstract(), m.cache_abstract(shape), d["tokens"],
            d["pos"])
    return low.compile().as_text()


def _deepened(text: str) -> str:
    """A 2-layer step's HLO with its loops of two trips made four."""
    return text.replace('"known_trip_count":{"n":"2"}',
                        '"known_trip_count":{"n":"4"}')


@functools.lru_cache(maxsize=None)
def _jax_flops(arch, n_layers, kind):
    if n_layers == 4 and arch in ONE_SCAN:
        return jhlo.analyze(_deepened(_jax_hlo(arch, 2, kind))).flops
    return jhlo.analyze(_jax_hlo(arch, n_layers, kind)).flops


@pytest.mark.parametrize("arch,kind", [("stablelm-3b", "train"),
                                       ("mamba2-1.3b", "decode")])
def test_deeper_step_from_one_compile(arch, kind):
    """The derivation of ``ONE_SCAN``'s 4-layer FLOPs from the 2-layer
    compile equals JAX's compile at 4 layers."""
    assert _jax_flops(arch, 4, kind) \
        == jhlo.analyze(_jax_hlo(arch, 4, kind)).flops


@functools.lru_cache(maxsize=None)
def _port_flops(arch, n_layers, kind):
    if kind == "train":
        return _smoke_train_flops(arch, n_layers)
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              n_layers=n_layers)
    m = build(cfg)
    shape = configs.ShapeConfig("smoke", T, B, kind)
    if kind == "prefill":
        b = m.batch_specs(shape)
        _, s = analyze(steps.make_prefill_step(m), m.init_abstract(),
                       b["tokens"], b.get("vision", b.get("frames")))
    else:
        d = m.decode_specs(shape)
        _, s = analyze(steps.make_serve_step(m), m.init_abstract(),
                       m.cache_abstract(shape), d["tokens"], d["pos"])
    return s.flops


def _qk(cfg, t, width):
    """One QK^T product over t queries and keys, ``width`` wide a head."""
    return 2 * B * t * t * cfg.n_heads * width


def _expected_gap(arch, L):
    """The port's FLOPs less JAX's for the smoke train step at L layers.

    * The port's flash backward recomputes each chunk's scores (one QK^T
      an attention); where JAX's compiled step already holds them it
      skips that product: XLA merges the backward's recomputation with
      the rematerialised forward's scores for stablelm, phi4, whisper
      and deepseek's MLA (not for qwen2.5, qwen3, mixtral, llama-vision,
      whose compiled backward recomputes them as the port does), and
      deepseek's MTP block, which is not rematerialised, saves them.
    * llama-vision: JAX rematerialises each cross-attention group as one
      ``jax.checkpoint`` whose decoder layers are an inner ``lax.scan``;
      the recomputation keeps the group's last FFN down-projection, which
      XLA cannot drop from one trip of a loop, while PyTorch's
      non-reentrant checkpoint stops once the saved tensors are rebuilt
      (as both do in a plain decoder layer): one 2 B T d_ff d a group.
    * mamba2 (and zamba2's mamba layers): JAX's backward contracts the
      SSD scan's multi-operand einsums (``bcqn,bcqh,bchpn->bcqhp``,
      ``bcsn,bcsh,bcsh,bcshp->bchpn``) in another pairwise order than
      ``torch.einsum``'s backward, 6 B T d_inner FLOPs more a layer.
    * zamba2's shared block: see ``test_hybrid_shared_block``.
    """
    cfg = configs.get_smoke_config(arch)
    if arch in ("stablelm-3b", "phi4-mini-3.8b", "whisper-tiny"):
        return L * _qk(cfg, T, cfg.head_dim)
    if arch == "deepseek-v3-671b":
        width = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return L * _qk(cfg, T, width) + _qk(cfg, T - 1, width)
    if arch == "llama-3.2-vision-11b":
        return -(L // cfg.cross_attn_every) * 2 * B * T * cfg.d_ff \
            * cfg.d_model
    if arch in ("mamba2-1.3b", "zamba2-1.2b"):
        return -L * 6 * B * T * cfg.ssm_expand * cfg.d_model
    return 0


@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("arch", [a for a in configs.ARCH_IDS
                                  if a != "zamba2-1.2b"])
def test_train_flops_match_jax(arch, L):
    assert _port_flops(arch, L, "train") - _jax_flops(arch, L, "train") \
        == _expected_gap(arch, L)


@pytest.mark.parametrize("L", [2, 4])
def test_hybrid_shared_block(L):
    """zamba2 is mamba2's layers plus a shared attention block every
    ``shared_attn_every`` layers, run under ``lax.cond`` in JAX, whose
    analysis counts both branches of a conditional: it counts the shared
    block at every layer, the port where it runs.  One application costs
    the two sides the same; the mamba layers' gap is mamba2's."""
    cfg = configs.get_smoke_config("zamba2-1.2b")
    k = cfg.shared_attn_every
    port = _port_flops("zamba2-1.2b", L, "train") \
        - _port_flops("mamba2-1.3b", L, "train")
    jx = _jax_flops("zamba2-1.2b", L, "train") \
        - _jax_flops("mamba2-1.3b", L, "train")
    assert port * k == jx
    assert _port_flops("zamba2-1.2b", L, "train") \
        - _jax_flops("zamba2-1.2b", L, "train") \
        == _expected_gap("zamba2-1.2b", L) - (L - L // k) * (port // (L // k))


@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["stablelm-3b", "mixtral-8x7b",
                                  "mamba2-1.3b"])
def test_serving_flops_match_jax(arch, kind, L):
    assert _port_flops(arch, L, kind) == _jax_flops(arch, L, kind)


# --------------------------------------------------------------------------
# meta tensors see what a real run does
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-1.3b"])
def test_cpu_step_analysed_as_meta_step(arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), n_layers=2)
    m, opt = build(cfg), AdamW(lr=1e-3)
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                        dtype=torch.int32)
    step = steps.make_train_step(m, opt)
    state = steps.init_train_state(m, opt, 0, "cpu")
    shape = configs.ShapeConfig("smoke", T, B, "train")
    # a first call on each device fills the tables a step caches
    step(state, {"tokens": tok, "labels": tok})
    step(steps.abstract_train_state(m, opt), m.batch_specs(shape))
    _, cpu = analyze(step, state, {"tokens": tok, "labels": tok})
    _, meta = analyze(step, steps.abstract_train_state(m, opt),
                      m.batch_specs(shape))
    assert (cpu.flops, cpu.traffic_bytes, cpu.param_bytes) \
        == (meta.flops, meta.traffic_bytes, meta.param_bytes)
    assert cpu.peak_bytes == meta.peak_bytes
