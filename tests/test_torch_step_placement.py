"""Where the sharded prefill and serve steps place their outputs
(``repro_torch.distributed.serve_spmd``), against where JAX's compiled
steps place them.

One JAX subprocess with ``--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_pipeline.py`` runs one) compiles the smoke prefill and
serve steps in float32 as the JAX dry run lowers them
(``src/repro/launch/dryrun.py``: the activation rules installed, the
parameters by ``sanitized_shardings(params_pspecs(...))``, the inputs by
``batch_pspecs``, the serve step's ``out_shardings``) for one arch of
each family that places differently: dense (stablelm-3b), moe
(mixtral-8x7b), ssm (mamba2-1.3b) and encdec with its memory input
(whisper-tiny), on (1, 4), (2, 2) and (4, 1), and stablelm-3b at a batch
the data axis does not divide (batch 2 on (4, 1)).  It writes each
output's spec and, for each device, its block (``devices_indices_map``);
the module reads them once.  On ``make_forced_host_mesh`` of the same
shape:

  * the port's prefill logits, next tokens and decode logits hold at
    every coordinate a block of the same extent as JAX's device at that
    coordinate: the same block shapes at the same coordinates and the
    same replication; each block is its spec's block of the gathered
    whole (``testing.assert_placed``);
  * the values, gathered: the prefill within ``REL`` of ``jbuild(...)
    .forward``, the serve step's logits within ``REL`` of JAX's
    single-device decode (``test_torch_serve_spmd.reference``);
  * the next tokens equal ``jnp.argmax`` over the gathered logits; fed
    to the next step as they lie, no per-token tensor and no output
    crosses the data axes, and that step equals the port's unsharded
    step fed the same tokens;
  * the argmax over vocab blocks keeps the lowest global index on ties
    planted across the blocks' edges (a NaN the largest), as
    ``jnp.argmax``.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_serve_spmd import (B, REL, STEPS, _fill,  # noqa: E402
                                   _isolated, _max_len, _one_thread,  # noqa
                                   _params, _placed, _rel_l2, _t, jax_forward,
                                   reference)

from repro_torch.distributed import model_split, serve_spmd  # noqa: E402
from repro_torch.distributed.sharding import Sharded  # noqa: E402
from repro_torch.launch.mesh import make_forced_host_mesh  # noqa: E402
from repro_torch.testing import assert_placed  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
ARCHS = ("stablelm-3b", "mixtral-8x7b", "mamba2-1.3b", "whisper-tiny")
MESHES = ((1, 4), (2, 2), (4, 1))
# (arch, mesh, batch): each family on each mesh at batch B, and a batch
# the data axis does not divide
CASES = [(a, m, B) for a in ARCHS for m in MESHES] \
    + [("stablelm-3b", (4, 1), 2)]
PREFILL_S = 8

_JAX = """
import dataclasses, json, sys
import jax
import numpy as np
from jax.sharding import PartitionSpec as JP
import repro.configs as jconfigs
from repro.configs.base import ShapeConfig
from repro.distributed import act_sharding as acts, sharding as shd
from repro.launch.mesh import make_forced_host_mesh
from repro.models.registry import build
from repro.train import steps as steps_lib


def blocks(sharding, shape, mesh):
    where = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
             for d in mesh.devices.flat}
    out = []
    for d, idx in sharding.devices_indices_map(shape).items():
        out.append([where[d.id], [[s.start or 0, n if s.stop is None
                                   else s.stop] for s, n in zip(idx, shape)]])
    return {"spec": str(sharding.spec), "blocks": out}


def read(arch, mesh_shape, B, S, max_len):
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                              compute_dtype="float32")
    model = build(cfg)
    mesh = make_forced_host_mesh(mesh_shape)
    acts.install(mesh, shd.batch_axes(mesh))
    try:
        with mesh:
            params = model.init_abstract()
            p_shard = shd.sanitized_shardings(
                shd.params_pspecs(params, cfg, mesh), params, mesh)
            batch = model.batch_specs(ShapeConfig("p", S, B, "prefill"))
            b_shard = shd.sanitized_shardings(
                shd.batch_pspecs(batch, mesh), batch, mesh)
            memory = batch.get("vision", batch.get("frames"))
            m_shard = None if memory is None else shd.sanitized_shardings(
                shd.batch_pspecs(memory, mesh), memory, mesh)
            prefill = jax.jit(steps_lib.make_prefill_step(model),
                              in_shardings=(p_shard, b_shard["tokens"],
                                            m_shard)).lower(
                params, batch["tokens"], memory).compile()
            shape = ShapeConfig("d", max_len, B, "decode")
            cache = model.cache_abstract(shape)
            c_shard = shd.sanitized_shardings(
                shd.cache_pspecs(cache, cfg, mesh), cache, mesh)
            dec = model.decode_specs(shape)
            b = shd.batch_axes(mesh)
            tok = shd.sanitized_shardings(JP(b, None), dec["tokens"], mesh)
            pos = shd.sanitized_shardings(JP(b), dec["pos"], mesh)
            serve = jax.jit(steps_lib.make_serve_step(model),
                            in_shardings=(p_shard, c_shard, tok, pos),
                            out_shardings=(tok, None, c_shard),
                            donate_argnums=(1,)).lower(
                params, cache, dec["tokens"], dec["pos"]).compile()
    finally:
        acts.clear()
    V = cfg.padded_vocab
    return {"prefill": blocks(prefill.output_shardings, (B, S, V), mesh),
            "next": blocks(serve.output_shardings[0], (B, 1), mesh),
            "logits": blocks(serve.output_shardings[1], (B, 1, V), mesh)}


cases, S, out = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
json.dump([read(a, tuple(m), b, S, n) for a, m, b, n in cases],
          open(out, "w"))
"""


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    """JAX's readings for every case (one subprocess for the module):
    ``{(arch, mesh, batch): {output: {"spec", "blocks"}}}``."""
    cases = [(a, m, b, _max_len(dataclasses.replace(
        _cfg(a), compute_dtype="float32"))) for a, m, b in CASES]
    out = tmp_path_factory.mktemp("jax_blocks") / "blocks.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX),
                        json.dumps(cases), str(PREFILL_S), str(out)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return {case: got for case, got in zip(CASES, json.loads(out.read_text()))}


def _cfg(arch):
    import repro_torch.configs as configs
    return configs.get_smoke_config(arch)


def _same_blocks(sh: Sharded, reading) -> None:
    """At every coordinate the port's block covers the extent JAX's
    device at that coordinate holds."""
    want = {tuple(c): [tuple(e) for e in ext] for c, ext in reading["blocks"]}
    assert set(want) == {tuple(c) for c in sh.mesh.coords()}
    for c in sh.mesh.coords():
        t = sh.shards[c]
        got = [(i * n, (i + 1) * n)
               for i, n in zip(sh.block_index(c), t.shape)]
        assert got == want[tuple(c)], (c, reading["spec"], sh.spec)


@functools.lru_cache(maxsize=None)
def _forward(arch, batch, n):
    """JAX's forward over PREFILL_S tokens: the first ``batch`` sequences
    of ``jax_forward``'s (the MoE dispatch in ``n`` chunks)."""
    toks, mem, want = jax_forward(arch, n)
    if batch == B:
        return toks, mem, want
    from test_torch_serve_spmd import _cfgs, _jax_params
    from repro.distributed import act_sharding as jacts
    from repro.models.registry import build as jbuild
    jcfg, _ = _cfgs(arch)
    orig = jacts.data_shards
    jacts.data_shards = lambda: n
    try:
        want = jbuild(jcfg).forward(
            _jax_params(arch), jnp.asarray(toks[:batch]),
            None if mem is None else jnp.asarray(mem[:batch]))
    finally:
        jacts.data_shards = orig
    return toks[:batch], None if mem is None else mem[:batch], \
        np.asarray(want)


@pytest.mark.parametrize("arch,shape,batch", CASES)
def test_prefill_placed_as_jax(arch, shape, batch, jax_blocks):
    mesh = make_forced_host_mesh(shape, device="cpu")
    model, placed = _placed(arch, mesh)
    # the MoE dispatch groups by data row, as JAX's with data_shards
    n = shape[0] if model.cfg.n_experts and batch % shape[0] == 0 else 1
    toks, mem, want = _forward(arch, batch, n)
    got = make_prefill_step(model)(placed, _t(toks), _t(mem))
    _same_blocks(got, jax_blocks[(arch, shape, batch)]["prefill"])
    whole = assert_placed(got, serve_spmd.logits_spec(mesh, got.shape))
    assert _rel_l2(whole, want) <= REL


def _crossings(monkeypatch):
    """The copies ``model_split`` counts, as (kind, source, destination)."""
    seen = []
    count = model_split._count

    def spy(kind, t, src, dst, *args):
        seen.append((kind, tuple(src), tuple(dst)))
        return count(kind, t, src, dst, *args)
    monkeypatch.setattr(model_split, "_count", spy)
    return seen


@pytest.mark.parametrize("arch,shape,batch", CASES)
def test_serve_step_placed_as_jax(arch, shape, batch, jax_blocks,
                                  monkeypatch):
    ref = reference(arch) if batch == B else reference(arch, batch, (5, 13))
    mesh = make_forced_host_mesh(shape, device="cpu")
    model, placed = _placed(arch, mesh)
    L = _max_len(model.cfg)
    cache = model.init_cache(placed, batch, L, _t(ref["memory"]))
    _fill(cache, ref["filled"], mesh)
    plain = model.init_cache(_params(arch), batch, L, _t(ref["memory"]))
    _fill(plain, ref["filled"])
    step = make_serve_step(model)
    nxt, logits, cache = step(placed, cache, _t(ref["tokens"][0]),
                              _t(ref["pos0"]))
    reading = jax_blocks[(arch, shape, batch)]
    _same_blocks(logits, reading["logits"])
    _same_blocks(nxt, reading["next"])
    whole = assert_placed(logits, serve_spmd.logits_spec(mesh, logits.shape))
    tokens = assert_placed(nxt, serve_spmd.batch_spec(mesh, nxt.shape))
    assert nxt.dtype == torch.int32
    assert _rel_l2(whole, ref["logits"][0]) <= REL
    np.testing.assert_array_equal(
        tokens.numpy(), np.asarray(jnp.argmax(jnp.asarray(
            whole[:, -1].numpy()), axis=-1))[:, None])
    # the next step takes the tokens as they lie: on a batch the data
    # axes divide, no per-token tensor and no output crosses them
    pnxt, _, plain = step(_params(arch), plain, _t(ref["tokens"][0]),
                          _t(ref["pos0"]))
    assert torch.equal(pnxt, tokens)
    seen = _crossings(monkeypatch)
    nxt2, logits2, cache = step(placed, cache, nxt, _t(ref["pos0"] + 1))
    monkeypatch.undo()
    if batch % shape[0] == 0:
        crossed = [(k, a, b) for k, a, b in seen
                   if k != "weights" and a[0] != b[0]]
        assert not crossed, crossed[:4]
    pnxt2, plg2, _ = step(_params(arch), plain, pnxt, _t(ref["pos0"] + 1))
    assert _rel_l2(assert_placed(logits2), plg2) <= REL
    assert torch.equal(assert_placed(nxt2), pnxt2)


@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (2, 2), (4, 1)])
def test_argmax_over_blocks_takes_the_lowest_index(shape):
    """Ties planted across the blocks' edges, within a block and beside a
    NaN: the merge of the blocks' maxima keeps what ``jnp.argmax`` gives
    over the whole vocab."""
    V, n = 64, 8
    rng = np.random.RandomState(5)
    x = rng.randn(n, 2, V).astype(np.float32)
    q = V // 4
    for r, idx in enumerate([(q - 1, q), (2 * q - 1, 2 * q, 3 * q),
                             (3 * q - 1, 3 * q), (0, V - 1), (5, 6),
                             (q + 3, 2 * q + 3, 3 * q + 3), (V - 2, V - 1)]):
        x[r, -1, list(idx)] = 9.0
    x[n - 1, -1, [2 * q + 1, 3 * q + 2]] = np.nan
    mesh = make_forced_host_mesh(shape, device="cpu")
    logits = Sharded.place(torch.from_numpy(x),
                           serve_spmd.logits_spec(mesh, x.shape), mesh)
    got = assert_placed(serve_spmd.greedy(logits),
                        serve_spmd.batch_spec(mesh, (n, 1)))
    want = np.asarray(jnp.argmax(jnp.asarray(x[:, -1]), axis=-1))[:, None]
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == q - 1 and got[n - 1, 0] == 2 * q + 1
