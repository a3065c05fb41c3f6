"""``test_torch_lm_spmd.py``'s checks of the sharded LM train step
against the JAX package's single-device step (``data_shards`` = the data
axis's size) for the moe, vlm and encdec families: deepseek-v3 (MLA,
the MoE with its shared expert, the MTP term), mixtral-8x7b (8 experts,
TP within an expert), llama-3.2-vision-11b (gates 0.5 and -0.7) and
whisper-tiny; the moe archs also on (1, 8) (mixtral's 4 experts split
within each expert, deepseek's 4 MLA heads cut by the blocks' edges and
joined at the row); the MoE at batch 1 on a 2-way data axis (the batch
replicated, the dispatch still in 2 chunks); and the shard-local
dispatch: ``moe_block`` on each shard's tokens bit for bit the
single-device block with ``data_shards`` 2 installed.  The vlm and the
encdec also run their prefill and ``init_cache`` (the encoder, the
cross K/V) with every whole gather of a model-split leaf refused
(``test_train_step_gathers_no_model_split_leaf``, with
``test_torch_serve_spmd.py``'s references).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_spmd import (MESHES, _isolated,  # noqa: E402,F401
                                _one_thread, check_against_jax,
                                check_bitwise_one_row)
from test_torch_serve_spmd import (B, REL, _is_cross,  # noqa: E402
                                   _max_len, _placed, _refuse_whole_gathers,
                                   _rel_l2, _t, jax_forward, reference)

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.distributed import act_sharding  # noqa: E402
from repro_torch.launch.mesh import make_forced_host_mesh  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402
from repro_torch.train import make_prefill_step  # noqa: E402

ARCHS = ("deepseek-v3-671b", "mixtral-8x7b", "llama-3.2-vision-11b",
         "whisper-tiny")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(arch, shape):
    check_against_jax(arch, shape)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_data_row_is_bitwise_single_device(arch, shape):
    check_bitwise_one_row(arch, shape)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x7b"])
def test_moe_on_eight_model_blocks(arch):
    """(1, 8): mixtral's experts tensor parallel within each expert (4
    experts, f over 8), deepseek's MLA heads cut by the blocks' edges."""
    check_against_jax(arch, (1, 8))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x7b"])
def test_moe_at_batch_1_on_two_data_shards(arch):
    """Batch 1 on (2, 1): ``sanitize_pspec`` replicates the batch, one
    row computes it, and the dispatch still groups in 2 chunks, as JAX's
    with ``data_shards`` 2."""
    check_against_jax(arch, (2, 1), batch=1)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x7b"])
def test_shard_local_dispatch_is_bitwise(arch):
    """``moe_block`` over a (2, 1) mesh's shards (each shard's tokens,
    ``data_shards`` 1, as the sharded step runs them) against one device
    with ``data_shards`` 2 installed: outputs bit for bit, and the router
    statistics' density bit for bit."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              compute_dtype="float32")
    params = build(cfg).init(torch.Generator().manual_seed(0),
                             device="cpu")
    ffn = params["blocks"]["ffn"]
    ffn = {k: (v[0] if not isinstance(v, dict)
               else {kk: vv[0] for kk, vv in v.items()})
           for k, v in ffn.items()}
    x = torch.from_numpy(np.random.RandomState(3).randn(
        4, 16, cfg.d_model).astype(np.float32))
    mesh = make_forced_host_mesh((2, 1), device="cpu")
    act_sharding.install(mesh, ("data",))
    try:
        assert act_sharding.data_shards() == 2
        whole, stats = moe.moe_block(ffn, cfg, x, router_stats=True)
        with act_sharding.local(1):
            parts = [moe.moe_block(ffn, cfg, x[s * 2:(s + 1) * 2],
                                   router_stats=True) for s in range(2)]
    finally:
        act_sharding.clear()
    assert torch.equal(whole, torch.cat([p[0] for p in parts]))
    density = torch.stack([p[1][0] for p in parts]).mean(0)
    assert torch.equal(density, stats[0])
    assert act_sharding.data_shards() == 1


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_train_step_gathers_no_model_split_leaf(arch, shape, monkeypatch):
    """With every whole gather of a model-split leaf raising, the sharded
    train step (``check_against_jax``, which refuses them around its
    steps), ``init_cache``'s encoder and cross K/V and the prefill run and
    hold to JAX."""
    check_against_jax(arch, shape)
    ref = reference(arch)
    mesh = make_forced_host_mesh(shape, device="cpu")
    model, placed = _placed(arch, mesh)
    toks, mem, want = jax_forward(arch, 1)
    _refuse_whole_gathers(monkeypatch)
    cache = model.init_cache(placed, B, _max_len(model.cfg),
                             _t(ref["memory"]))
    got = make_prefill_step(model)(placed, _t(toks), _t(mem))
    monkeypatch.undo()
    assert _rel_l2(got, want) <= REL
    crossed = 0
    for (path, sh), value in zip(tree_util.flatten_with_path(cache),
                                 ref["filled"]):
        if _is_cross(path):
            crossed += 1
            assert _rel_l2(sh.gather("cpu"), value) <= REL
    assert crossed == 2
