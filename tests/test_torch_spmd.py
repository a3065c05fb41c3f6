"""The sharded conv backend ``cuda_spmd`` against the single-device ``cuda``
backend and the JAX package's ``pallas`` backend.

Meshes are forced on the CPU (``make_forced_host_mesh(shape,
device="cpu")``), where every shard runs the kernels' plain versions.
Against the port's own ``cuda`` backend every output is held BIT for bit
(``torch.equal``): batch over 'data' and C_out over 'model' introduce no
cross-shard reduction.  Against the JAX ``pallas`` backend (one device,
interpret mode, its resilience chain off, int8 on its staged pipeline:
ROADMAP C1) the port contract holds: the
same int8 operands (the JAX prepared weights) give the int32 sums
exactly, the fp32 output within ``DEFAULT_TOL``.  The port's own chain is
left out: ``cuda_spmd`` runs the ``cuda`` backend's ``apply`` directly.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.api import lowering as jlowering  # noqa: E402
from repro.api import resilience as jresilience  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.quant.fake_quant import FP32 as JFP32  # noqa: E402
from repro.quant.fake_quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.api import (CompositePrepared, ConvSpec,  # noqa: E402
                             KernelConfig, get_backend, list_backends, plan,
                             tuning)
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import P, Sharded  # noqa: E402
from repro_torch.interop import prepared_from_jax  # noqa: E402
from repro_torch.launch.mesh import (make_forced_host_mesh,  # noqa: E402
                                     make_host_mesh)
from repro_torch.quant import FP32, INT8_FREQ  # noqa: E402
from repro_torch.testing import DEFAULT_TOL  # noqa: E402

MESHES = [(2, 2), (2, 1), (1, 2)]
QUANTS = {"int8": (INT8_FREQ, JINT8_FREQ), "fp": (FP32, JFP32)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke shapes gain nothing from more, and
    test processes that run side by side would each take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated_port_tuning_cache(tmp_path):
    """Plans carry configs from the port's timing cache: keep it empty."""
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    yield
    tuning.set_cache_path(None)


@pytest.fixture
def spmd():
    backend = get_backend("cuda_spmd")

    def use(shape):
        backend.set_mesh(make_forced_host_mesh(shape, device="cpu"))
        return backend

    yield use
    backend.set_mesh(None)


def _snapped(rng, shape):
    return (np.round(rng.randn(*shape) * 16) / 16).astype(np.float32)


def _data(b=4, hw=12, cin=16, cout=32, seed=0, r=3):
    rng = np.random.RandomState(seed)
    return (_snapped(rng, (b, hw, hw, cin)),
            (rng.randn(r, r, cin, cout) * 0.2).astype(np.float32))


def _port_prepared(jprep):
    """A JAX (possibly composite) prepared weights -> the port's."""
    if isinstance(jprep, jlowering.CompositePrepared):
        return CompositePrepared(
            w=torch.from_numpy(np.array(jprep.w)),
            subs=tuple(_port_prepared(s) for s in jprep.subs))
    return prepared_from_jax(jprep, device="cpu")


def _pair(x, w, quant="int8", algo="sfc6_6", *, padding="SAME", stride=1,
          depthwise=False, config=None):
    """(cuda_spmd plan, cuda plan, JAX pallas plan) for one spec."""
    q, jq = QUANTS[quant]
    make = ConvSpec.for_conv2d_depthwise if depthwise else ConvSpec.for_conv2d
    jmake = japi.ConvSpec.for_conv2d_depthwise if depthwise \
        else japi.ConvSpec.for_conv2d
    spec = make(x.shape, w.shape, padding=padding, stride=stride, quant=q)
    jspec = jmake(x.shape, w.shape, padding=padding, stride=stride,
                  quant=jq)
    p_s = plan(spec, backend="cuda_spmd", algo=algo)
    p_1 = plan(spec, backend="cuda", algo=algo)
    jp = japi.plan(jspec, backend="pallas", algo=algo)
    if config is not None:
        p_s, p_1 = p_s.with_config(config), p_1.with_config(config)
    if quant == "int8" and jp.path != "direct":
        # C1: the JAX fused kernels do not launch on this JAX; its staged
        # pipeline is the fused one's function bit for bit
        jp = jp.with_config(japi.tuning.DEFAULT_STAGED)
    assert p_s.path == p_1.path == jp.path
    return p_s, p_1, jp


def _act(p, x, quant):
    """The port's calibrated activation scales (None for fp)."""
    if quant != "int8" or p.path == "direct":
        return None
    if p.path == "lowered":
        return p.calibrate(x)
    return tuning.calibrate_act_scale(x, p.algorithm, p.spec.quant,
                                      p.spec.padding)


def _jax_out(jp, x, w, quant, bias=None):
    """(JAX pallas output, its prepared weights), the chain off."""
    with jresilience.configured(enabled=False):
        xj, wj = jnp.asarray(x), jnp.asarray(w)
        if quant == "int8" and jp.path == "lowered":
            jprep = jp.prepare_weights(wj, act_scale=jp.calibrate(xj))
        elif quant == "int8" and jp.path == "fast":
            act = japi.tuning.calibrate_act_scale(
                xj, jp.algorithm, jp.spec.quant, jp.spec.padding)
            jprep = jp.prepare_weights(wj, act_scale=act)
        else:
            jprep = jp.prepare_weights(wj)
        y = jp.apply(xj, jprep,
                     bias=None if bias is None else jnp.asarray(bias))
    return np.asarray(y), jprep


def _check(x, w, quant="int8", algo="sfc6_6", bias=None, **kw):
    """cuda_spmd: bit for bit the cuda backend on the port's own prepared
    weights, and within DEFAULT_TOL of JAX's pallas on JAX's."""
    p_s, p_1, jp = _pair(x, w, quant, algo, **kw)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    bt = None if bias is None else torch.from_numpy(bias)
    act = _act(p_1, xt, quant)
    y_s = p_s.apply(xt, p_s.prepare_weights(wt, act_scale=act), bias=bt)
    y_1 = p_1.apply(xt, p_1.prepare_weights(wt, act_scale=act), bias=bt)
    assert y_s.shape == y_1.shape and y_s.device == xt.device
    assert torch.equal(y_s, y_1)
    want, jprep = _jax_out(jp, x, w, quant, bias)
    got = p_s.apply(xt, _port_prepared(jprep), bias=bt)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=DEFAULT_TOL,
                               atol=DEFAULT_TOL)
    return p_s, y_s


def test_cuda_spmd_is_registered():
    assert "cuda_spmd" in list_backends()
    backend = get_backend("cuda_spmd")
    assert backend.name == "cuda_spmd" and backend.integer_datapath
    # registered at its first lookup: importing the api imports no
    # distributed code (and so resolves no mesh)
    import subprocess
    import sys
    code = ("import sys, repro_torch.api as a; "
            "assert 'repro_torch.distributed' not in sys.modules; "
            "assert 'cuda_spmd' in a.list_backends(); "
            "assert 'repro_torch.distributed.conv_spmd' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("mesh", MESHES)
def test_int8_fused_parity(spmd, mesh, padding):
    """Fused int8 datapath (B4), batch and C_out sharded."""
    spmd(mesh)
    _check(*_data(), padding=padding)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("mesh", MESHES)
def test_int8_staged_parity(spmd, mesh, padding):
    """The staged trio B1 -> B2 -> B3 shards identically (a config riding
    the plan does not break the sharded dispatch)."""
    spmd(mesh)
    _check(*_data(seed=1), padding=padding, config=tuning.DEFAULT_STAGED)


@pytest.mark.parametrize("mesh", MESHES)
def test_fp_fast_parity(spmd, mesh):
    """fp transform-domain path (B5 -> f32 product -> B3)."""
    spmd(mesh)
    _check(*_data(seed=2), quant="fp")


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("mesh", MESHES)
def test_bias_sharded_with_cout(spmd, mesh, quant):
    spmd(mesh)
    x, w = _data(seed=3)
    _check(x, w, quant, bias=np.arange(w.shape[-1], dtype=np.float32))


@pytest.mark.parametrize("mesh,b,cout", [((2, 1), 1, 32), ((2, 2), 3, 32),
                                         ((1, 4), 4, 18), ((2, 4), 1, 18)])
def test_nondivisible_axes_sanitized(spmd, mesh, b, cout):
    """Batch 1 or 3 on a 2-way data axis and C_out 18 on a 4-way model
    axis drop to replication (sanitize_pspec) instead of raising, and the
    result stays bit for bit the single-device one."""
    backend = spmd(mesh)
    x, w = _data(b=b, hw=10, cout=cout, seed=4)
    p_s, _ = _check(x, w)
    prep = p_s.prepare_weights(torch.from_numpy(w), act_scale=_act(
        p_s, torch.from_numpy(x), "int8"))
    # C_out % model != 0: the prepared weights degraded to replication
    assert prep.wq.is_fully_replicated == (cout % mesh[1] != 0)
    assert backend.mesh.shape == {"data": mesh[0], "model": mesh[1]}


@pytest.mark.parametrize("mesh", MESHES)
def test_direct_path_parity(spmd, mesh):
    """A 1x1 stride-2 conv (a ResNet projection shortcut) stays on the
    direct path, sharded over batch and output channels."""
    spmd(mesh)
    x, w = _data(seed=5, r=1)
    p_s, _ = _check(x, w, quant="fp", algo="auto", stride=2)
    assert p_s.path == "direct"


@pytest.mark.parametrize("quant", sorted(QUANTS))
@pytest.mark.parametrize("mesh", MESHES)
def test_lowered_polyphase_parity(spmd, mesh, quant):
    """A lowered stride-2 plan on cuda_spmd: every polyphase sub-plan
    inherits the backend, so each sub-conv is its own sharded apply with
    its own placement — bit for bit the single-device composite (the
    phase sum adds in the same order)."""
    spmd(mesh)
    x, w = _data(seed=9)
    p_s, _ = _check(x, w, quant, algo="sfc4_4_r2", stride=2)
    assert p_s.path == "lowered"
    assert all(sp.backend == "cuda_spmd" for sp in p_s.sub_plans)
    if quant == "int8" and mesh[1] > 1:
        xt = torch.from_numpy(x)
        prep = p_s.prepare_weights(torch.from_numpy(w),
                                   act_scale=p_s.calibrate(xt))
        fast = [sp for sp, pr in zip(p_s.sub_plans, prep.subs)
                if sp.path == "fast"]
        assert fast and all(
            pr.wq.shard((0, 0)).shape[-1] == w.shape[-1] // mesh[1]
            for sp, pr in zip(p_s.sub_plans, prep.subs)
            if sp.path == "fast")


@pytest.mark.parametrize("quant,datapath", [("int8", "fused"),
                                             ("int8", "staged"),
                                             ("fp", "fused")])
@pytest.mark.parametrize("mesh", MESHES)
def test_depthwise_channel_sharded_parity(spmd, mesh, quant, datapath):
    """2-D depthwise shards its single channel axis over 'model' on the
    input and the weights (B7, or B1 -> B6 -> B3; fp B5 -> product -> B3,
    whatever the config)."""
    spmd(mesh)
    rng = np.random.RandomState(10)
    x = _snapped(rng, (4, 12, 12, 16))
    w = (rng.randn(3, 3, 1, 16) * 0.3).astype(np.float32)
    p_s, _ = _check(x, w, quant, depthwise=True,
                    config=KernelConfig(datapath=datapath))
    assert p_s.path == "fast"


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)])
def test_prepared_weights_device_sharded(spmd, mesh):
    """prepare_weights places wq/w_scale (and tw) C_out-sharded on the
    mesh; the activation scales stay replicated; re-prepare hands back
    the placed copy."""
    spmd(mesh)
    x, w = _data()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    p_s, _, _ = _pair(x, w)
    prep = p_s.prepare_weights(wt, act_scale=_act(p_s, xt, "int8"))
    cout, m = w.shape[-1], mesh[1]
    for coord in make_forced_host_mesh(mesh, device="cpu").coords():
        assert prep.wq.shard(coord).shape == (100, 16, cout // m)
        assert prep.w_scale.shard(coord).shape == (10, 10, cout // m)
        assert prep.tw.shard(coord).shape == (10, 10, 16, cout // m)
        assert prep.act_scale.shard(coord).shape == (10, 10)
        assert prep.wq.shard(coord).device == torch.device("cpu")
    assert prep.wq.spec == P(None, None, "model") == (None, None, "model")
    assert P(("data",), None) == ("data", None)
    assert prep.act_scale.is_fully_replicated
    # each shard holds its block: the gathered tensors are the unsharded
    p_1 = plan(p_s.spec, backend="cuda", algo="sfc6_6")
    prep_1 = p_1.prepare_weights(wt, act_scale=prep.act_scale.gather())
    assert torch.equal(prep.wq.gather(), prep_1.wq)
    assert torch.equal(prep.w_scale.gather(), prep_1.w_scale)
    # memoized: the placed copy is returned on re-prepare
    act = prep.act_scale.gather()
    prep2 = p_s.prepare_weights(wt, act_scale=act)
    assert p_s.prepare_weights(wt, act_scale=act) is prep2
    assert isinstance(prep2.wq, Sharded)


def test_set_mesh_drops_plans_of_the_old_mesh(spmd):
    """A new mesh invalidates memoized plans (their prepared-weight caches
    hold placements for the old mesh), and a placement for another mesh
    is re-cut at apply."""
    backend = spmd((2, 2))
    x, w = _data(seed=6)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    p_old, p_1, _ = _pair(x, w)
    act = _act(p_1, xt, "int8")
    prep_old = p_old.prepare_weights(wt, act_scale=act)
    backend.set_mesh(make_forced_host_mesh((1, 4), device="cpu"))
    p_new, _, _ = _pair(x, w)
    assert p_new is not p_old
    prep_new = p_new.prepare_weights(wt, act_scale=act)
    assert prep_new.wq.mesh is backend.mesh
    assert prep_new.wq.shard((0, 0)).shape[-1] == 8
    want = p_1.apply(xt, p_1.prepare_weights(wt, act_scale=act))
    assert torch.equal(p_new.apply(xt, prep_new), want)
    assert torch.equal(p_new.apply(xt, prep_old), want)


def test_rank1_depthwise_delegates(spmd):
    """rank-1 depthwise goes to the cuda backend whole, which runs the
    reference fast path (as the JAX pallas backend does): bit for bit the
    one-device result, within DEFAULT_TOL of the JAX reference backend."""
    spmd((2, 2))
    rng = np.random.RandomState(6)
    x = rng.randn(2, 24, 8).astype(np.float32)
    w = (rng.randn(4, 8) * 0.3).astype(np.float32)
    spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    ys = {backend: plan(spec, backend=backend, algo="auto").apply(
        torch.from_numpy(x), torch.from_numpy(w))
        for backend in ("cuda", "cuda_spmd")}
    assert torch.equal(ys["cuda_spmd"], ys["cuda"])
    want = japi.plan(japi.ConvSpec.for_conv1d_depthwise(x.shape, w.shape),
                     algo="auto").apply(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(ys["cuda"].numpy(), np.asarray(want),
                               rtol=DEFAULT_TOL, atol=DEFAULT_TOL)


@pytest.mark.parametrize("config", [
    KernelConfig(datapath="fused", k_block=64),
    KernelConfig(datapath="fused", k_block=32, cout_block=16),
    KernelConfig(datapath="fused", k_block=32, cout_block=8),
    KernelConfig(datapath="staged", k_block=4)])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_tuned_config_rides_shards(spmd, mesh, config):
    """A tuned KernelConfig rides the plan into every shard: at (1, 4) a
    shard's C_out (8) is below cout_block 16, and B4 pads the block as it
    pads a ragged C_out on one device."""
    spmd(mesh)
    x, w = _data(seed=8, hw=8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    p_s, p_1, _ = _pair(x, w, config=config)
    act = _act(p_1, xt, "int8")
    want = p_1.with_config(tuning.DEFAULT_FUSED).apply(
        xt, p_1.prepare_weights(wt, act_scale=act))
    assert torch.equal(p_s.apply(xt, p_s.prepare_weights(wt, act_scale=act)),
                       want)


def test_every_shard_runs_its_kernels(spmd, monkeypatch):
    """Each mesh coordinate runs its shard, replicas included: the
    wrappers are entered once per shard and conv (on the CPU they run
    their plain versions, so the wrappers are counted here)."""
    from repro_torch.kernels import sfc_fused
    spmd((2, 2))
    calls = []
    fused = sfc_fused.sfc_fused_conv2d

    def counting(x, *a, **k):
        calls.append(tuple(x.shape))
        return fused(x, *a, **k)

    monkeypatch.setattr(sfc_fused, "sfc_fused_conv2d", counting)
    for b in (4, 1):
        calls.clear()
        x, w = _data(b=b, seed=11)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        p_s, p_1, _ = _pair(x, w)
        act = _act(p_1, xt, "int8")
        p_s.apply(xt, p_s.prepare_weights(wt, act_scale=act))
        assert calls == [(max(b // 2, 1), 12, 12, 16)] * 4
    assert kernels.launch_counts()["sfc_fused_conv2d"] == 0   # CPU: plain


def test_hook_raises(spmd):
    spmd((2, 1))
    x, w = _data()
    p_s, _, _ = _pair(x, w, quant="fp")
    with pytest.raises(ValueError, match="elementwise_hook"):
        get_backend("cuda_spmd").apply(
            p_s, torch.from_numpy(x), p_s.prepare_weights(torch.from_numpy(w)),
            elementwise_hook=lambda tx, tw: (tx, tw))


@pytest.mark.parametrize("mesh", MESHES)
def test_grouped_direct_stays_replicated(spmd, mesh):
    """A grouped spec planned direct keeps C_out whole (a slice would
    misalign the groups) and still gives the single-device bits."""
    spmd(mesh)
    x, w = _data(seed=12, cout=16)
    w = w[:, :, :8, :]
    spec = ConvSpec.for_conv2d(x.shape, w.shape, groups=2)
    p_s = plan(spec, backend="cuda_spmd", algo="direct")
    p_1 = plan(spec, backend="cuda", algo="direct")
    assert p_s.path == "direct"
    xt, wt = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w))
    assert torch.equal(p_s.apply(xt, wt), p_1.apply(xt, wt))


_MESH_SHAPES = [{"data": 2, "model": 4}, {"data": 1, "model": 2},
                {"pod": 2, "data": 2, "model": 2}, {"data": 3, "model": 1}]
_SPECS = [("data", None, None, "model"), (("data",), None, None, None),
          (("pod", "data"), None, "model"), (None, ("data", "model")),
          ("model",), ()]
_SHAPES = [(4, 12, 12, 32), (1, 8, 8, 18), (6, 6, 2, 8), (3, 2, 5, 3)]


def _names(spec):
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


@pytest.mark.parametrize("axes,spec,shape", [
    (axes, spec, shape) for axes in _MESH_SHAPES for spec in _SPECS
    for shape in _SHAPES if _names(spec) <= set(axes)])
def test_sanitize_pspec_and_batch_axes_match_jax(axes, spec, shape):
    """The JAX functions on a duck-typed mesh (``shape`` and
    ``axis_names`` only)."""
    mesh = types.SimpleNamespace(shape=axes, axis_names=tuple(axes))
    assert sharding.batch_axes(mesh) == jsharding.batch_axes(mesh)
    got = sharding.sanitize_pspec(P(*spec), shape, mesh)
    want = jsharding.sanitize_pspec(JP(*spec), shape, mesh)
    assert tuple(got) == tuple(want)
    specs = sharding.batch_pspecs({"x": torch.zeros(shape)}, mesh)
    assert specs["x"] == P(sharding.batch_axes(mesh),
                           *(None,) * (len(shape) - 1))


@pytest.mark.parametrize("spec", [P(("data",), None, None, "model"),
                                  P(None, ("data", "model")), P("model"),
                                  P(None, None, None, None),
                                  P(("model", "data"))])
def test_sharded_place_and_gather(spec):
    """Blocks are cut a-major over a dimension's axes, as JAX cuts them,
    and gather joins one replica of each."""
    mesh = make_forced_host_mesh((2, 2), device="cpu")
    x = torch.arange(4 * 4 * 2 * 8, dtype=torch.float32).reshape(4, 4, 2, 8)
    s = Sharded.place(x, spec, mesh)
    assert torch.equal(s.gather(), x) and s.shape == tuple(x.shape)
    if spec == P(("model", "data")):
        # dim 0 over (model, data): coordinate (data 1, model 0) holds
        # block 0 * 2 + 1
        assert torch.equal(s.shard((1, 0)), x[1:2])
        assert torch.equal(s.shard((0, 1)), x[2:3])
    for coord in mesh.coords():
        assert s.shard(coord).is_contiguous()
    again = Sharded.from_shards(mesh, s.spec, s.shards)
    assert again.shape == s.shape and torch.equal(again.gather(), x)


def test_mesh_helpers():
    mesh = make_forced_host_mesh((2, 2), device="cpu")
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_host_mesh(device="cpu").shape == {"data": 1, "model": 1}
    pod = make_forced_host_mesh((2, 1, 2), ("pod", "data", "model"),
                                device="cpu")
    assert sharding.batch_axes(pod) == ("pod", "data")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            make_host_mesh()
        with pytest.raises(ValueError, match="needs 2 devices"):
            make_forced_host_mesh((2, 1))


def test_opt_state_pspecs():
    from repro_torch.optim import AdamWState
    specs = {"w": P(None, "model")}
    got = sharding.opt_state_pspecs(None, specs)
    assert isinstance(got, AdamWState)
    assert got.step == P() and got.mu is specs and got.nu is specs
