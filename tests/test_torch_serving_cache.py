"""The port's ConvSpec-keyed serving cache (``repro_torch.api.serving_cache``).

Held to the JAX package's ``repro.api.serving_cache``: the same sequence of
``get`` calls gives the same hit, miss, prepare, eviction and size
accounting in both (JAX on its ``reference`` backend, the port on its
``reference`` and ``cuda`` backends), and the prepared int8 weights agree
(``wq`` exactly, the scales within 1e-6 relative).  Port-specific: an
unkeyed entry misses after an in-place update of its weights (torch
tensors change in place, JAX arrays cannot), and the ``cache`` fault site
fires.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import ConvSpec as JConvSpec  # noqa: E402
from repro.api import tuning as jtuning  # noqa: E402
from repro.api.serving_cache import ServingCache as JServingCache  # noqa: E402
from repro.quant import INT8_FREQ as JINT8_FREQ  # noqa: E402

from repro_torch import faults  # noqa: E402
from repro_torch.api import (ConvSpec, costmodel, serving_cache,  # noqa: E402
                             tuning)
from repro_torch.api.serving_cache import ServingCache  # noqa: E402
from repro_torch.quant import INT8_FREQ  # noqa: E402

CIN, COUT = 8, 16


@pytest.fixture(autouse=True)
def _isolated(tmp_path):
    tuning.set_cache_path(str(tmp_path / "port_tuning.json"))
    costmodel.set_cache_path(str(tmp_path / "port_costmodel.json"))
    serving_cache.clear()
    yield
    serving_cache.clear()
    tuning.set_cache_path(None)
    costmodel.set_cache_path(None)


def _spec(hw, port=True):
    make, q = (ConvSpec, INT8_FREQ) if port else (JConvSpec, JINT8_FREQ)
    return make(kernel_size=3, in_channels=CIN, out_channels=COUT,
                spatial=(hw, hw), quant=q)


def _weights(seeds):
    out = []
    for s in seeds:
        w = np.random.RandomState(s).randn(3, 3, CIN, COUT) * 0.2
        out.append(w.astype(np.float32))
    return out


# the same call sequence for both caches: (bucket, weights index, key?)
SEQUENCE = [(10, 0, None), (10, 0, None), (12, 0, None), (10, 1, None),
            (14, 0, "k14"), (14, 1, "k14"), (10, 0, None), (12, 0, None),
            (16, 2, None), (10, 1, None)]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("maxsize", [2, 3, 8])
def test_accounting_matches_jax(backend, maxsize):
    ws = _weights(range(3))
    wt = [torch.from_numpy(w) for w in ws]
    wj = [jnp.asarray(w) for w in ws]
    mine, theirs = ServingCache(maxsize), JServingCache(maxsize)
    for hw, wi, key in SEQUENCE:
        mine.get(_spec(hw), wt[wi], backend=backend, algo="sfc6_6", key=key)
        theirs.get(_spec(hw, port=False), wj[wi], backend="reference",
                   algo="sfc6_6", key=key)
        assert mine.stats() == theirs.stats(), (hw, wi, key)
    assert mine.stats()["evictions"] == theirs.stats()["evictions"]


def test_prepared_int8_weights_match_jax():
    w = _weights([5])[0]
    x = np.random.RandomState(6).randn(1, 12, 12, CIN).astype(np.float32)
    p, _ = serving_cache.get(_spec(12), torch.from_numpy(w),
                             backend="cuda", algo="sfc6_6")
    act = tuning.calibrate_act_scale(torch.from_numpy(x), p.algorithm,
                                     INT8_FREQ)
    _, prep = serving_cache.get(_spec(12), torch.from_numpy(w),
                                backend="cuda", algo="sfc6_6",
                                act_scale=act)
    jp, _ = JServingCache().get(_spec(12, port=False), jnp.asarray(w),
                                algo="sfc6_6")
    jact = jtuning.calibrate_act_scale(jnp.asarray(x), jp.algorithm,
                                       JINT8_FREQ)
    _, jprep = JServingCache().get(_spec(12, port=False), jnp.asarray(w),
                                   algo="sfc6_6", act_scale=jact)
    np.testing.assert_allclose(prep.act_scale.numpy(),
                               np.asarray(jprep.act_scale), rtol=1e-6)
    np.testing.assert_allclose(prep.w_scale.numpy(),
                               np.asarray(jprep.w_scale), rtol=1e-6)
    assert np.array_equal(prep.wq.numpy(), np.asarray(jprep.wq))


def test_same_spec_reuses_plan_and_prep():
    w = torch.from_numpy(_weights([0])[0])
    p1, prep1 = serving_cache.get(_spec(10), w, backend="cuda")
    p2, prep2 = serving_cache.get(_spec(10), w, backend="cuda")
    assert p1 is p2 and prep1 is prep2
    assert serving_cache.stats() == {"hits": 1, "misses": 1, "prepares": 1,
                                     "evictions": 0, "size": 1}


def test_keyed_entries_survive_reslicing():
    stacked = torch.from_numpy(np.stack(_weights([1, 2])))
    for _ in range(3):                  # new slice objects every pass
        for i in range(2):
            serving_cache.get(_spec(10), stacked[i], key=("conv_w", i))
    s = serving_cache.stats()
    assert s["prepares"] == 2 and s["hits"] == 4 and s["size"] == 2


def test_inplace_update_misses_unkeyed_entry():
    """An unkeyed entry is found by its operands' identity and version:
    weights updated in place are prepared anew."""
    w = torch.from_numpy(_weights([3])[0])
    _, prep1 = serving_cache.get(_spec(10), w, backend="cuda")
    w.mul_(2.0)
    _, prep2 = serving_cache.get(_spec(10), w, backend="cuda")
    assert prep2 is not prep1
    torch.testing.assert_close(prep2.tw, 2.0 * prep1.tw)
    assert serving_cache.stats()["prepares"] == 2


def test_plan_invalidation_reprepares():
    """A tuning record mints new plans; an entry prepared under the old
    plan is prepared again, never paired with the new one."""
    w = torch.from_numpy(_weights([4])[0])
    p1, _ = serving_cache.get(_spec(10), w, backend="cuda", key="w")
    tuning.record(_spec(10), "cuda", p1.algo_name, 1e-3,
                  tuning.DEFAULT_STAGED)
    p2, _ = serving_cache.get(_spec(10), w, backend="cuda", key="w")
    assert p2 is not p1 and p2.config == tuning.DEFAULT_STAGED
    s = serving_cache.stats()
    assert s["prepares"] == 2 and s["evictions"] == 0 and s["size"] == 1


def test_maxsize_env_var(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SERVING_CACHE_SIZE", "3")
    assert serving_cache.default_maxsize() == 3
    for bad in ("zero", "0", "-4"):
        monkeypatch.setenv("REPRO_TORCH_SERVING_CACHE_SIZE", bad)
        assert serving_cache.default_maxsize() == 256
    with pytest.raises(ValueError, match="maxsize"):
        ServingCache(0)


def test_cache_fault_site_fires():
    w = torch.from_numpy(_weights([0])[0])
    with faults.inject({faults.CACHE: faults.FaultSpec(times=1)}) as fp:
        with pytest.raises(faults.InjectedFault):
            serving_cache.get(_spec(10), w)
        serving_cache.get(_spec(10), w)
    assert fp.injected(faults.CACHE) == 1
    assert serving_cache.stats()["prepares"] == 1
