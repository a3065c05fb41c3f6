"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX
package's: round trip, retention, corruption, a missing checkpoint, bf16
leaves, and checkpoints that each package writes restoring in the other."""
import json
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(8, 16).astype(np.float32),
            "b": rng.randn(16).astype(np.float32),
            "m": rng.randn(8, 16).astype(np.float32)}


def _tree(seed=0):
    a = _arrays(seed)
    return {"params": {"w": torch.tensor(a["w"]),
                       "b": torch.tensor(a["b"], dtype=torch.bfloat16)},
            "opt": {"mu": {"w": torch.tensor(a["m"])}},
            "step": torch.tensor(7, dtype=torch.int32),
            "seq": [torch.tensor([1.0, 2.0]),
                    torch.tensor([3], dtype=torch.int64)]}


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_roundtrip_keeps_dtypes_and_bits(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(7, tree, blocking=True)
    like = _tree(seed=1)
    restored, step = ck.restore(like)
    assert step == 7
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert isinstance(restored["seq"], list)
    manifest = json.loads(next(pathlib.Path(tmp_path).glob(
        "step_*")).joinpath("manifest.json").read_text())
    assert manifest["dtypes"]["params/b"] == "bfloat16"
    assert manifest["keys"] == sorted(["opt/mu/w", "params/b", "params/w",
                                       "seq/#0", "seq/#1", "step"])
    ck.close()


def test_restore_follows_the_templates_dtype(tmp_path):
    # a leaf comes back as its template leaf's dtype (and device)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.arange(4, dtype=torch.float32)}, blocking=True)
    got, _ = ck.restore({"x": torch.zeros(4, dtype=torch.float64)})
    assert got["x"].dtype == torch.float64 and got["x"].device.type == "cpu"
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(4))
    ck.close()


def test_latest_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree)            # asynchronous: each waits for the last
    ck.wait()
    assert ck.latest_step() == 4
    kept = sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*"))
    assert len(kept) == 2 and kept[-1].endswith("4".zfill(12))
    assert not list(pathlib.Path(tmp_path).glob(".tmp-*"))
    _, step = ck.restore(_tree(), step=3)
    assert step == 3
    ck.close()


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    d = next(pathlib.Path(tmp_path).glob("step_*"))
    blob = (d / "arrays.npz").read_bytes()
    (d / "arrays.npz").write_bytes(b"CORR" + blob[4:])
    with pytest.raises(IOError):
        ck.restore(_tree())
    ck.close()


def test_resume_from_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore(_tree())


def _state_trees(seed=0):
    """The same {"params", "opt": AdamWState} tree in both packages, the
    state a real AdamW step leaves (bf16 params, float32 moments)."""
    a = _arrays(seed)
    np_params = {"stem": {"w": a["w"]}, "head": {"b": a["b"]}}
    jparams = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.bfloat16), np_params)
    jopt = JAdamW(lr=1e-2)
    jgrads = jax.tree_util.tree_map(lambda x: jnp.ones(x.shape), np_params)
    jparams, jstate, _ = jopt.apply(jparams, jgrads, jopt.init(jparams))
    jtree = {"params": jparams, "opt": jstate}
    tparams = params_from_numpy(np_params, "cpu")
    tparams = {k: {n: t.to(torch.bfloat16) for n, t in v.items()}
               for k, v in tparams.items()}
    ttree = {"params": tparams, "opt": AdamW(lr=1e-2).init(tparams)}
    return jtree, ttree


def _np_bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def test_a_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _state_trees()
    JCheckpointer(str(tmp_path)).save(5, jtree, blocking=True)
    restored, step = Checkpointer(str(tmp_path)).restore(ttree)
    assert step == 5
    want = {"/".join(str(getattr(p, "key", getattr(p, "name", None)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = {"/".join(str(p) for p in path): leaf
           for path, leaf in flatten_with_path(restored)}
    assert set(got) == set(want) and "opt/mu/stem/w" in got
    for k, t in got.items():
        w = np.asarray(want[k])
        assert t.shape == w.shape
        if w.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16), _np_bits(w))
        else:
            np.testing.assert_array_equal(t.numpy(), w)
    assert restored["opt"].step.dtype == torch.int32
    assert int(restored["opt"].step) == 1


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    jtree, ttree = _state_trees()
    # give the port's state values of its own: one AdamW step
    grads = {k: {n: torch.ones(t.shape) for n, t in v.items()}
             for k, v in ttree["params"].items()}
    params, state, _ = AdamW(lr=1e-2).apply(ttree["params"], grads,
                                            ttree["opt"])
    ttree = {"params": params, "opt": state}
    ck = Checkpointer(str(tmp_path))
    ck.save(9, ttree, blocking=True)
    ck.close()
    jrestored, step = JCheckpointer(str(tmp_path)).restore(jtree)
    assert step == 9
    jflat = jax.tree_util.tree_leaves(jrestored)
    assert len(jflat) == len(leaves(ttree))
    for j, t in zip(jflat, leaves(ttree)):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert j.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(
                j.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
        else:
            assert j.dtype == t.numpy().dtype
            np.testing.assert_array_equal(j, t.numpy())
    np.testing.assert_array_equal(np.asarray(jrestored["opt"].step), 1)
