"""The port's GPipe schedule (``repro_torch.distributed.pipeline``)
against the JAX package's and against the sequential stack.

JAX's ``pipeline_apply`` needs a 4-device mesh, so it runs in a
subprocess with ``--xla_force_host_platform_device_count=4``, as
``tests/test_pipeline.py::test_gpipe_matches_sequential`` runs it, and
writes its output beside the seeded inputs; the port runs the same
inputs over a 4-stage CPU mesh.  Forward within 1e-5 of JAX's and of the
sequential stack; the gradients through the schedule within 1e-5 of the
sequential stack's.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.pipeline import (  # noqa: E402
    pipeline_apply, stack_params_for_stages)
from repro_torch.launch.mesh import make_forced_host_mesh  # noqa: E402

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
L, D, BATCH, STAGES, MICRO = 8, 16, 8, 4, 4
TOL = 1e-5


def _inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(L, D, D).astype(np.float32) * 0.2,
            rng.randn(BATCH, D).astype(np.float32))


def _layer(w, x):
    return torch.tanh(x @ w)


def _stage_fn(stage_params, x):
    for i in range(stage_params["w"].shape[0]):
        x = _layer(stage_params["w"][i], x)
    return x


def _sequential(ws, x):
    for i in range(L):
        x = _layer(ws[i], x)
    return x


def _jax_pipeline(tmp_path) -> np.ndarray:
    ws, x = _inputs()
    np.save(tmp_path / "ws.npy", ws)
    np.save(tmp_path / "x.npy", x)
    code = f"""
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import (pipeline_apply,
                                            stack_params_for_stages)
    mesh = jax.make_mesh(({STAGES},), ("stage",))
    Ws = jnp.asarray(np.load({str(tmp_path / 'ws.npy')!r}))
    x = jnp.asarray(np.load({str(tmp_path / 'x.npy')!r}))

    def stage_fn(stage_params, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        x, _ = jax.lax.scan(body, x, stage_params)
        return x

    staged = stack_params_for_stages({{"w": Ws}}, {STAGES})["w"]
    y = pipeline_apply(stage_fn, staged, x, n_micro={MICRO}, mesh=mesh,
                       axis="stage")
    np.save({str(tmp_path / 'y.npy')!r}, np.asarray(y))
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={STAGES}"
    env["PYTHONPATH"] = SRC
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=420, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return np.load(tmp_path / "y.npy")


def test_gpipe_matches_jax_and_sequential(tmp_path):
    ws, x = _inputs()
    want = _jax_pipeline(tmp_path)
    mesh = make_forced_host_mesh((STAGES,), ("stage",), device="cpu")
    staged = stack_params_for_stages({"w": torch.from_numpy(ws)}, STAGES)
    y = pipeline_apply(_stage_fn, staged, torch.from_numpy(x), MICRO, mesh)
    assert y.shape == (BATCH, D)
    assert np.abs(y.numpy() - want).max() < TOL
    seq = _sequential(torch.from_numpy(ws), torch.from_numpy(x))
    assert (y - seq).abs().max().item() < TOL


@pytest.mark.parametrize("micro", [1, 2, 4, 8])
def test_gpipe_gradients_match_sequential(micro):
    """Autograd through the schedule (stage devices, the hops and the
    output's gather): the input's and every layer's gradient within 1e-5
    of the sequential stack's, for each microbatch count."""
    ws, x = _inputs()
    mesh = make_forced_host_mesh((2, STAGES), ("data", "stage"),
                                 device="cpu")
    g = torch.from_numpy(np.random.RandomState(1).randn(BATCH, D).astype(
        np.float32))
    w1 = torch.from_numpy(ws).requires_grad_()
    x1 = torch.from_numpy(x).requires_grad_()
    y = pipeline_apply(_stage_fn, stack_params_for_stages({"w": w1}, STAGES),
                       x1, micro, mesh)
    dw1, dx1 = torch.autograd.grad(y, (w1, x1), g)
    w2 = torch.from_numpy(ws).requires_grad_()
    x2 = torch.from_numpy(x).requires_grad_()
    y2 = _sequential(w2, x2)
    dw2, dx2 = torch.autograd.grad(y2, (w2, x2), g)
    assert (y - y2).abs().max().item() < TOL
    assert (dw1 - dw2).abs().max().item() < TOL
    assert (dx1 - dx2).abs().max().item() < TOL


def test_stage_stacking_refuses_a_ragged_split():
    staged = stack_params_for_stages({"w": torch.zeros(8, 3)}, 4)
    assert staged["w"].shape == (4, 2, 3)
    with pytest.raises(ValueError):
        stack_params_for_stages({"w": torch.zeros(6, 3)}, 4)
