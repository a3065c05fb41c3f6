"""``repro_torch.optim.compressed_psum`` across two gloo ranks, held to the
JAX package's ``compressed_psum`` (``psum``/``pmax`` under ``jax.vmap``
with a named axis, on one CPU device).

Each rank is a process of its own (``torch.distributed`` with a
``FileStore`` in the test's directory); the group and the processes have
timeouts, so a hang fails the test instead of holding the suite.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import grad_compression as jgc  # noqa: E402
from repro_torch.optim import grad_compression as gc  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 120

# one rank: quantize its own x (or take given codes and scale), all-reduce
_RANK = r"""
import datetime, sys
import torch, torch.distributed as dist
from repro_torch.optim import grad_compression as gc
rank, world, store, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
data = torch.load(inp)
if "codes" in data:
    # the same int8 codes and scales as the JAX side: the reduction alone
    codes, scales = data["codes"][rank], data["scales"][rank]
    gc.quantize_int8 = lambda x, generator: (codes, scales)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
try:
    gen = torch.Generator().manual_seed(data["seeds"][rank])
    y = gc.compressed_psum(data["x"][rank], gen)
    torch.save({"y": y}, out)
finally:
    dist.destroy_process_group()
"""


def _run_ranks(tmp_path, data):
    """compressed_psum on WORLD gloo ranks; each rank's result."""
    torch.save(data, tmp_path / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(WORLD),
         str(tmp_path / "store"), str(tmp_path / "in.pt"),
         str(tmp_path / f"out{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    return [torch.load(tmp_path / f"out{r}.pt")["y"] for r in range(WORLD)]


def _xs(seed, n=257):
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(n) * (r + 1), dtype=torch.float32)
            for r in range(WORLD)]


def test_matches_jax_on_the_same_codes(tmp_path):
    """Given each rank's int8 codes and scale, the int32 sum times the
    largest scale is the JAX function's, bit for bit, on every rank."""
    xs = _xs(0)
    seeds = [11, 12]
    codes, scales = zip(*(gc.quantize_int8(x, torch.Generator().manual_seed(
        s)) for x, s in zip(xs, seeds)))
    got = _run_ranks(tmp_path, {"x": xs, "seeds": seeds,
                                "codes": list(codes),
                                "scales": list(scales)})
    # JAX: the same codes and scales through its psum/pmax over a named
    # axis, its quantizer replaced by a lookup of the given codes
    jcodes = jnp.asarray(np.stack([c.numpy() for c in codes]))
    jscales = jnp.asarray(np.stack([s.numpy() for s in scales]))
    quantize = jgc.quantize_int8
    try:
        jgc.quantize_int8 = lambda q, s: (q, s)
        want = jax.vmap(lambda q, s: jgc.compressed_psum(q, "ranks", s),
                        axis_name="ranks")(jcodes, jscales)
    finally:
        jgc.quantize_int8 = quantize
    want = np.asarray(want)
    for r in range(WORLD):
        assert got[r].dtype == torch.float32
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    assert torch.equal(got[0], got[1])


def test_each_rank_quantizes_its_own_gradient(tmp_path):
    """Every rank gets sum_r q_r times max_r s_r, each q_r drawn by that
    rank's own generator (the JAX function's formula on the port's
    quantizer)."""
    xs, seeds = _xs(1), [3, 4]
    got = _run_ranks(tmp_path, {"x": xs, "seeds": seeds})
    parts = [gc.quantize_int8(x, torch.Generator().manual_seed(s))
             for x, s in zip(xs, seeds)]
    total = sum(q.to(torch.int32) for q, _ in parts)
    want = total.to(torch.float32) * max(s for _, s in parts)
    for y in got:
        assert torch.equal(y, want)


def test_rounding_is_unbiased(tmp_path):
    """The sum is unbiased where the ranks share a scale: over 400 seeds
    the mean of compressed sums is within 5 standard errors of the true
    sum (each rank's error is uniform within one step), as
    ``quantize_int8`` is held."""
    x = _xs(2)[0]
    scale = (x.abs().max() / 127).item()
    sums = []
    for seed in range(400):
        gens = [torch.Generator().manual_seed(1000 * seed + r)
                for r in range(WORLD)]
        qs = [gc.quantize_int8(x, g) for g in gens]
        sums.append((sum(q.to(torch.int32) for q, _ in qs).to(torch.float32)
                     * max(s for _, s in qs)).numpy())
    bound = 5 * WORLD ** 0.5 * (scale / 2) / np.sqrt(400)
    assert np.abs(np.mean(sums, axis=0) - WORLD * x.numpy()).max() <= bound
    # and the two-rank group gives one of those draws
    got = _run_ranks(tmp_path, {"x": [x, x], "seeds": [0, 1]})
    np.testing.assert_array_equal(got[0].numpy(), sums[0])
