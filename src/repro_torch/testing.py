"""Differential conformance oracle of the port's conv datapaths, and
the check of a placed output (:func:`assert_placed`).

  * the ``cuda`` backend's staged pipeline (B1 -> B2 -> B3; depthwise
    B1 -> B6 -> B3) and its fused kernel (B4; depthwise B7) run one
    integer grid with the same static scales, so both are held to the
    ``reference`` backend's static-int8 simulation, and to each other,
    within :data:`DEFAULT_TOL`;
  * fp specs run the ``cuda`` backend's fp path (B5 -> f32 product -> B3)
    against the ``reference`` backend's fp fast path;
  * degraded (direct) plans are an error unless the caller allows them.

The JAX package holds its Pallas datapaths to bit identity; across
implementations (and across the summation orders of different devices)
the port's contract is int32 exactness given the same int8 operands and
fp32 outputs within ``DEFAULT_TOL``.

Every configuration runs on its backend directly, never through the
degradation chain of ``repro_torch.api.resilience``: a chain would serve a
failed fused launch from the staged datapath and compare staged with
staged.
"""
from __future__ import annotations

import torch

DEFAULT_TOL = 1e-4


def calibrated_prep(x, w, spec, algo_name: str):
    """(reference plan, cuda plan, prepared weights) with absmax activation
    scales calibrated on ``x``.  Direct and fp plans return prep=None."""
    from repro_torch.api import plan, tuning
    p_ref = plan(spec, backend="reference", algo=algo_name)
    p_cuda = plan(spec, backend="cuda", algo=algo_name)
    if p_cuda.path == "direct" or not spec.quant.enabled:
        return p_ref, p_cuda, None
    act = tuning.calibrate_act_scale(x, p_cuda.algorithm, spec.quant,
                                     spec.padding)
    return p_ref, p_cuda, p_cuda.prepare_weights(w, act_scale=act)


def _run(p, x, prep):
    """``p`` on its backend, outside the degradation chain."""
    from repro_torch.api import backends
    return backends.get_backend(p.backend).apply(p, x, prep)


def _close(got, want, rtol, atol, what):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")


def assert_conv_conformance(x, w, spec, algo_name: str = "auto", *,
                            allow_degraded: bool = False,
                            rtol: float = DEFAULT_TOL,
                            atol: float = DEFAULT_TOL) -> torch.Tensor:
    """Assert every executable configuration of (x, w, spec) agrees.

    int8 specs, dense or depthwise: staged and fused ``cuda`` outputs
    within tolerance of the reference simulation and of each other.  fp
    and direct specs: the ``cuda`` plan against the reference backend.
    Returns the reference output.
    """
    from repro_torch.api import tuning
    p_ref, p_cuda, prep = calibrated_prep(x, w, spec, algo_name)
    if not allow_degraded and p_cuda.path == "direct":
        raise AssertionError(
            f"spec unexpectedly degraded to the direct path: {spec}")
    if prep is None:
        prep = p_cuda.prepare_weights(w)
        y_ref = p_ref.apply(x, prep)
        _close(_run(p_cuda, x, prep), y_ref, rtol, atol, "cuda vs reference")
        return y_ref
    y_ref = p_ref.apply(x, prep)
    y_staged = _run(p_cuda.with_config(tuning.DEFAULT_STAGED), x, prep)
    _close(y_staged, y_ref, rtol, atol, "staged vs reference int8 simulation")
    y_fused = _run(p_cuda.with_config(tuning.DEFAULT_FUSED), x, prep)
    _close(y_fused, y_staged, rtol, atol, "fused vs staged")
    return y_ref


def assert_placed(sh, spec=None) -> torch.Tensor:
    """Every coordinate of the ``Sharded`` ``sh`` holds, on its own
    device, the block of the whole tensor that its spec gives it (so the
    replicas of a block are equal); ``spec``, where given, is the spec
    ``sh`` must have.  Returns the whole tensor on the CPU."""
    from repro_torch.distributed.sharding import block_of
    if spec is not None and tuple(sh.spec) != tuple(spec):
        raise AssertionError(f"placed by {sh.spec}, not by {spec}")
    whole = sh.gather("cpu")
    for c in sh.mesh.coords():
        b = sh.shards[c]
        if b.device != sh.mesh.device(c):
            raise AssertionError(f"the block of {c} lies on {b.device}, "
                                 f"not {sh.mesh.device(c)}")
        want = block_of(whole, sh.spec, sh.mesh, sh.block_index(c))
        if not torch.equal(b.cpu(), want):
            raise AssertionError(f"the block of {c} is not block "
                                 f"{sh.block_index(c)} of {sh}")
    return whole
