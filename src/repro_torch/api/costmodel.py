"""Calibrated analytic cost model — the planner's middle tier: predict the
winning kernel config for *unseen* specs instead of timing every
candidate.

The counterpart of the JAX package's ``repro.api.costmodel``, refitted on
the port's own launch geometries.  The BOPs model
(``repro_torch.quant.bops``) prices arithmetic only; measured timings
(``repro_torch.api.tuning``) price everything but need a sweep per spec.
This module sits between them: an analytic per-candidate latency predictor
in the roofline style, the JAX package's form,

    t_pred(candidate) = k0 + k1 * steps + k2 * roof_s
    roof_s            = max(compute_s, memory_s)

``compute_s`` (int8 tensor-core operations over the H100's int8 peak plus
f32 operations over its f32 peak) and ``memory_s`` (bytes over its HBM
rate) are summed over the launches of the candidate's datapath, read off
the geometries the wrappers launch with — ``FusedGeometry``,
``DepthwiseGeometry``, ``TransformGeometry``, ``TdmmGeometry``,
``DwProductGeometry`` and B3's ``InverseGeometry``, through their
``compute_ops()`` / ``hbm_bytes()`` accessors, resolved by
``repro_torch.analysis.kernel_checks.geometries_for``.  The model never
re-derives blocking from shapes (the JAX package's rule COST001): the
geometry is the one place launch work is counted.

``steps`` is the port's own quantity.  A TPU grid step runs in sequence;
CUDA blocks do not, so a step here is a *launch* (each pays the host's
launch and the card's ramp) plus each *wave* of the launch's blocks over
the H100's 132 SMs at the blocks an SM holds at once (each wave pays the
tail of the one before): ``steps = launches + sum(waves)``.  At batch 1
most launches are one wave, so ``steps`` counts what separates the one
fused launch from the staged trio; at large batches the waves grow with
the work.

The (k0, k1, k2) coefficients are *measured*, not assumed:
:func:`fit_coefficients` times a handful of probe specs through the same
``tuning._measure_plan`` protocol the autotuner uses (wall clock, the
card synchronised after each call: what a serving caller waits) and
least-squares fits one coefficient set per datapath (fused / staged /
direct).  Coefficients persist in a store of the port's own
(``REPRO_TORCH_COSTMODEL_CACHE``, default
``~/.cache/repro_torch/costmodel.json``) keyed on backend and the device
token the timing cache ends in (``tuning.device_token``), so a fit on the
CPU's plain versions never prices the card.

Consumers (wired in ``planner`` / ``tuning`` / ``serve.engine``):

  * ``planner.select_algorithm``: measured timings first, then this
    model, then raw BOPs;
  * ``planner.plan``: a cold spec's config is the model's best;
  * ``tuning.autotune(top_k=...)``: rank all launchable candidates here
    and measure only the top-k, recording predicted-vs-measured;
  * serve engine warm-up: model-predicted configs for buckets with no
    timing entry (``warm_sources`` ``model``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.spec import ConvSpec

_ENV_CACHE = "REPRO_TORCH_COSTMODEL_CACHE"
_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                              "repro_torch", "costmodel.json")

# H100 SXM peaks (NVIDIA data sheet, dense; ``launch.mesh`` owns them).
# They only normalise the analytic work terms into comparable "at-peak
# seconds" before the roofline max(); the fitted k2 rescales them to what
# the card (or the CPU's plain versions) does.
from repro_torch.launch.mesh import HBM_BW as PEAK_HBM_BYTES  # noqa: E402
from repro_torch.launch.mesh import PEAK_F32_OPS, PEAK_INT8_OPS  # noqa: E402,F401

# feature-vector width per datapath: (1, steps, roof_s) for the kernel
# datapaths, (1, roof_s) for direct (one library call)
N_FEATURES = {"fused": 3, "staged": 3, "direct": 2}

_LOCK = threading.RLock()
_STORE: Optional[Dict[str, Dict]] = None
_PATH_OVERRIDE: Optional[str] = None


# --------------------------------------------------------------------------
# coefficient store (same shape/locking discipline as the timing cache)
# --------------------------------------------------------------------------
def cache_path() -> str:
    return _PATH_OVERRIDE or os.environ.get(_ENV_CACHE, _DEFAULT_CACHE)


def set_cache_path(path: Optional[str]) -> None:
    """Point the coefficient store somewhere else (tests); None restores
    the env/default resolution."""
    global _PATH_OVERRIDE, _STORE
    with _LOCK:
        _PATH_OVERRIDE = path
        _STORE = None
    _invalidate_plans()


def clear() -> None:
    """Drop in-memory coefficients (the cache file is left untouched)."""
    global _STORE
    with _LOCK:
        _STORE = {}
    _invalidate_plans()


def _invalidate_plans() -> None:
    # memoized plans may embed configs/algorithms this model selected
    from repro_torch.api import planner
    planner.invalidate_plan_cache()


def _load() -> Dict[str, Dict]:
    global _STORE
    with _LOCK:
        if _STORE is None:
            try:
                with open(cache_path()) as f:
                    _STORE = json.load(f)
            except (OSError, ValueError):
                _STORE = {}
        return _STORE


_WRITE_WARNED = False


def _save() -> None:
    global _WRITE_WARNED
    with _LOCK:
        snapshot = json.loads(json.dumps(_STORE or {}))
        path = cache_path()
    try:
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snapshot, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        _WRITE_WARNED = False
    except OSError as e:
        if not _WRITE_WARNED:
            _WRITE_WARNED = True
            warnings.warn(
                f"cost-model coefficients not persisted to {path!r} ({e}); "
                f"the fit remains in-memory for this process only",
                RuntimeWarning, stacklevel=3)


def _key(backend: str, device=None) -> str:
    # the device token ends the key for the same reason as the timing
    # cache's: a fit on the CPU's plain versions must never price the card
    from repro_torch.api import tuning
    return f"{backend}|{tuning.device_token(device)}"


def coefficients(backend: str = "cuda",
                 device=None) -> Optional[Dict[str, List[float]]]:
    """Fitted per-datapath coefficient vectors, or None when unfitted."""
    entry = _load().get(_key(backend, device))
    if not entry:
        return None
    return {dp: list(map(float, entry[dp]))
            for dp in N_FEATURES if dp in entry}


def is_fitted(backend: str = "cuda", device=None) -> bool:
    return bool(coefficients(backend, device))


def set_coefficients(coefs: Dict[str, Sequence[float]],
                     backend: str = "cuda", *, device=None,
                     persist: bool = True, meta: Optional[Dict] = None
                     ) -> None:
    """Install coefficient vectors (fit output, tests, offline calib).

    ``coefs`` maps datapath -> vector sized per :data:`N_FEATURES`.
    """
    for dp, vec in coefs.items():
        if dp not in N_FEATURES:
            raise ValueError(f"unknown datapath {dp!r}")
        if len(vec) != N_FEATURES[dp]:
            raise ValueError(
                f"{dp} coefficient vector has {len(vec)} entries, "
                f"expected {N_FEATURES[dp]}")
    with _LOCK:
        store = _load()
        entry = {dp: [float(v) for v in vec] for dp, vec in coefs.items()}
        if meta:
            entry["meta"] = meta
        store[_key(backend, device)] = entry
        if persist:
            _save()
    _invalidate_plans()


# --------------------------------------------------------------------------
# analytic features
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CostFeatures:
    """Analytic work terms of one (spec, algorithm, config) candidate."""

    datapath: str          # 'fused' | 'staged' | 'direct'
    steps: int             # launches + waves of blocks (0 for direct)
    compute_s: float       # operations at the H100's peaks, seconds
    memory_s: float        # HBM traffic at the H100's rate, seconds
    hbm_bytes: int         # total traffic, bytes

    @property
    def roof_s(self) -> float:
        """Roofline: the launch cannot beat its slower resource."""
        return max(self.compute_s, self.memory_s)

    def vector(self) -> Tuple[float, ...]:
        if self.datapath == "direct":
            return (1.0, self.roof_s)
        return (1.0, float(self.steps), self.roof_s)


def _direct_features(spec: ConvSpec, batch: int) -> CostFeatures:
    """The direct path: one full-fp32 cuDNN conv (the reference backend's
    ``conv2d_direct``), priced by its multiply-adds and its operands."""
    from repro_torch.api import planner
    wl = planner._workload(spec)
    H, W = spec.spatial
    cin_w = 1 if spec.depthwise else spec.in_channels // spec.groups
    out_sp = wl.n_outputs_spatial
    ops = 2 * batch * out_sp * spec.out_channels * spec.kernel_size ** 2 \
        * wl.contraction
    hbm = batch * (H * W * spec.in_channels + out_sp * spec.out_channels) \
        * 4 + spec.kernel_size ** 2 * cin_w * spec.out_channels * 4
    return CostFeatures(
        datapath="direct", steps=0, compute_s=ops / PEAK_F32_OPS,
        memory_s=hbm / PEAK_HBM_BYTES, hbm_bytes=hbm)


def _kernel_features(datapath: str, geoms) -> CostFeatures:
    """One datapath's launches, summed: operations and bytes from each
    geometry's accessors, steps = launches + waves."""
    int8 = f32 = nbytes = waves = 0
    for g in geoms:
        ops = g.compute_ops()
        int8 += ops["int8"]
        f32 += ops["f32"]
        nbytes += g.hbm_bytes()["total"]
        waves += g.waves
    return CostFeatures(
        datapath=datapath, steps=len(geoms) + waves,
        compute_s=int8 / PEAK_INT8_OPS + f32 / PEAK_F32_OPS,
        memory_s=nbytes / PEAK_HBM_BYTES, hbm_bytes=nbytes)


def features_for(spec: ConvSpec, algo, config, *,
                 batch: int = 1) -> Optional[CostFeatures]:
    """Analytic features of one candidate, or None when the model cannot
    price it (shape hints missing, a lowered strided or grouped spec —
    priced per sub-spec by its own plans, not here — or a config no
    geometry can run)."""
    if spec.rank != 2 or spec.spatial is None \
            or spec.in_channels is None or spec.out_channels is None:
        return None
    if algo is None:
        return _direct_features(spec, batch)
    if spec.stride != 1 or (spec.groups != 1 and not spec.depthwise):
        return None
    if algo.R != spec.kernel_size:
        return None
    from repro_torch.analysis import kernel_checks
    from repro_torch.api import tuning
    config = config or tuning.DEFAULT_FUSED
    H, W = spec.spatial
    try:
        geoms = kernel_checks.geometries_for(
            algo, config, batch, H, W, spec.in_channels, spec.out_channels,
            padding=spec.padding, depthwise=spec.depthwise)
    except ValueError:
        return None
    return _kernel_features(config.datapath, geoms)


# --------------------------------------------------------------------------
# prediction / ranking
# --------------------------------------------------------------------------
def predict_time(spec: ConvSpec, algo, config, *, backend: str = "cuda",
                 device=None, batch: int = 1) -> Optional[float]:
    """Predicted wall-clock seconds, or None when unfitted/unpriceable."""
    coefs = coefficients(backend, device)
    if coefs is None:
        return None
    feats = features_for(spec, algo, config, batch=batch)
    if feats is None:
        return None
    c = coefs.get(feats.datapath)
    if c is None:
        return None
    v = feats.vector()
    return max(float(np.dot(np.asarray(c), np.asarray(v))), 0.0)


def rank_candidates(spec: ConvSpec, algo, candidates=None, *,
                    backend: str = "cuda", device=None, batch: int = 1
                    ) -> Optional[List[Tuple[object, float]]]:
    """Launchable candidates sorted by predicted time (fastest first).

    Pre-flights candidates through ``kernel_checks.check_candidates``
    exactly as the autotuner does, so the ranking never proposes a
    config the kernel would reject.  Returns None when the model is
    unfitted or any launchable candidate cannot be priced — a partial
    ranking must not hide a candidate from the measured sweep.
    """
    from repro_torch.analysis import kernel_checks
    from repro_torch.api import tuning
    if candidates is None:
        candidates = tuning.DEFAULT_CANDIDATES
    launchable, _ = kernel_checks.check_candidates(
        spec, algo, candidates, batch=batch)
    if not launchable:
        return None
    ranked = []
    for cfg in launchable:
        pred = predict_time(spec, algo, cfg, backend=backend, device=device,
                            batch=batch)
        if pred is None:
            return None
        ranked.append((cfg, pred))
    ranked.sort(key=lambda cp: cp[1])
    return ranked


def best_config(spec: ConvSpec, backend: str, algo_name: str,
                device=None):
    """Model-predicted best ``KernelConfig`` for one algorithm, or None.

    The planner's fallback when the timing cache has no entry — cold
    specs get a near-optimal config without a blocking sweep.
    """
    from repro_torch.api import registry
    algo = registry.get_algorithm(algo_name)
    if algo is None:                       # direct path carries no config
        return None
    ranked = rank_candidates(spec, algo, backend=backend, device=device)
    return ranked[0][0] if ranked else None


def select_algorithm(spec: ConvSpec, names: Sequence[str],
                     backend: str, device=None) -> Optional[str]:
    """Model-predicted fastest among ``names`` (each at its predicted
    best config), or None when any candidate cannot be priced.

    All-or-nothing on purpose — the same partial-knowledge rule as the
    planner's measured branch: a model that can price only some
    eligible candidates must not hide the others, so selection falls
    back to BOPs instead.
    """
    from repro_torch.api import registry
    best_name, best_pred = None, None
    for name in names:
        algo = registry.get_algorithm(name)
        if algo is None:
            pred = predict_time(spec, None, None, backend=backend,
                                device=device)
        else:
            ranked = rank_candidates(spec, algo, backend=backend,
                                     device=device)
            pred = ranked[0][1] if ranked else None
        if pred is None:
            return None
        if best_pred is None or pred < best_pred:
            best_name, best_pred = name, pred
    return best_name


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------
def default_probe_specs() -> List[ConvSpec]:
    """The JAX package's probe set — one memory-bound small image, one
    larger-spatial, two channel-heavy — and one wide image.

    The 112x112 probe is load-bearing: every launch of the other four is
    one wave of blocks, so each datapath's steps are constant there and
    the per-step coefficient is unidentifiable (collinear with k0); at
    112x112 B4's candidates take 1 to 3 waves."""
    from repro_torch.quant.fake_quant import QuantConfig
    q = QuantConfig(enabled=True, bits_act=8, bits_weight=8)
    return [
        ConvSpec(kernel_size=3, in_channels=32, out_channels=32,
                 spatial=(14, 14), quant=q),
        ConvSpec(kernel_size=3, in_channels=64, out_channels=128,
                 spatial=(28, 28), quant=q),
        ConvSpec(kernel_size=3, in_channels=256, out_channels=256,
                 spatial=(7, 7), quant=q),
        ConvSpec(kernel_size=3, in_channels=512, out_channels=512,
                 spatial=(7, 7), quant=q),
        ConvSpec(kernel_size=3, in_channels=64, out_channels=64,
                 spatial=(112, 112), quant=q),
    ]


def _fit_nonneg(X: np.ndarray, y: np.ndarray) -> List[float]:
    """Deterministic least squares with an active-set non-negativity
    pass: negative coefficients (unphysical — more work can't be
    faster) are zeroed most-negative-first and the rest refitted."""
    n = X.shape[1]
    active = list(range(n))
    coefs = np.zeros(n)
    while active:
        sol, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        if np.all(sol >= -1e-18):
            coefs[:] = 0.0
            coefs[active] = np.maximum(sol, 0.0)
            break
        del active[int(np.argmin(sol))]
    return [float(c) for c in coefs]


def fit_coefficients(probe_specs: Optional[Sequence[ConvSpec]] = None,
                     backend: str = "cuda", *, device="cuda", reps: int = 3,
                     persist: bool = True, log=None) -> Dict:
    """Calibrate the model from a handful of probe runs and install the
    per-datapath coefficients.

    For each probe spec: measures the direct plan plus every launchable
    ``DEFAULT_CANDIDATES`` config of the BOPs-best fast algorithm
    (through the same ``tuning._measure_plan`` protocol the autotuner
    uses) on ``device`` (the card unless the caller passes ``"cpu"``;
    raises where the card is missing), then least-squares fits (k0, k1,
    k2) per datapath.  Returns the fit report that also lands in the
    coefficient store's ``meta``.
    """
    from repro_torch.analysis import kernel_checks, ranges
    from repro_torch.api import planner, registry, tuning
    tuning.require_device(device)
    if probe_specs is None:
        probe_specs = default_probe_specs()
    samples: Dict[str, List[Tuple[Tuple[float, ...], float]]] = {
        dp: [] for dp in N_FEATURES}
    for spec in probe_specs:
        x, w = tuning._synthetic_operands(spec, device=device)
        p_direct = planner.plan(spec, backend=backend, algo="direct")
        dt = tuning._measure_plan(p_direct, x, w, reps)
        feats = features_for(spec, None, None, batch=x.shape[0])
        if feats is not None:
            samples["direct"].append((feats.vector(), dt))
        if log:
            log(f"costmodel probe {spec.spatial} ci{spec.in_channels}"
                f"co{spec.out_channels} direct: {dt*1e3:.3f}ms")
        name = planner.select_algorithm(spec)    # pure BOPs ranking
        algo = registry.get_algorithm(name)
        if algo is None:
            continue
        try:
            p0 = planner.plan(spec, backend=backend, algo=name)
        except ranges.AccumulatorOverflowError:
            continue
        if p0.path != "fast":
            continue
        launchable, _ = kernel_checks.check_candidates(
            spec, algo, tuning.DEFAULT_CANDIDATES, batch=x.shape[0])
        for cfg in launchable:
            p = p0.with_config(cfg)
            t = tuning._measure_plan(p, x, w, reps)
            feats = features_for(spec, algo, cfg, batch=x.shape[0])
            if feats is None:
                continue
            samples[cfg.datapath].append((feats.vector(), t))
            if log:
                log(f"costmodel probe {spec.spatial} {name} "
                    f"{tuning._cfg_label(cfg)}: {t*1e3:.3f}ms")
    coefs: Dict[str, List[float]] = {}
    report: Dict = {"backend": backend,
                    "device": tuning.device_token(device),
                    "samples": {dp: len(s) for dp, s in samples.items()},
                    "probe_specs": len(list(probe_specs))}
    for dp, pairs in samples.items():
        if not pairs:
            continue
        X = np.asarray([v for v, _ in pairs])
        y = np.asarray([t for _, t in pairs])
        coefs[dp] = _fit_nonneg(X, y)
        pred = X @ np.asarray(coefs[dp])
        err = np.abs(pred - y) / np.maximum(y, 1e-12)
        report.setdefault("fit_error", {})[dp] = {
            "mean_rel": float(err.mean()), "max_rel": float(err.max())}
    if not coefs:
        raise ValueError("no probe spec produced a measurable sample; "
                         "cannot fit cost-model coefficients")
    report["coefficients"] = {dp: list(v) for dp, v in coefs.items()}
    set_coefficients(coefs, backend, device=device, persist=persist,
                     meta={k: v for k, v in report.items()
                           if k != "coefficients"})
    return report
