"""Kernel configurations of the ``cuda`` int8 datapaths, the measured
tuning tier that picks one per spec, and calibration.

The BOPs cost model ranks algorithms by arithmetic, which is blind to what
dominates deployed latency on the card (launches, memory traffic, the
geometry each kernel gets).  This module closes the loop, as the JAX
package's ``repro.api.tuning`` does:

  * :func:`autotune` times candidate :class:`KernelConfig` s (the fused or
    the staged datapath and their block sizes) for one (ConvSpec, backend)
    on the actual device, per registered algorithm (plus direct);
  * results persist in a JSON timing cache of the port's own
    (``REPRO_TORCH_TUNING_CACHE``, default
    ``~/.cache/repro_torch/tuning.json``, apart from the JAX package's)
    keyed on spec x backend x device, so one tuning run serves every later
    process;
  * ``planner.select_algorithm`` and ``plan`` consult :func:`lookup` and
    :func:`get_config` ahead of the BOPs model wherever measurements exist:
    measured wall clock overrides the analytic ranking, and the winning
    kernel config rides on the resulting plan.

The device is part of the key (:func:`device_token`: the card's name, or
``cpu``), so an entry timed on the CPU's plain versions never governs a
plan on the card.  With the calibrated cost model
(``repro_torch.api.costmodel``) fitted for the backend and device,
``autotune`` measures only the model's ``top_k`` candidates and records
the model's prediction beside each winner's time (``predicted_s``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.spec import ConvSpec

_ENV_CACHE = "REPRO_TORCH_TUNING_CACHE"
_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                              "repro_torch", "tuning.json")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One executable configuration of the ``cuda`` int8 datapath.

    ``datapath`` picks the fused kernel (B4; depthwise B7) or the staged
    trio (B1-B3; depthwise B1, B6, B3).  ``k_block``: fused, the C_in
    width of one pipeline stage of B4 (32 or 64, multiples of the mma
    depth; None = 32), whose input patches and weights B4 copies into
    shared memory ahead of use; staged, the width of one reduction stage
    (any width; None = all of C_in); depthwise convs have no reduction
    and ignore it.  ``cout_block``: B4's output channels per block (8 or
    16: one or two mma n-tiles), or None to let
    ``kernels.sfc_fused.fused_geometry`` pick it per layer together with
    the C_out blocks of a cluster that share each input transform and the
    C_in slices that split the reduction; B7's channel block (any positive
    width that fits shared memory; None lets
    ``kernels.sfc_fused.depthwise_geometry`` pick it per layer).  Every B4
    and B7 geometry gives the same bits.  The JAX package's
    ``rows_per_step``, ``double_buffer``, ``tile_block`` and ``chan_block``
    describe its TPU geometry and have no counterpart.
    """

    datapath: str = "fused"       # 'fused' | 'staged'
    k_block: Optional[int] = 32
    cout_block: Optional[int] = None

    def __post_init__(self):
        if self.datapath not in ("fused", "staged"):
            raise ValueError(f"datapath must be 'fused' or 'staged', got "
                             f"{self.datapath!r}")

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "KernelConfig":
        # unknown keys are dropped, missing ones default: cache entries
        # written before (or by a version with) other knobs stay loadable
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


DEFAULT_FUSED = KernelConfig()
DEFAULT_STAGED = KernelConfig(datapath="staged", k_block=None)

# default candidate sweep: B4 with the per-layer geometry at both stage
# widths, at each of its C_out blocks, and the staged trio (whose k_block
# changes no launch: B2 accumulates all of C_in in registers)
DEFAULT_CANDIDATES = (
    DEFAULT_FUSED,
    KernelConfig(datapath="fused", k_block=64),
    KernelConfig(datapath="fused", k_block=32, cout_block=8),
    KernelConfig(datapath="fused", k_block=32, cout_block=16),
    DEFAULT_STAGED,
)

_LOCK = threading.RLock()
_STORE: Optional[Dict[str, Dict]] = None   # cache-file image, lazily loaded
_PATH_OVERRIDE: Optional[str] = None


def cache_path() -> str:
    return _PATH_OVERRIDE or os.environ.get(_ENV_CACHE, _DEFAULT_CACHE)


def set_cache_path(path: Optional[str]) -> None:
    """Point the timing cache somewhere else; None restores the env's."""
    global _PATH_OVERRIDE, _STORE
    with _LOCK:
        _PATH_OVERRIDE = path
        _STORE = None
    _invalidate_plans()


def clear() -> None:
    """Drop in-memory measurements (the cache file is left untouched)."""
    global _STORE
    with _LOCK:
        _STORE = {}
    _invalidate_plans()


def _invalidate_plans() -> None:
    # memoized plans may have consulted stale measurements (late import:
    # the planner imports this module)
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


def _snapshot_locked() -> Dict[str, Dict]:
    """Deep copy of the store (JSON-native values); callers hold _LOCK."""
    return json.loads(json.dumps(_STORE or {}))


_WRITE_WARNED = False


def _write(path: str, snapshot: Dict[str, Dict]) -> None:
    global _WRITE_WARNED
    try:
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snapshot, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        _WRITE_WARNED = False         # a later success re-arms the warning
    except OSError as e:
        # a read-only host keeps serving measurements from memory, and
        # says so once rather than on every record
        if not _WRITE_WARNED:
            _WRITE_WARNED = True
            warnings.warn(
                f"tuning cache not persisted to {path!r} ({e}); "
                f"measurements remain in-memory for this process only",
                RuntimeWarning, stacklevel=3)


def _save() -> None:
    # write under the lock: snapshots must reach the file in mutation order
    with _LOCK:
        _write(cache_path(), _snapshot_locked())


def device_token(device=None) -> str:
    """The device part of a cache key: the card's name for a CUDA device,
    ``cpu`` for the CPU.  ``None`` is the device the ``cuda`` backend's
    plans run on here: the current card where there is one, else the
    CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device)


def spec_key(spec: ConvSpec, backend: str, device=None) -> str:
    """Stable cache key: (workload, backend, device).

    The JAX package's key ends in ``jax.default_backend()`` and its
    interpret mode; here the device token (:func:`device_token`) takes
    their place: timings of the CPU's plain versions rank other code than
    the card's kernels and must never govern a plan on the card.

    Spec fields append tokens only at their non-default values
    (``g{groups}`` for grouped, ``dw`` for 2-D depthwise), as in the JAX
    package.
    """
    q = spec.quant
    qk = (f"a{q.bits_act}w{q.bits_weight}{q.act_granularity}"
          f"-{q.weight_granularity}" if q.enabled else "fp32")
    extra = ""
    if spec.groups != 1:
        extra += f"g{spec.groups}"
    if spec.rank == 2 and spec.depthwise:
        extra += "dw"
    return (f"r{spec.rank}k{spec.kernel_size}s{spec.stride}"
            f"p{spec.padding}ci{spec.in_channels}co{spec.out_channels}"
            f"sp{spec.spatial}q{qk}{extra}|{backend}|{device_token(device)}")


def lookup(spec: ConvSpec, backend: str,
           device=None) -> Dict[str, Dict]:
    """Measured entries for (spec, backend): {algo_name: {time_s, config}}.

    Empty when nothing has been measured: the planner then falls back to
    the BOPs model.
    """
    return dict(_load().get(spec_key(spec, backend, device), {}))


def get_config(spec: ConvSpec, backend: str, algo_name: str,
               device=None) -> Optional[KernelConfig]:
    """Best measured kernel config for one algorithm, or None."""
    entry = _load().get(spec_key(spec, backend, device), {}).get(algo_name)
    if entry is None or "config" not in entry:
        return None
    return KernelConfig.from_json(entry["config"])


def record(spec: ConvSpec, backend: str, algo_name: str, time_s: float,
           config: Optional[KernelConfig] = None, *,
           predicted_s: Optional[float] = None, device=None,
           persist: bool = True) -> None:
    """Store one measurement (``autotune`` calls it; exposed for tests and
    offline calibration).  The last measurement wins: a re-tune must be
    able to correct entries that no longer reproduce.

    The load -> mutate -> persist span holds one lock acquisition, so a
    concurrent :func:`set_cache_path` or :func:`clear` lands entirely
    before or entirely after it, and concurrent records reach the file in
    mutation order.
    """
    with _LOCK:
        store = _load()               # RLock: reentrant under our span
        entry = store.setdefault(spec_key(spec, backend, device), {})
        entry[algo_name] = {"time_s": float(time_s)}
        if config is not None:
            entry[algo_name]["config"] = config.to_json()
        if predicted_s is not None:
            # cost-model self-validation: the model's prediction for the
            # measured winner beside the ground truth
            entry[algo_name]["predicted_s"] = float(predicted_s)
        if persist:
            _write(cache_path(), _snapshot_locked())
    _invalidate_plans()


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------
def _ready(out) -> None:
    """Wait for the card to finish ``out`` (a tensor, or a tuple or list of
    them); CPU tensors are ready when returned."""
    if isinstance(out, (tuple, list)):
        for o in out:
            _ready(o)
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def time_fn(fn, *args, reps: int = 3, min_total_s: float = 0.02,
            max_reps: int = 64) -> float:
    """Mean wall clock of ``fn(*args)`` in seconds, after one warm-up call.

    The JAX package's protocol: after the initial ``reps`` calls, timed
    batches double until at least ``min_total_s`` of wall clock has
    accumulated (or ``max_reps`` calls ran), since a sub-millisecond call
    timed three times is mostly timer jitter.  ``min_total_s=0`` keeps the
    fixed ``reps``.  Each call waits for the card (``torch.cuda.
    synchronize`` where the JAX version calls ``block_until_ready``), so a
    time includes the host's launches.
    """
    _ready(fn(*args))                             # build + warm up once
    total, calls, batch = 0.0, 0, max(reps, 1)
    while True:
        t0 = time.perf_counter()
        for _ in range(batch):
            _ready(fn(*args))
        total += time.perf_counter() - t0
        calls += batch
        if total >= min_total_s or calls >= max_reps:
            return total / calls
        batch = min(calls, max_reps - calls)      # double, capped


def calibrate_act_scale(x: torch.Tensor, algo, quant,
                        padding: str = "SAME") -> torch.Tensor:
    """Absmax per-frequency activation scales (t, t) from one batch.

    Single-batch stand-in for PTQ calibration; respects ``quant.bits_act``.
    """
    from repro_torch.core import conv2d as c2d
    from repro_torch.quant.fake_quant import qmax_for_bits
    tx, _ = c2d.transform_input_2d(x, algo, padding)
    return torch.amax(torch.abs(tx), dim=(0, 1, 2, 5)) \
        / qmax_for_bits(quant.bits_act) + 1e-9


def _synthetic_operands(spec: ConvSpec, seed: int = 0, device="cpu"):
    if spec.rank != 2 or spec.in_channels is None \
            or spec.out_channels is None or spec.spatial is None:
        raise ValueError(
            "autotune needs a fully-hinted rank-2 spec (in/out channels "
            f"and spatial extents): {spec}")
    rng = np.random.RandomState(seed)
    H, W = spec.spatial
    cin_w = 1 if spec.depthwise else spec.in_channels // spec.groups
    x = rng.randn(1, H, W, spec.in_channels).astype(np.float32)
    w = (rng.randn(spec.kernel_size, spec.kernel_size, cin_w,
                   spec.out_channels) * 0.1).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device))


def _prepared(p, x, w):
    """Prepared weights for timing ``p`` on ``x``: absmax calibration on
    the synthetic batch itself (the timing is scale-agnostic, only the
    datapath matters); composite plans calibrate per sub-problem."""
    if p.spec.quant.enabled and p.path == "lowered":
        return p.prepare_weights(w, act_scale=p.calibrate(x))
    if p.spec.quant.enabled and p.algorithm is not None:
        act_scale = calibrate_act_scale(x, p.algorithm, p.spec.quant,
                                        p.spec.padding)
        return p.prepare_weights(w, act_scale=act_scale)
    return p.prepare_weights(w)


def _measure_plan(p, x, w, reps: int) -> float:
    prep = _prepared(p, x, w)
    return time_fn(lambda a: p.apply(a, prep), x, reps=reps)


def _launchable(p, candidates, batch: int):
    """(launchable, rejected) for plan ``p``: the static pre-flight of
    ``analysis.kernel_checks`` over every fast (sub-)plan, so a config no
    geometry can run is never timed."""
    from repro_torch.analysis import kernel_checks
    if p.path == "lowered":
        ok, rejected = list(candidates), []
        for sub in {id(s): s for s in p.sub_plans}.values():
            ok, more = _launchable(sub, ok, batch)
            rejected += more
        return ok, rejected
    if p.path != "fast":
        return list(candidates), []
    return kernel_checks.check_candidates(p.spec, p.algorithm, candidates,
                                          batch=batch)


def _cfg_label(cfg: KernelConfig) -> str:
    return f"{cfg.datapath}(k={cfg.k_block},co={cfg.cout_block})"


def autotune(spec: ConvSpec, backend: str = "cuda", *, device=None,
             algos: Optional[Sequence[str]] = None,
             candidates: Sequence[KernelConfig] = DEFAULT_CANDIDATES,
             include_direct: bool = True, reps: int = 3,
             top_k: Optional[int] = 3, persist: bool = True,
             log=None) -> Dict[str, Dict]:
    """Measure candidate configs for ``spec`` and persist the winners.

    Times candidate (algorithm, config) pairs on synthetic operands (one
    image, from a numpy seed) on ``device`` (None: the card where there is
    one, else the CPU), records the fastest config per algorithm (plus
    the direct path) under that device's key, and returns them.  Later
    ``plan(spec, backend=...)`` calls rank by these times instead of BOPs
    and carry the winning config.  The cache file is written once at the
    end (an interrupted run persists nothing), with the direct baseline
    measured first.

    A strided or grouped spec plans a lowered composite per algorithm
    name; the composites are timed whole, under the original spec's key,
    each distinct one once.  Algorithms that the plan-time overflow
    pre-flight rejects, and configs that no launch geometry can run
    (``analysis.kernel_checks``), are never timed.

    ``top_k``: when the cost model (``repro_torch.api.costmodel``) is
    fitted for this backend and device, a native spec's launchable
    candidates are ranked by predicted time and only the top ``top_k``
    are measured; the winner's prediction is recorded beside its time
    (``predicted_s``).  With the model unfitted (or ``top_k=None``) every
    launchable candidate is measured.
    """
    from repro_torch.analysis import ranges
    from repro_torch.api import planner, registry
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    x, w = _synthetic_operands(spec, device=device)
    if algos is None:
        algos = [e.name for e in registry.entries(taps=spec.kernel_size)]
    results: Dict[str, Dict] = {}
    if include_direct:
        p = planner.plan(spec, backend=backend, algo="direct")
        dt = _measure_plan(p, x, w, reps)
        if log:
            log(f"autotune direct: {dt*1e3:.3f}ms")
        record(spec, backend, "direct", dt, device=device, persist=False)
        results["direct"] = {"time_s": dt}
    # lowered specs can collapse many algorithm names onto one composite
    # (every tap-mismatched name resolves its sub-specs with 'auto'):
    # measure each distinct composite once.  The signature is structural,
    # (sub-spec, resolved algorithm) per sub-plan, because recording a
    # measurement invalidates the plan cache, so object identities do not
    # survive from one name to the next.
    seen_composites: Dict[tuple, str] = {}
    for name in algos:
        try:
            p_name = planner.plan(spec, backend=backend, algo=name)
        except ranges.AccumulatorOverflowError as exc:
            if log:
                log(f"autotune {name}: skipped, {exc}")
            continue
        if p_name.path == "direct":        # spec degraded to direct
            continue
        if p_name.path == "lowered":
            sig = tuple((sp.spec, sp.algo_name) for sp in p_name.sub_plans)
            first = seen_composites.setdefault(sig, name)
            if first != name:
                if log:
                    log(f"autotune {name}: same lowered composite as "
                        f"{first}; skipped")
                continue
        launchable, rejected = _launchable(p_name, candidates, x.shape[0])
        if log:
            for cfg, errs in rejected:
                log(f"autotune {name} {_cfg_label(cfg)}: rejected by "
                    f"pre-flight [{errs[0].code}]")
        predictions: Dict[KernelConfig, float] = {}
        if top_k is not None and p_name.path == "fast":
            # fitted cost model: measure only the predicted top-k
            from repro_torch.api import costmodel
            ranked = costmodel.rank_candidates(
                spec, p_name.algorithm, launchable, backend=backend,
                device=device, batch=x.shape[0])
            if ranked is not None:
                predictions = dict(ranked)
                launchable = [cfg for cfg, _ in ranked[:top_k]]
                if log and len(ranked) > len(launchable):
                    log(f"autotune {name}: cost model kept top-"
                        f"{len(launchable)} of {len(ranked)} launchable "
                        f"candidates")
        best: Optional[float] = None
        best_cfg: Optional[KernelConfig] = None
        for cfg in launchable:
            p = planner.plan(spec, backend=backend,
                             algo=name).with_config(cfg)
            dt = _measure_plan(p, x, w, reps)
            if log:
                log(f"autotune {name} {_cfg_label(cfg)}: {dt*1e3:.3f}ms")
            if best is None or dt < best:
                best, best_cfg = dt, cfg
        if best is not None:
            record(spec, backend, name, best, best_cfg,
                   predicted_s=predictions.get(best_cfg), device=device,
                   persist=False)
            results[name] = {"time_s": best, "config": best_cfg.to_json()}
            if best_cfg in predictions:
                results[name]["predicted_s"] = predictions[best_cfg]
    if persist:
        _save()
    return results
