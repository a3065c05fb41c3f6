"""Thread-safe public registry of bilinear fast-convolution algorithms.

The same names as the JAX package's registry.  Entries are lazy factories (algorithm generation runs
exact ``Fraction`` arithmetic, so instances are built once and memoized
under a lock) tagged with the kernel-tap count ``taps`` they apply to —
the planner filters candidates by ``taps`` when auto-selecting.

The registry is open: downstream code (new backends, new tile sizes)
registers additional algorithms with :func:`register_algorithm` and they
immediately become visible to ``plan(..., algo="auto")`` and to
``list_algorithms()`` consumers such as the benchmarks.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.generator import (BilinearAlgorithm, generate_sfc,
                                  generate_winograd)

DIRECT = "direct"


@dataclasses.dataclass(frozen=True)
class AlgorithmEntry:
    name: str
    factory: Callable[[], BilinearAlgorithm]
    taps: int                   # kernel size R the algorithm convolves
    kind: str                   # 'sfc' | 'winograd' | ...


_LOCK = threading.RLock()
_ENTRIES: Dict[str, AlgorithmEntry] = {}
_INSTANCES: Dict[str, BilinearAlgorithm] = {}


def register_algorithm(name: str, factory: Callable[[], BilinearAlgorithm],
                       *, taps: int, kind: str,
                       overwrite: bool = False) -> None:
    with _LOCK:
        if name == DIRECT:
            raise ValueError(f"'{DIRECT}' is a reserved algorithm name")
        if name in _ENTRIES and not overwrite:
            raise ValueError(f"algorithm {name!r} already registered")
        _ENTRIES[name] = AlgorithmEntry(name, factory, taps, kind)
        _INSTANCES.pop(name, None)
    # memoized plans may have auto-selected against the old registry state
    # (no-op if the planner was never imported / is still importing —
    # e.g. this very module being imported from planner's own top level:
    # no plans can exist yet)
    planner = sys.modules.get("repro_torch.api.planner")
    invalidate = getattr(planner, "invalidate_plan_cache", None)
    if invalidate is not None:
        invalidate()


def get_algorithm(name: str) -> Optional[BilinearAlgorithm]:
    """Resolve a registered name to its (memoized) algorithm.

    ``"direct"`` resolves to ``None`` — the sentinel every execution layer
    understands as the direct-convolution path.
    """
    if name == DIRECT:
        return None
    with _LOCK:
        if name not in _ENTRIES:
            raise KeyError(
                f"unknown algorithm {name!r}; registered: "
                f"{sorted(_ENTRIES)} (+ '{DIRECT}')")
        if name not in _INSTANCES:
            _INSTANCES[name] = _ENTRIES[name].factory()
        return _INSTANCES[name]


def list_algorithms(taps: Optional[int] = None,
                    include_direct: bool = True) -> Tuple[str, ...]:
    """Registered names, optionally restricted to one kernel-tap count."""
    with _LOCK:
        names = sorted(n for n, e in _ENTRIES.items()
                       if taps is None or e.taps == taps)
    return tuple(names) + ((DIRECT,) if include_direct else ())


def entries(taps: Optional[int] = None) -> Tuple[AlgorithmEntry, ...]:
    with _LOCK:
        return tuple(e for _, e in sorted(_ENTRIES.items())
                     if taps is None or e.taps == taps)


# Paper evaluation set (§6): SFC variants + Winograd baselines for 3-tap
# 2-D convs, and the SFC-6 4-tap algorithm for the Mamba2 depthwise conv1d.
# The 2-tap SFC algorithms serve the polyphase lowering of stride-2 convs
# (a later slice of the port): the even/odd phases of an R-tap strided kernel
# have ceil(R/2) taps, so stride-2 3x3 lowers onto 2-tap sub-convs (and the
# stride-2 7x7 stem onto the 4-/3-tap algorithms above).
for _name, _factory, _taps, _kind in [
    ("sfc6_7", lambda: generate_sfc(6, 7, 3), 3, "sfc"),
    ("sfc6_6", lambda: generate_sfc(6, 6, 3), 3, "sfc"),
    ("sfc4_4", lambda: generate_sfc(4, 4, 3), 3, "sfc"),
    ("wino4", lambda: generate_winograd(4, 3), 3, "winograd"),
    ("wino2", lambda: generate_winograd(2, 3), 3, "winograd"),
    ("sfc6_6_r4", lambda: generate_sfc(6, 6, 4), 4, "sfc"),
    ("sfc4_4_r2", lambda: generate_sfc(4, 4, 2), 2, "sfc"),
    ("sfc4_5_r2", lambda: generate_sfc(4, 5, 2), 2, "sfc"),
    ("sfc6_7_r2", lambda: generate_sfc(6, 7, 2), 2, "sfc"),
]:
    register_algorithm(_name, _factory, taps=_taps, kind=_kind)
