"""Static analysis of the SFC stack: overflow certificates of the int8
datapath (``ranges``), the launch checks of the ``cuda`` kernels'
geometries (``kernel_checks``) and the architecture linter (``lint``).

All pure (no kernel launches, no RNG, no clock); ``python -m
repro_torch.analysis --check`` runs the three as one gate.

Submodules load lazily (PEP 562) so that importing light consumers
(e.g. ``repro_torch.quant.bops`` -> ``ranges``) does not pull in the
kernel package.
"""
from __future__ import annotations

import importlib
from typing import Any

_SUBMODULES = ("ranges", "kernel_checks", "lint")
_ATTR_HOME = {
    # ranges
    "AccumulatorOverflowError": "ranges",
    "Certificate": "ranges",
    "all_certificates": "ranges",
    "certificate": "ranges",
    "check_contraction": "ranges",
    "check_spec_accumulator": "ranges",
    "dequant_exact_cin": "ranges",
    "safe_cin_bound": "ranges",
    "transform_bits_1d": "ranges",
    # kernel_checks
    "Finding": "kernel_checks",
    "check_candidates": "kernel_checks",
    "check_config": "kernel_checks",
    "check_geometry": "kernel_checks",
    "default_candidate_report": "kernel_checks",
    "fold_fits": "kernel_checks",
    # lint
    "lint_source": "lint",
    "run_lint": "lint",
}

__all__ = list(_SUBMODULES) + sorted(_ATTR_HOME)


def __getattr__(name: str) -> Any:
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    home = _ATTR_HOME.get(name)
    if home is not None:
        mod = importlib.import_module(f"{__name__}.{home}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
