"""Architecture-invariant linter for the ``repro_torch`` source tree.

Pure-stdlib (``ast``) checks for invariants that unit tests cannot see —
they are properties of the *source layout*, not of any runtime value.
Paths are relative to the ``repro_torch`` package root:

  ``ARCH001``  ``repro_torch.api`` is the single entry point.  Importing
               ``repro_torch.kernels`` or
               ``repro_torch.distributed.conv_spmd`` anywhere else
               couples callers to kernel internals and bypasses
               planning/tuning; only the API layer, the kernel and
               distributed packages themselves, the test harness
               (``repro_torch.testing``) and this analysis package (which
               consumes kernel *metadata*, never launches) may.
  ``TIME001``  Serving code (``serve/``) must not read ``time.time()``:
               wall-clock is not monotonic, and SLO / latency accounting
               built on it breaks under NTP steps.  Use
               ``time.perf_counter`` or the injected ``time_fn``.
  ``EXC001``   No bare ``except:`` — it swallows ``KeyboardInterrupt``
               and ``SystemExit``.
  ``EXC002``   No silent broad handler: ``except Exception`` whose body
               is only ``pass``/``continue`` hides real failures (the
               degradation chain must *log* what it absorbs).
  ``REG001``   ``register_algorithm``/``register_backend`` may only be
               called from the registry seams (``api/registry.py``,
               ``api/backends.py``).  Registration elsewhere makes the
               available-algorithm set import-order dependent.
  ``COST001``  The analytic cost model (``api/costmodel.py``) may read
               launch geometry ONLY through the kernels' public geometry
               surface — the ``*_geometry`` functions and ``*Geometry``
               classes, which it reaches through
               ``analysis.kernel_checks.geometries_for`` — never through
               the resource names the geometries are built from (shared
               memory limits such as ``SMEM_PER_SM``,
               ``DW_SMEM_LIMIT_BYTES`` or ``TRANSFORM_SMEM_LIMIT_BYTES``,
               the residency helper ``resident_blocks``, the private
               ``_geometry``/``_fits`` helpers, ...): that would
               re-derive — and inevitably fork — the resource math the
               geometry already owns.

Run via ``python -m repro_torch.analysis --check`` or programmatically
through :func:`run_lint`.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Iterable, List, Sequence, Tuple, Union

from repro_torch.analysis.kernel_checks import ERROR, Finding

PACKAGE = "repro_torch"

# Path prefixes (relative to the package root) allowed to import
# kernel/distributed internals.
_ARCH_ALLOWED_PREFIXES: Tuple[str, ...] = (
    "api", "kernels", "distributed", "analysis")
_ARCH_ALLOWED_FILES: Tuple[str, ...] = ("testing.py",)
_KERNEL_MODULES: Tuple[str, ...] = (
    f"{PACKAGE}.kernels", f"{PACKAGE}.distributed.conv_spmd")

# Files allowed to *call* the registration seams.
_REG_ALLOWED: Tuple[str, ...] = ("api/registry.py", "api/backends.py")
_REG_NAMES: Tuple[str, ...] = ("register_algorithm", "register_backend")

# COST001: the cost model's only sanctioned geometry surface, and the
# kernel-internal resource names (kernels/sfc_fused.py, sfc_tdmm.py,
# sfc_transform.py, sfc_inverse.py) it must not read.
_COST_FILE = "api/costmodel.py"
_COST_ALLOWED_KERNEL_NAMES: Tuple[str, ...] = (
    "fused_geometry", "FusedGeometry",
    "depthwise_geometry", "DepthwiseGeometry",
    "transform_geometry", "TransformGeometry",
    "tdmm_geometry", "TdmmGeometry",
    "dw_product_geometry", "DwProductGeometry",
    "InverseGeometry")
_COST_BANNED_NAMES: Tuple[str, ...] = (
    "SMEM_PER_SM", "REGISTERS_PER_SM", "THREADS_PER_SM", "TDMM_REGISTERS",
    "B4_SMEM_LIMIT_BYTES", "B4_STATIC_SMEM_BYTES",
    "DW_SMEM_LIMIT_BYTES", "DW_STATIC_SMEM_BYTES",
    "TRANSFORM_SMEM_LIMIT_BYTES", "TRANSFORM_STATIC_SMEM_BYTES",
    "TRANSFORM_MAX_THREADS", "DW_MAX_THREADS", "MAX_CLUSTER",
    "resident_blocks", "_geometry", "_fused_geometry",
    "_depthwise_geometry", "_transform_geometry", "_tdmm_geometry",
    "_dw_product_geometry", "_fits", "_dw_fits")


def _package_relpath(path: pathlib.Path, root: pathlib.Path) -> str:
    """Path relative to the ``repro_torch`` package root (or the scan root
    when the tree is not a ``repro_torch`` checkout — lets tests lint tmp
    trees)."""
    rel = path.relative_to(root)
    parts = rel.parts
    if PACKAGE in parts:
        parts = parts[max(i for i, p in enumerate(parts)
                          if p == PACKAGE) + 1:]
    return "/".join(parts)


def _is_kernel_module(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in _KERNEL_MODULES)


def _arch_allowed(relpath: str) -> bool:
    return (relpath in _ARCH_ALLOWED_FILES
            or any(relpath.startswith(p + "/")
                   for p in _ARCH_ALLOWED_PREFIXES))


def _silent_body(body: Sequence[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)):
            continue                       # docstring / Ellipsis
        return False
    return True


def _call_name(func: ast.expr) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _cost_findings(node: ast.AST, where: str) -> List[Finding]:
    if isinstance(node, ast.Import):
        return [Finding(
            "COST001", ERROR,
            f"costmodel imports kernel module {alias.name!r} wholesale; "
            f"read geometry only via the *_geometry/*Geometry surface "
            f"(kernel_checks.geometries_for)", where)
            for alias in node.names if _is_kernel_module(alias.name)]
    if isinstance(node, ast.ImportFrom) and node.level == 0 \
            and _is_kernel_module(node.module or ""):
        bad = [a.name for a in node.names
               if a.name not in _COST_ALLOWED_KERNEL_NAMES]
        if bad:
            return [Finding(
                "COST001", ERROR,
                f"costmodel imports kernel-internal name(s) {bad} from "
                f"{node.module!r}; only the *_geometry functions and "
                f"*Geometry classes are the sanctioned geometry surface",
                where)]
        return []
    name = node.id if isinstance(node, ast.Name) else \
        node.attr if isinstance(node, ast.Attribute) else None
    if name in _COST_BANNED_NAMES:
        shown = name if isinstance(node, ast.Name) else f".{name}"
        return [Finding(
            "COST001", ERROR,
            f"costmodel references kernel resource helper {shown!r}; the "
            f"launch geometry (its accessors) already owns that math — do "
            f"not re-derive it", where)]
    return []


def lint_source(source: str, relpath: str) -> List[Finding]:
    """Lint one module given its package-relative path."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as exc:
        return [Finding("LNT000", ERROR, f"syntax error: {exc.msg}",
                        f"{relpath}:{exc.lineno or 0}")]
    in_serve = relpath.startswith("serve/")
    arch_ok = _arch_allowed(relpath)
    reg_ok = relpath in _REG_ALLOWED
    is_cost = relpath == _COST_FILE

    for node in ast.walk(tree):
        where = f"{relpath}:{getattr(node, 'lineno', 0)}"

        if is_cost:
            findings.extend(_cost_findings(node, where))

        if isinstance(node, ast.Import) and not arch_ok:
            for alias in node.names:
                if _is_kernel_module(alias.name):
                    findings.append(Finding(
                        "ARCH001", ERROR,
                        f"import of kernel-internal module "
                        f"{alias.name!r} outside the API/kernel layers; "
                        f"route through {PACKAGE}.api (or "
                        f"{PACKAGE}.analysis for static metadata)", where))
        elif isinstance(node, ast.ImportFrom) and not arch_ok:
            mod = node.module or ""
            if node.level == 0:
                targets = [mod] + [f"{mod}.{a.name}" if mod else a.name
                                   for a in node.names]
                if any(_is_kernel_module(t) for t in targets):
                    findings.append(Finding(
                        "ARCH001", ERROR,
                        f"import from kernel-internal module {mod!r} "
                        f"outside the API/kernel layers; route through "
                        f"{PACKAGE}.api (or {PACKAGE}.analysis for static "
                        f"metadata)", where))

        elif isinstance(node, ast.Attribute):
            if (in_serve and node.attr == "time"
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "time"):
                findings.append(Finding(
                    "TIME001", ERROR,
                    "time.time() on a serving path: wall-clock is not "
                    "monotonic; use time.perf_counter or the injected "
                    "time_fn", where))

        elif isinstance(node, ast.ExceptHandler):
            if node.type is None:
                findings.append(Finding(
                    "EXC001", ERROR,
                    "bare 'except:' swallows KeyboardInterrupt/"
                    "SystemExit; catch a concrete exception type", where))
            else:
                names = []
                for t in ([node.type] if not isinstance(node.type, ast.Tuple)
                          else node.type.elts):
                    if isinstance(t, ast.Name):
                        names.append(t.id)
                if (set(names) & {"Exception", "BaseException"}
                        and _silent_body(node.body)):
                    findings.append(Finding(
                        "EXC002", ERROR,
                        "broad 'except Exception' with a silent body "
                        "hides real failures; log or narrow it", where))

        elif isinstance(node, ast.Call) and not reg_ok:
            name = _call_name(node.func)
            if name in _REG_NAMES:
                findings.append(Finding(
                    "REG001", ERROR,
                    f"{name}() called outside the registry seams "
                    f"({', '.join(_REG_ALLOWED)}); registration "
                    f"elsewhere makes the algorithm/backend set "
                    f"import-order dependent", where))
    return findings


def iter_py_files(root: pathlib.Path) -> Iterable[pathlib.Path]:
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def run_lint(root: Union[str, pathlib.Path]) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (normally the package)."""
    root = pathlib.Path(root)
    findings: List[Finding] = []
    for path in iter_py_files(root):
        rel = _package_relpath(path, root)
        findings.extend(
            lint_source(path.read_text(encoding="utf-8"), rel))
    return findings


def source_root() -> pathlib.Path:
    """The installed ``repro_torch`` package directory (what ``--check``
    scans)."""
    import repro_torch
    return pathlib.Path(next(iter(repro_torch.__path__))).resolve()
