"""Static resource checks of the ``cuda`` datapaths' launches.

The counterpart of the JAX package's ``repro.analysis.kernel_checks``,
written over the port's own launch geometries, which the wrappers compute
in Python and the kernels only check:

  * B4 ``kernels.sfc_fused.fused_geometry`` and B7 ``depthwise_geometry``
    (the fused datapath);
  * B1 ``kernels.sfc_transform.transform_geometry``, B2
    ``kernels.sfc_tdmm.tdmm_geometry``, B6 ``dw_product_geometry`` and B3
    ``kernels.sfc_inverse.InverseGeometry`` (the staged datapath; B3's
    launch is fixed in its source, the dataclass describes it).

Nothing is launched.  The findings:

  * **KC001, shared memory**: a block's dynamic shared memory exceeds the
    kernel's limit on an H100.  Replaces the JAX check of the same code,
    the per-grid-step VMEM budget of the TPU.
  * **KC002, grid and block shape**: threads per block beyond the kernel's
    limit, a grid dimension beyond CUDA's (2^31 - 1 for x, 65535 for y and
    z), or an input region wider than the staging kernels take.  Replaces
    the JAX KC002, the strip and block bounds of the TPU grid's index maps.
  * **KC003, cluster and registers**: a B4 cluster of more than
    ``MAX_CLUSTER`` blocks, a C_in split finer than the C_out block (each
    slice finishes cb / k_split channels), an epilogue that does not fit
    the shared memory it reuses, or more int32 fragments per warp than B4
    is compiled for.  Replaces the JAX KC003, the scratch accumulator's
    write races and the double buffer's DMA slots: on the card the
    cross-block reduction runs over the cluster's distributed shared
    memory, and the accumulator lives in registers.
  * **KC004, no geometry**: the config's knobs name no kernel (B4's
    ``k_block`` 32 or 64 and ``cout_block`` 8 or 16, a staged ``k_block``
    of at least 1, a tile no kernel takes), so the geometry function
    refuses them.  The JAX geometry takes any block size and has no such
    check.

:func:`check_candidates` is the autotuner's pre-flight: it filters a
``KernelConfig`` sweep down to launchable candidates.  :func:`fold_fits`
is the serving batcher's view: whether one launch of the config takes a
whole batch of images.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core import conv2d as c2d
from repro_torch.kernels import _build, sfc_fused, sfc_tdmm
from repro_torch.kernels.sfc_inverse import INVERSE_THREADS, InverseGeometry
from repro_torch.kernels.sfc_transform import (TRANSFORM_MAX_THREADS,
                                               TRANSFORM_SMEM_LIMIT_BYTES,
                                               TransformGeometry,
                                               transform_geometry)

ERROR = "ERROR"
WARNING = "WARNING"

GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65535
MAX_REGION_W = 256      # widest input region B1, B5 and B7 stage
B2_SMEM_LIMIT_BYTES = 232448
B2_MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding (the JAX package's shape)."""

    code: str          # e.g. 'KC001'
    severity: str      # ERROR | WARNING
    message: str
    where: str = ""    # the geometry or config

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.severity} {self.code}{loc}: {self.message}"


def _grid_findings(kernel, grid, where) -> List[Finding]:
    out = []
    for axis, (n, hi) in enumerate(zip(grid, (GRID_X_MAX, GRID_YZ_MAX,
                                              GRID_YZ_MAX))):
        if n > hi:
            out.append(Finding(
                "KC002", ERROR, f"{kernel}: grid dimension {axis} is {n}, "
                f"beyond CUDA's {hi}", where))
    return out


def _limit(code, kernel, what, need, limit, where) -> List[Finding]:
    if need <= limit:
        return []
    return [Finding(code, ERROR, f"{kernel}: {what} {need} exceeds the "
                    f"kernel's limit of {limit}", where)]


def check_geometry(geom) -> List[Finding]:
    """Verify one resolved launch geometry.  Empty list == launchable."""
    where = repr(geom)
    if isinstance(geom, sfc_fused.FusedGeometry):
        k = "B4"
        out = _limit("KC001", k, "shared memory (bytes)", geom.smem_bytes,
                     sfc_fused.B4_SMEM_LIMIT_BYTES, where)
        out += _limit("KC002", k, "threads per block", geom.threads, 1024,
                      where)
        out += _grid_findings(k, geom.grid, where)
        out += _limit("KC003", k, "cluster size (blocks)",
                      geom.n_share * geom.k_split, sfc_fused.MAX_CLUSTER,
                      where)
        out += _limit("KC003", k, "C_in split", geom.k_split, geom.cb, where)
        out += _limit("KC003", k, "epilogue shared memory (bytes)",
                      geom.epilogue_bytes, geom._reused_bytes, where)
        if geom.pairs not in sfc_fused.PAIRS:
            out.append(Finding(
                "KC003", ERROR, f"{k}: {geom.pairs} fragment pairs per warp; "
                f"the kernel is compiled for {sfc_fused.PAIRS}", where))
        return out
    if isinstance(geom, sfc_fused.DepthwiseGeometry):
        k = "B7"
        out = _limit("KC001", k, "shared memory (bytes)", geom.smem_bytes,
                     sfc_fused.DW_SMEM_LIMIT_BYTES, where)
        out += _limit("KC002", k, "threads per block", geom.threads,
                      sfc_fused.DW_MAX_THREADS, where)
        out += _limit("KC002", k, "input region width", geom.region_w,
                      MAX_REGION_W, where)
        return out + _grid_findings(k, geom.grid, where)
    if isinstance(geom, TransformGeometry):
        k = "B1/B5"
        out = _limit("KC001", k, "shared memory (bytes)", geom.smem_bytes,
                     TRANSFORM_SMEM_LIMIT_BYTES, where)
        out += _limit("KC002", k, "threads per block", geom.threads,
                      TRANSFORM_MAX_THREADS, where)
        out += _limit("KC002", k, "input region width", geom.region_w,
                      MAX_REGION_W, where)
        return out + _grid_findings(k, geom.grid, where)
    if isinstance(geom, sfc_tdmm.TdmmGeometry):
        k = "B2"
        out = _limit("KC001", k, "shared memory (bytes)", geom.smem_bytes,
                     B2_SMEM_LIMIT_BYTES, where)
        out += _limit("KC002", k, "threads per block", geom.threads,
                      B2_MAX_THREADS, where)
        return out + _grid_findings(k, geom.grid, where)
    if isinstance(geom, sfc_tdmm.DwProductGeometry):
        k = "B6"
        out = _limit("KC002", k, "threads per block", geom.threads,
                     sfc_tdmm.DW_MAX_THREADS, where)
        return out + _grid_findings(k, geom.grid, where)
    if isinstance(geom, InverseGeometry):
        # the bound of csrc/sfc_inverse.cu: a thread index in 31 bits
        return _limit("KC002", "B3", "threads of the launch",
                      geom.blocks * INVERSE_THREADS, GRID_X_MAX, where)
    raise TypeError(f"no check for a {type(geom).__name__}")


def geometries_for(algo, config, B: int, H: int, W: int, C: int, Cout: int,
                   *, padding: str = "SAME", depthwise: bool = False
                   ) -> list:
    """The launch geometries a ``config`` would use on this workload, as
    the wrappers resolve them; ValueError where the knobs name none."""
    if algo.t > _build.MAX_T or algo.L > _build.MAX_L \
            or algo.M > _build.MAX_M:
        raise ValueError(f"no kernel takes the tile (t={algo.t}, "
                         f"L={algo.L}, M={algo.M})")
    grid = c2d.tile_grid(H, W, algo.M, algo.R, padding)
    rows, cols = B * grid.nH, grid.nW
    T, P = rows * cols, algo.t * algo.t
    if config.datapath == "fused":
        if depthwise:
            return [sfc_fused.depthwise_geometry(algo, (rows, cols), C,
                                                 config.cout_block)]
        return [sfc_fused.fused_geometry(algo, T, C, Cout,
                                         k_block=config.k_block,
                                         cout_block=config.cout_block)]
    if config.k_block is not None and config.k_block < 1:
        raise ValueError(f"the staged k_block must be positive or None, "
                         f"got {config.k_block}")
    product = sfc_tdmm.dw_product_geometry(P, T, C) if depthwise \
        else sfc_tdmm.tdmm_geometry(P, T, C, Cout)
    inverse = InverseGeometry(algo.t, algo.M, T, C if depthwise else Cout)
    return [transform_geometry(algo, (rows, cols), C), product, inverse]


def check_config(algo, config, B: int, H: int, W: int, C: int, Cout: int,
                 *, padding: str = "SAME",
                 depthwise: bool = False) -> List[Finding]:
    """Findings for one ``KernelConfig`` candidate on one workload."""
    where = (f"{config.datapath}(k={config.k_block},co={config.cout_block})"
             f" B{B} {H}x{W} {C}->{Cout}")
    try:
        geoms = geometries_for(algo, config, B, H, W, C, Cout,
                               padding=padding, depthwise=depthwise)
    except ValueError as e:
        return [Finding("KC004", ERROR, str(e), where)]
    return [f for g in geoms for f in check_geometry(g)]


def check_spec_config(spec, algo, config, *,
                      batch: int = 1) -> Optional[List[Finding]]:
    """:func:`check_config` from a fully-hinted ``ConvSpec``.

    None when the spec lacks the shape hints a geometry needs, or is not
    a rank-2 shape.
    """
    if spec.rank != 2 or spec.spatial is None \
            or spec.in_channels is None or spec.out_channels is None:
        return None
    H, W = spec.spatial
    return check_config(algo, config, batch, H, W, spec.in_channels,
                        spec.out_channels, padding=spec.padding,
                        depthwise=spec.depthwise)


def check_candidates(spec, algo, candidates: Sequence, *, batch: int = 1):
    """Partition a candidate sweep into (launchable, rejected).

    ``rejected`` pairs each dropped config with its ERROR findings; the
    autotuner logs and skips them instead of timing a launch that would
    be refused.
    """
    ok, rejected = [], []
    for cfg in candidates:
        findings = check_spec_config(spec, algo, cfg, batch=batch)
        errors = [f for f in (findings or []) if f.severity == ERROR]
        if errors:
            rejected.append((cfg, errors))
        else:
            ok.append(cfg)
    return ok, rejected


def fold_fits(algo, config, imgs: int, H: int, W: int, C: int, Cout: int,
              *, padding: str = "SAME") -> bool:
    """Whether one launch of ``config`` takes ``imgs`` images: the serving
    batcher's view of the datapath.

    The JAX package's ``fold_fits`` asks whether ``rows_per_step`` tile
    rows fit the fused kernel's VMEM budget in one grid step.  B4 has no
    such knob: it takes every tile of the images it is given in one
    launch, its geometry (``fused_geometry`` over the images' tiles) sized
    per launch.  So the question here is whether that launch's geometry
    exists and passes KC001-KC004 (shared memory, grid and block shape,
    cluster and registers, knobs), as :func:`check_config` resolves it.
    """
    return not [f for f in check_config(algo, config, imgs, H, W, C, Cout,
                                        padding=padding)
                if f.severity == ERROR]


def tile_refuses(algo, config) -> bool:
    """Whether B4 cannot take ``config``'s knobs at ``algo``'s tile on any
    workload: the geometry is refused already at one tile, C_in = the
    stage width and C_out = the channel block, and no larger workload
    needs less shared memory (the ring, xq and scales scale with t^2, the
    stage width and the channel block, not with the shape)."""
    if config.datapath != "fused":
        return False
    kb = config.k_block or sfc_fused.K_BLOCK
    try:
        geometries_for(algo, config, 1, algo.M, algo.M, kb,
                       config.cout_block or 8, padding="VALID")
    except ValueError:
        return True
    return False


def default_candidate_report(*, bits_act: int = 8, bits_weight: int = 8
                             ) -> List[Finding]:
    """Check every ``DEFAULT_CANDIDATES`` config against a representative
    workload sweep (the kernel gate of ``python -m repro_torch.analysis``):
    four shapes, every non-Winograd 3-tap algorithm of the registry.

    A candidate whose B4 knobs the algorithm's tile cannot take at any
    workload (:func:`tile_refuses`) would be one WARNING per (algorithm,
    candidate), dropped by ``check_candidates`` before anything is timed
    or launched, as it drops every ERROR.  None is: where two weight
    stages of 16 tiles need more shared memory than an H100 block has
    (sfc6_7's t = 12 at ``k_block`` 64 or ``cout_block`` 16), B4 takes one
    stage, and then 8 tiles a block, so it takes every candidate at every
    tile, as the TPU's VMEM does.  Every other refusal, a limit that a
    shape breaks, is an ERROR."""
    from repro_torch.api import registry
    from repro_torch.api.spec import ConvSpec
    from repro_torch.api.tuning import DEFAULT_CANDIDATES
    from repro_torch.quant.fake_quant import QuantConfig
    quant = QuantConfig(enabled=True, bits_act=bits_act,
                        bits_weight=bits_weight)
    findings: List[Finding] = []
    shapes = [(1, 14, 14, 128, 128), (4, 28, 28, 64, 128),
              (1, 224, 224, 64, 64), (8, 7, 7, 512, 512)]
    for entry in registry.entries(taps=3):
        if entry.kind == "winograd":
            continue               # excluded from the int8 fast path
        algo = registry.get_algorithm(entry.name)
        for cfg in DEFAULT_CANDIDATES:
            if tile_refuses(algo, cfg):
                findings.append(Finding(
                    "KC004", WARNING,
                    f"B4 cannot take k_block={cfg.k_block}, cout_block="
                    f"{cfg.cout_block} at t={algo.t} on any workload (shared "
                    f"memory); the pre-flight drops this candidate for "
                    f"{entry.name}", f"{entry.name} | {cfg}"))
                continue
            for B, H, W, C, Cout in shapes:
                spec = ConvSpec(kernel_size=3, in_channels=C,
                                out_channels=Cout, spatial=(H, W),
                                quant=quant)
                got = check_spec_config(spec, algo, cfg, batch=B)
                for f in got or []:
                    findings.append(dataclasses.replace(
                        f, where=f"{entry.name} B{B} {H}x{W} "
                                 f"{C}->{Cout} | {f.where}"))
    return findings
