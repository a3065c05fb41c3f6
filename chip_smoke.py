#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SFC (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (an H100) and the CUDA
toolkit's ``nvcc``; it builds the port's kernels from ``src/repro_torch/
csrc`` at first use.  Phases, each of which raises on failure:

  1. probe: PyTorch, CUDA, the card, ``nvcc``, its name and power limit;
  2. build the kernels and report the seconds it took;
  3. each kernel against its plain PyTorch version on the card, at VGG-16
     layer shapes and at depthwise shapes of MobileNetV2, with the
     tolerance stated beside each check; the fused kernels also bit for bit
     against the staged ones (B4 against B1 -> B2 -> B3, B7 against
     B1 -> B6 -> B3) on snapped and raw inputs at a second geometry, B7 at
     batch 4, VALID and a run-time algorithm too, B3's NHWC entry
     bit for bit against its tile entry followed by ``untile``, and B1's
     (P, T, C) entry against its plain version and bit for bit against
     its tile entry, B1 and B5 also at a second geometry; then B2 and B6
     bit for bit against their plain versions at the per-layer geometry
     and at a second one, B2 at every VGG-16 layer shape and at ragged
     tiles and channels (T 1, 9, 17; K 3, 40; N 8, 24, 520), B6 at every
     depthwise layer and at C 3, 20 and 960;
  4. the direct path on the card under PyTorch's default TF32 flags (the
     run sets none): a 1x1, a 3x3 and a 3x3/2 ``"direct"`` plan against the
     same plan on CPU copies of the inputs, within 1e-4 rel L2 and 1e-4 of
     max |y|, and, as what the guard prevents, the same plans with the
     port's cuDNN guard taken out;
  5. the paths, each forward of which starts from launch counts of 0 and
     must launch its own kernels, and only those, the stated number of
     times; every layer is held against the ``reference`` backend on the
     same input:
     a. int8 VGG-16: requests through VGG-16's 13-layer conv stack at
        224x224 and its published widths, every layer through
        ``ConvSpec -> plan(backend="cuda", algo="sfc6_6") -> calibrate ->
        prepare_weights -> apply``, on the fused and the staged datapath;
     b. fp VGG-16: the same stack with ``quant=FP32`` (B5 -> f32 product
        -> B3), one request of batch 1 and one of batch 4, and the batch-1
        request once more with the caller's TF32 turned on for cuBLAS;
     c. depthwise: the 13 stride-1 depthwise 3x3 convs of MobileNetV2
        (width 1.0, 224x224) and the repo's ``dw3x3`` workload, each a
        request of batch 1 and of batch 4, on the int8 fused, int8 staged
        and fp paths; fused and staged must be bit-identical;
  6. per kernel, the times over the layers of one batch-1 request: the
     kernel, its plain version, one PyTorch library call where one
     computes the same function, and the least time the card could take
     (B1 and B3 as the paths call them: B1's (P, T, C) entry, B3's NHWC
     entry on the product's output); also B3's tile entry and the copies
     the NHWC entry replaced, B1, B3 and B5 over the depthwise layers, the
     card's time for a launch of nothing, and one batch-1 fp and staged
     VGG-16 forward under ``torch.profiler`` (the card's kernels by name,
     and its busy share), where the profiler traces the card.

``--sweep-b4``, ``--sweep-b7``, ``--sweep-b1`` and ``--sweep-b2`` time
B4's, B7's, B1's and B5's, and B2's and B6's geometries per layer instead
(each held bit for bit to the default) and write
``chiprun_out/b4_sweep.json``, ``b7_sweep.json``, ``b1_sweep.json`` and
``b2_sweep.json``.

The run keeps PyTorch's default TF32 flags: the port guards its own
float32 library calls (``repro_torch.core.precision``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  A longer report goes to
``build/chip_smoke_report.json``.  Weights and images are random, from
numpy seeds.
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# VGG-16 conv layers (HxW, C_in, C_out) at 224x224: stages (2,2,3,3,3),
# widths (64,128,256,512,512), as benchmarks/table3_throughput.py lists them
VGG_STAGES = (2, 2, 3, 3, 3)
VGG_WIDTHS = (64, 128, 256, 512, 512)
IMAGE = 224
REQUEST_BATCHES = (1, 1, 1, 4)
FP_REQUEST_BATCHES = (1, 4)
ALGO = "sfc6_6"
# the 13 stride-1 depthwise 3x3 convs of MobileNetV2 at width 1.0 and
# 224x224 (Sandler et al. 2018, arXiv:1801.04381, Table 2), named by
# bottleneck block and repeat, as (name, H = W, C); its four stride-2
# depthwise convs need the lowering pass (ROADMAP A6).  Then the repo's
# own depthwise workload, dw3x3 of benchmarks/table3_throughput.py.
DW_LAYERS = (("mbv2_b1.1", 112, 32), ("mbv2_b2.2", 56, 144),
             ("mbv2_b3.2", 28, 192), ("mbv2_b3.3", 28, 192),
             ("mbv2_b4.2", 14, 384), ("mbv2_b4.3", 14, 384),
             ("mbv2_b4.4", 14, 384), ("mbv2_b5.1", 14, 384),
             ("mbv2_b5.2", 14, 576), ("mbv2_b5.3", 14, 576),
             ("mbv2_b6.2", 7, 960), ("mbv2_b6.3", 7, 960),
             ("mbv2_b7.1", 7, 960), ("dw3x3", 28, 256))
DW_BATCHES = (1, 4)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM, int8 tensor cores, and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
TIMED_RUNS = 25
SPIN_CYCLES = 20_000_000        # ~10 ms at the H100's clock; doubled on need
SERVE_REPEATS = 5
# (algo, H = W, C_in, C_out, batch): VGG-16 shapes, sfc6_7, sfc4_4, a
# ragged sfc6_6 case whose channel counts are no multiple of any block,
# the deepest layer at batch 4 (36 tiles, three groups of 16), and B4's
# other weight loaders: C_out 20 (no multiple of 8: weights copied by
# bytes, scales 16 bytes a copy) and C_out 13 (no multiple of 4: scales by
# single loads), the latter with wino4, whose (t, L, M) B4 takes at run
# time
KERNEL_CHECKS = (("sfc6_6", 224, 3, 64, 1), ("sfc6_6", 56, 256, 256, 1),
                 ("sfc6_6", 14, 512, 512, 1), ("sfc6_7", 56, 256, 256, 1),
                 ("sfc4_4", 28, 64, 128, 1), ("sfc6_6", 13, 40, 24, 1),
                 ("sfc6_6", 14, 512, 512, 4), ("sfc6_6", 13, 40, 20, 1),
                 ("wino4", 13, 40, 13, 1))
# B4 at a geometry other than the per-layer default: 8 output channels
# per block, four of them sharing each transform, C_in split in two; bit
# for bit the same
B4_ALT = {"cout_block": 8, "n_share": 4, "k_split": 2}
# B7 and B6 checks, (algo, H = W, C, batch, padding): MobileNetV2 shapes
# at batch 1 and 4, sfc6_7, VALID padding, C 40 (no multiple of 16: B7
# loads by plain loads, not TMA), and wino4, whose (t, L, M) B7 takes at
# run time; B7 is held bit for bit to the staged B1 -> B6 -> B3 at the
# per-layer geometry, at B7_ALT (16 channels, runs of 4 tiles, some idle
# at a row's end, 3 threads a tile and channel) and at 24 channels a
# block (plain loads), on snapped and on raw inputs
DW_CHECKS = (("sfc6_6", 112, 32, 1, "SAME"), ("sfc6_6", 56, 144, 4, "SAME"),
             ("sfc6_7", 7, 960, 1, "SAME"), ("sfc6_6", 14, 384, 4, "VALID"),
             ("sfc4_4", 13, 40, 2, "VALID"), ("wino4", 13, 48, 1, "SAME"))
B7_ALT = {"cout_block": 16, "tiles": 4, "splits": 3}
# B1 and B5 at a geometry other than the per-layer default: 18 channels a
# block (no multiple of 4: plain loads, not TMA, and a channel tail), runs
# of 3 tiles (some idle at a row's end), 3 threads a (tile, channel) (rows
# unevenly shared); bit for bit the same
B1_ALT = {"channel_block": 18, "tiles": 3, "splits": 3}
# B2's checks beyond VGG-16's layers, (T, K, N) at P = 100: one, 9 and 17
# tiles, K 3 and 40 (X by bytes), N 8, 24 and 520 (W by bytes, Y by
# floats); each at the per-layer geometry and at b2_alt's
B2_CHECKS = tuple((T, K, N) for T in (1, 9, 17)
                  for K, N in ((3, 8), (40, 24), (64, 520)))
# the direct path's checks under PyTorch's default TF32 flags: (label, x
# shape, w shape, stride, algo) of three "direct" plans: a 1x1 conv, a 3x3
# conv planned direct, and a 3x3/2 conv planned direct
DIRECT_CHECKS = (("1x1 56x56 256->128", (1, 56, 56, 256), (1, 1, 256, 128),
                  1, "auto"),
                 ("3x3 28x28 256->256 direct", (1, 28, 28, 256),
                  (3, 3, 256, 256), 1, "direct"),
                 ("3x3/2 56x56 128->256 direct", (1, 56, 56, 128),
                  (3, 3, 128, 256), 2, "direct"))
# B6's checks beyond the depthwise layers: C 3 and 20 (channels one at a
# time, a partial group) and 960, at 9 tiles; each at the per-layer
# geometry and at B6_ALT (3 groups, 5 lanes, runs of 2)
B6_CHECKS = (3, 20, 960)
B6_ALT = {"groups": 3, "lanes": 5, "run": 2}
REPLACES = {
    "sfc_transform_quantize": ("src/repro_torch/csrc/sfc_transform.cu",
                               "src/repro/kernels/sfc_transform.py:36"),
    "tdmm_int8": ("src/repro_torch/csrc/sfc_tdmm.cu",
                  "src/repro/kernels/sfc_tdmm.py:41"),
    "sfc_inverse": ("src/repro_torch/csrc/sfc_inverse.cu",
                    "src/repro/kernels/sfc_inverse.py:20"),
    "sfc_fused_conv2d": ("src/repro_torch/csrc/sfc_fused.cu",
                         "src/repro/kernels/sfc_fused.py:490"),
    "sfc_transform": ("src/repro_torch/csrc/sfc_transform.cu",
                      "src/repro/kernels/sfc_transform.py:26"),
    "tdmm_int8_depthwise": ("src/repro_torch/csrc/sfc_tdmm_dw.cu",
                            "src/repro/kernels/sfc_tdmm.py:71"),
    "sfc_fused_conv2d_depthwise": ("src/repro_torch/csrc/sfc_fused_dw.cu",
                                   "src/repro/kernels/sfc_fused.py:600"),
}


def only(times=1, **counts):
    """Launches of one forward: the named kernels, each other kernel 0."""
    return {k: counts.get(k, 0) * times for k in REPLACES}


N_VGG = sum(VGG_STAGES)
# what one forward of each path launches
EXPECTED = {
    "vgg_fused": only(sfc_fused_conv2d=N_VGG),
    "vgg_staged": only(sfc_transform_quantize=N_VGG, tdmm_int8=N_VGG,
                       sfc_inverse=N_VGG),
    "vgg_fp": only(sfc_transform=N_VGG, sfc_inverse=N_VGG),
    "dw_fused": only(sfc_fused_conv2d_depthwise=1),
    "dw_staged": only(sfc_transform_quantize=1, tdmm_int8_depthwise=1,
                      sfc_inverse=1),
    "dw_fp": only(sfc_transform=1, sfc_inverse=1),
}
# per layer on the same input: (rel L2, max |diff| / max |ref|) bounds
BOUNDS = {"int8": (1e-4, 1e-2), "fp": (1e-4, 1e-4)}


def vgg_layers():
    """(name, H, C_in, C_out) of VGG-16's 13 convs, and the stage ends."""
    layers, ends, cin, hw = [], [], 3, IMAGE
    for si, (n, width) in enumerate(zip(VGG_STAGES, VGG_WIDTHS)):
        for ci in range(n):
            layers.append((f"s{si}c{ci}", hw, cin, width))
            cin = width
        ends.append(len(layers) - 1)
        hw //= 2
    return layers, set(ends)


def log(*args):
    print(*args, flush=True)


def tf32_flags() -> dict:
    """cuBLAS's and cuDNN's float32 settings, by the API this PyTorch has."""
    import torch
    matmul = torch.backends.cuda.matmul
    conv = getattr(torch.backends.cudnn, "conv", None)
    if hasattr(matmul, "fp32_precision") and hasattr(conv, "fp32_precision"):
        return {"cuda.matmul.fp32_precision": matmul.fp32_precision,
                "cudnn.conv.fp32_precision": conv.fp32_precision}
    return {"cuda.matmul.allow_tf32": matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def b2_alt(g) -> dict:
    """B2's knobs for a geometry other than ``g`` in row tile, column tile
    (where the shape has a kernel for another), stages and row tiles a
    block (where the layer has more than one)."""
    knobs = {"block_m": 32 if g.bm != 32 else 64,
             "stages": 3 if g.stages != 3 else 2,
             "tiles": 2 if g.tiles != 2 else 1}
    if g.vec_a and g.vec_b:
        knobs["block_n"] = 64 if g.bn == 128 else 128
    return knobs


def int8_operands(rng, dev, x_shape, w_shape):
    """Random int8 X and W of these shapes, positive scales sx (P,) and sw
    (P, the last of w_shape)."""
    import torch
    P, n = x_shape[0], w_shape[-1]
    return (torch.tensor(rng.randint(-127, 128, x_shape), dtype=torch.int8,
                         device=dev),
            torch.tensor(rng.randint(-127, 128, w_shape), dtype=torch.int8,
                         device=dev),
            torch.tensor(rng.uniform(0.01, 0.1, P), dtype=torch.float32,
                         device=dev),
            torch.tensor(rng.uniform(1e-4, 1e-3, (P, n)), dtype=torch.float32,
                         device=dev))


def sweep_b2(dev, timed, smi) -> None:
    """B2's card time per VGG-16 layer and B6's per depthwise layer of
    ``DW_LAYERS``, at batch 1 and 4, over a set of geometries (``python3
    chip_smoke.py --sweep-b2``: ``tdmm_geometry``'s ``block_m``,
    ``block_n``, ``block_k``, ``stages`` and ``tiles``;
    ``dw_product_geometry``'s
    ``groups``, ``lanes`` and ``run``), each output held bit for bit to the
    per-layer default's; the rows go to ``chiprun_out/b2_sweep.json`` and
    the log."""
    import torch

    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import sfc_tdmm

    algo = registry.get_algorithm(ALGO)
    P = algo.t ** 2
    layers, _ = vgg_layers()
    gemm_variants = [dict(block_m=bm, block_n=bn, block_k=bk, stages=st,
                          tiles=tc)
                     for bm in (16, 32, 64, 128) for bn in (64, 128)
                     for bk in (32, 64) for st, tc in (
                         (2, 1), (4, 1), (6, 1), (2, 4), (4, 4), (6, 4),
                         (4, 2), (4, 8))]
    dw_variants = [dict(groups=gx, lanes=ty, run=r)
                   for gx in (1, 2, 4, 8, 16, 32)
                   for ty in (2, 4, 8, 16, 32, 64)
                   for r in (1, 2, 4) if 32 <= gx * ty <= 512]
    rows_out, seen = [], set()

    def sweep(row, fn, variants, geometry):
        base = fn()
        row["default_ms"] = timed(fn)
        row["variants"] = []
        for v in variants:
            if geometry(v) is None:
                continue
            try:
                y = fn(**v)
            except (ValueError, RuntimeError) as e:
                row["variants"].append({**v, "refused": str(e)[:80]})
                continue
            if not torch.equal(y, base):
                raise AssertionError(f"{row['kernel']} at {v} differs from "
                                     f"the default geometry: {row}")
            row["variants"].append({**v, **geometry(v),
                                    "ms": timed(lambda: fn(**v))})
        best = min((r for r in row["variants"] if "ms" in r),
                   key=lambda r: r["ms"])
        log(f"sweep: {row['kernel']} batch {row['batch']} {row['layer']}: "
            f"default {row['default']} {row['default_ms']:.4f} ms; best "
            f"{json.dumps(best)}")
        rows_out.append(row)

    for batch in (1, 4):
        for lname, hw, cin, cout in layers:
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            T = batch * grid.nH * grid.nW
            if (T, cin, cout) in seen:
                continue
            seen.add((T, cin, cout))
            X, W, sx, sw = int8_operands(np.random.RandomState(hw + cin),
                                         dev, (P, T, cin), (P, cin, cout))
            d = sfc_tdmm.tdmm_geometry(P, T, cin, cout)

            def gemm_geometry(v, T=T, cin=cin, cout=cout):
                try:
                    g = sfc_tdmm.tdmm_geometry(P, T, cin, cout, **v)
                except ValueError:
                    return None
                if g.tiles != v["tiles"]:   # cut to the layer's row tiles
                    return None
                return {"blocks": g.blocks, "smem": g.smem_bytes,
                        "resident": g.resident}

            sweep({"kernel": "tdmm_int8", "batch": batch,
                   "layer": f"{hw}x{hw}x{cin}->{cout}", "T": T,
                   "default": [d.bm, d.bn, d.bk, d.stages, d.tiles],
                   "default_blocks": d.blocks},
                  lambda **k: sfc_tdmm.tdmm_int8(X, W, sx, sw, **k),
                  gemm_variants, gemm_geometry)
        for lname, hw, c in DW_LAYERS:
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            T = batch * grid.nH * grid.nW
            if (T, c) in seen:
                continue
            seen.add((T, c))
            X, W, sx, sw = int8_operands(np.random.RandomState(hw + c),
                                         dev, (P, T, c), (P, c))
            d = sfc_tdmm.dw_product_geometry(P, T, c)

            def dw_geometry(v, T=T, c=c):
                try:
                    g = sfc_tdmm.dw_product_geometry(P, T, c, **v)
                except ValueError:
                    return None
                return {"blocks": g.blocks, "threads": g.threads}

            sweep({"kernel": "tdmm_int8_depthwise", "batch": batch,
                   "layer": f"{lname} {hw}x{hw}x{c}", "T": T,
                   "default": [d.groups, d.lanes, d.run],
                   "default_blocks": d.blocks},
                  lambda **k: sfc_tdmm.tdmm_int8_depthwise(X, W, sx, sw,
                                                           **k),
                  dw_variants, dw_geometry)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b2_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def sweep_b4(dev, timed, smi) -> None:
    """B4's card time per VGG-16 layer at batch 1 and 4 over a set of
    geometries (``python3 chip_smoke.py --sweep-b4``), each output held
    bit for bit to the per-layer default's; the rows go to
    ``chiprun_out/b4_sweep.json`` and the log."""
    import torch

    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import sfc_fused

    algo = registry.get_algorithm(ALGO)
    t, P = algo.t, algo.t ** 2
    layers, _ = vgg_layers()
    variants = [dict(cout_block=cb, n_share=ns, k_split=ks)
                for cb in (8, 16) for ns in (2, 4, 8, 16)
                for ks in (1, 2, 4, 8) if ns * ks <= 16]
    variants += [dict(k_block=64)]
    rows_out = []
    seen = set()
    for batch in (1, 4):
        for lname, hw, cin, cout in layers:
            if (batch, hw, cin, cout) in seen:
                continue
            seen.add((batch, hw, cin, cout))
            rng = np.random.RandomState(hw + cin)
            x = torch.tensor(rng.randn(batch, hw, hw, cin),
                             dtype=torch.float32, device=dev)
            wq = torch.tensor(rng.randint(-127, 128, (P, cin, cout)),
                              dtype=torch.int8, device=dev)
            act = torch.full((t, t), 0.05, device=dev)
            ws = torch.full((t, t, cout), 1e-3, device=dev)
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            T = batch * grid.nH * grid.nW
            args = (x, wq, act, ws, algo)
            base = sfc_fused.sfc_fused_conv2d(*args)
            dflt = sfc_fused.fused_geometry(algo, T, cin, cout)
            row = {"batch": batch, "hw": hw, "cin": cin, "cout": cout,
                   "default": [dflt.cb, dflt.n_share, dflt.k_split,
                               dflt.kb],
                   "default_ms": timed(lambda: sfc_fused.sfc_fused_conv2d(
                       *args)), "variants": []}
            for v in variants:
                knobs = {k: v.get(k, d) for k, d in (
                    ("k_block", sfc_fused.K_BLOCK), ("cout_block", None),
                    ("n_share", None), ("k_split", None))}
                try:
                    g = sfc_fused.fused_geometry(algo, T, cin, cout,
                                                 **knobs)
                    y = sfc_fused.sfc_fused_conv2d(*args, **knobs)
                except (ValueError, RuntimeError) as e:
                    row["variants"].append({**v, "refused": str(e)[:80]})
                    continue
                if not torch.equal(y, base):
                    raise AssertionError(f"B4 at {v} differs from the "
                                         f"default geometry: {row}")
                row["variants"].append({
                    **v, "cb": g.cb, "n_share": g.n_share,
                    "k_split": g.k_split, "blocks": g.blocks,
                    "smem": g.smem_bytes, "ms": timed(lambda: sfc_fused.sfc_fused_conv2d(
                        *args, **knobs))})
            ok = [r for r in row["variants"] if "ms" in r]
            best = min(ok, key=lambda r: r["ms"])
            log(f"sweep: batch {batch} {hw}x{hw}x{cin}->{cout}: default "
                f"{row['default']} {row['default_ms']:.4f} ms; best "
                f"{json.dumps(best)}")
            rows_out.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b4_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def sweep_b7(dev, timed, smi) -> None:
    """B7's card time per depthwise layer of ``DW_LAYERS`` at batch 1 and
    4 over a set of geometries (``python3 chip_smoke.py --sweep-b7``:
    ``depthwise_geometry``'s ``cout_block``, ``tiles`` and ``splits``),
    each output held bit for bit to the per-layer default's; the rows go
    to ``chiprun_out/b7_sweep.json`` and the log."""
    import torch

    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import sfc_fused

    algo = registry.get_algorithm(ALGO)
    t, P = algo.t, algo.t ** 2
    variants = [dict(cout_block=cb, tiles=tc, splits=s)
                for cb in (16, 32, 64) for tc in (1, 2, 4)
                for s in sfc_fused.DW_SPLITS]
    rows_out, seen = [], set()
    for batch in (1, 4):
        for lname, hw, c in DW_LAYERS:
            if (batch, hw, c) in seen:
                continue
            seen.add((batch, hw, c))
            rng = np.random.RandomState(hw + c)
            x = torch.tensor(rng.randn(batch, hw, hw, c), dtype=torch.float32,
                             device=dev)
            wq = torch.tensor(rng.randint(-127, 128, (P, 1, c)),
                              dtype=torch.int8, device=dev)
            act = torch.full((t, t), 0.05, device=dev)
            ws = torch.full((t, t, c), 1e-3, device=dev)
            args = (x, wq, act, ws, algo)
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            tiles = (batch * grid.nH, grid.nW)
            base = sfc_fused.sfc_fused_conv2d_depthwise(*args)
            dflt = sfc_fused.depthwise_geometry(algo, tiles, c)
            row = {"batch": batch, "layer": lname, "hw": hw, "c": c,
                   "default": [dflt.cb, dflt.tiles, dflt.splits],
                   "default_blocks": dflt.blocks,
                   "default_ms": timed(lambda: sfc_fused.
                                       sfc_fused_conv2d_depthwise(*args)),
                   "variants": []}
            for v in variants:
                try:
                    g = sfc_fused.depthwise_geometry(algo, tiles, c, **v)
                    y = sfc_fused.sfc_fused_conv2d_depthwise(*args, **v)
                except (ValueError, RuntimeError) as e:
                    row["variants"].append({**v, "refused": str(e)[:80]})
                    continue
                if not torch.equal(y, base):
                    raise AssertionError(f"B7 at {v} differs from the "
                                         f"default geometry: {row}")
                row["variants"].append({
                    **v, "blocks": g.blocks, "threads": g.threads,
                    "smem": g.smem_bytes,
                    "ms": timed(lambda: sfc_fused.sfc_fused_conv2d_depthwise(
                        *args, **v))})
            best = min((r for r in row["variants"] if "ms" in r),
                       key=lambda r: r["ms"])
            log(f"sweep: batch {batch} {lname} {hw}x{hw}x{c}: default "
                f"{row['default']} {row['default_ms']:.4f} ms; best "
                f"{json.dumps(best)}")
            rows_out.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b7_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def sweep_b1(dev, timed, smi) -> None:
    """B1's (its (P, T, C) entry, as the staged paths call it) and B5's card
    time per VGG-16 and depthwise layer shape at batch 1 and 4 over a set
    of geometries (``python3 chip_smoke.py --sweep-b1``:
    ``transform_geometry``'s ``channel_block``, ``tiles`` and ``splits``),
    each output held bit for bit to the per-layer default's; the rows go
    to ``chiprun_out/b1_sweep.json`` and the log."""
    import torch

    from repro_torch import kernels
    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels.sfc_transform import transform_geometry

    algo = registry.get_algorithm(ALGO)
    t, M = algo.t, algo.M
    bt = c2d.transform_matrices(algo, torch.float32, dev)[0]
    act = torch.full((t, t), 0.05, device=dev)
    vgg, _ = vgg_layers()
    shapes = [(f"vgg {hw}x{hw}x{cin}", hw, cin) for _, hw, cin, _ in vgg]
    shapes += [(name, hw, c) for name, hw, c in DW_LAYERS]
    rows_out, seen = [], set()
    for batch in (1, 4):
        for lname, hw, c in shapes:
            if (batch, hw, c) in seen:
                continue
            seen.add((batch, hw, c))
            x = torch.tensor(np.random.RandomState(hw + c).randn(
                batch, hw, hw, c), dtype=torch.float32, device=dev)
            grid = c2d.tile_grid(hw, hw, M, algo.R, "SAME")
            tiles = (batch * grid.nH, grid.nW)
            cbs = (c,) if c < 16 else (16, 32, 64)
            variants = [dict(channel_block=cb, tiles=tc, splits=sp)
                        for cb in cbs for tc in (1, 2, 4, 8)
                        for sp in (t, -(-t // 2), -(-t // 3), -(-t // 5))]
            dflt = transform_geometry(algo, tiles, c)
            for kname, fn in (
                    ("sfc_transform_quantize", lambda **k: kernels.
                     sfc_transform_quantize_pt(x, bt, act, M, **k)),
                    ("sfc_transform", lambda **k: kernels.sfc_transform(
                        x, bt, M, **k))):
                base = fn()
                row = {"kernel": kname, "batch": batch, "layer": lname,
                       "hw": hw, "c": c,
                       "default": [dflt.cb, dflt.tiles, dflt.splits],
                       "default_blocks": dflt.blocks,
                       "default_ms": timed(fn), "variants": []}
                for v in variants:
                    try:
                        g = transform_geometry(algo, tiles, c, **v)
                        y = fn(**v)
                    except (ValueError, RuntimeError) as e:
                        row["variants"].append({**v,
                                                "refused": str(e)[:80]})
                        continue
                    if not torch.equal(y, base):
                        raise AssertionError(f"{kname} at {v} differs from "
                                             f"the default geometry: {row}")
                    row["variants"].append({
                        **v, "blocks": g.blocks, "threads": g.threads,
                        "smem": g.smem_bytes,
                        "ms": timed(lambda: fn(**v))})
                best = min((r for r in row["variants"] if "ms" in r),
                           key=lambda r: r["ms"])
                log(f"sweep: {kname} batch {batch} {lname} {hw}x{hw}x{c}: "
                    f"default {row['default']} {row['default_ms']:.4f} ms; "
                    f"best {json.dumps(best)}")
                rows_out.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b1_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.api import ConvSpec, plan, tuning
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import _build, ops, ref, sfc_fused, sfc_tdmm
    from repro_torch.quant import FP32, INT8_FREQ
    from repro_torch.testing import DEFAULT_TOL

    dev = torch.device("cuda", 0)
    report = {"phases": {}}

    # ---- 1. probe -------------------------------------------------------
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    log(f"probe: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} capability {cap} count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; {name} has "
                           f"capability {cap}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log("probe: nvcc", nvcc[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"probe: PyTorch's default TF32 flags, none set by this run: "
        f"{tf32_flags()}")
    report["device"] = {"name": name, "nvidia_smi": smi,
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds or 0.0:.1f} s, cached "
        f"{_build.build_seconds is None})")

    def timed(fn, runs=TIMED_RUNS):
        """Median device milliseconds of one ``fn`` call, over ``runs``.

        The calls are queued behind a spin kernel that keeps the card busy
        until the host has enqueued them all, so the CUDA events between
        consecutive calls measure the card's time and not the host's
        launch overhead (which would otherwise show as idle gaps).  The
        spin doubles until it outlasts the host's enqueueing (at most
        eight times, else the log says so).
        """
        fn()
        torch.cuda.synchronize()
        for doubling in range(8):
            cycles = SPIN_CYCLES << doubling
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(runs + 2)]
            ev[0].record()
            torch.cuda._sleep(cycles)
            ev[1].record()
            t0 = time.perf_counter()
            for e in ev[2:]:
                fn()
                e.record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            times = [ev[i].elapsed_time(ev[i + 1])
                     for i in range(1, runs + 1)]
            if enqueue_ms < ev[0].elapsed_time(ev[1]):
                return statistics.median(times)
        log(f"timing: the host outran every spin; {enqueue_ms:.1f} ms to "
            f"enqueue, times include host gaps")
        return statistics.median(times)

    if "--sweep-b4" in sys.argv[1:]:
        sweep_b4(dev, timed, smi)
        return
    if "--sweep-b7" in sys.argv[1:]:
        sweep_b7(dev, timed, smi)
        return
    if "--sweep-b1" in sys.argv[1:]:
        sweep_b1(dev, timed, smi)
        return
    if "--sweep-b2" in sys.argv[1:]:
        sweep_b2(dev, timed, smi)
        return

    def snapped(rng, shape):
        return torch.tensor(np.round(rng.randn(*shape) * 16) / 16,
                            dtype=torch.float32, device=dev)

    def he_normal(rng, cin, cout):
        w = rng.randn(3, 3, cin, cout) * math.sqrt(2.0 / (9 * cin))
        return torch.tensor(w, dtype=torch.float32, device=dev)

    def prepared(x, w, algo_name, config=None, depthwise=False):
        make = ConvSpec.for_conv2d_depthwise if depthwise \
            else ConvSpec.for_conv2d
        spec = make(x.shape, w.shape, quant=INT8_FREQ)
        p = plan(spec, backend="cuda", algo=algo_name)
        if config is not None:
            p = p.with_config(config)
        act = tuning.calibrate_act_scale(x, p.algorithm, INT8_FREQ)
        return p, p.prepare_weights(w, act_scale=act)

    def prepared_fp(x, w, algo_name, depthwise=False):
        make = ConvSpec.for_conv2d_depthwise if depthwise \
            else ConvSpec.for_conv2d
        p = plan(make(x.shape, w.shape, quant=FP32), backend="cuda",
                 algo=algo_name)
        return p, p.prepare_weights(w)

    def scaled_err(got, want):
        return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
                ).item()

    def geometry_of(x, prep, algo):
        """B4's geometry for this input and these weights."""
        B, H, W, cin = x.shape
        grid = c2d.tile_grid(H, W, algo.M, algo.R, "SAME")
        g = sfc_fused.fused_geometry(algo, B * grid.nH * grid.nW, cin,
                                     prep.wq.shape[2])
        return {"cb": g.cb, "n_share": g.n_share, "k_split": g.k_split,
                "kb": g.kb, "stages": g.stages, "pairs": g.pairs,
                "blocks": g.blocks, "smem": g.smem_bytes}

    def held(what, y, y_ref, kind):
        """rel L2 and scaled max error of y against y_ref, within BOUNDS."""
        rel_l2 = ((y - y_ref).norm() / y_ref.norm().clamp_min(1e-30)).item()
        scaled = scaled_err(y, y_ref)
        max_rel, max_scaled = BOUNDS[kind]
        if not (rel_l2 <= max_rel and scaled <= max_scaled
                and torch.isfinite(y).all()):
            raise AssertionError(
                f"{what}: rel L2 {rel_l2}, max |diff| / max |ref| {scaled} "
                f"against the reference (bounds {max_rel}, {max_scaled})")
        return rel_l2, scaled

    def xq_flips(x, p, prep):
        """int8 values where B1 and its plain version differ on x."""
        bt = c2d.transform_matrices(p.algorithm, torch.float32, dev)[0]
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale,
                                            p.algorithm.M)
        xq_ref = ref.sfc_transform_quantize_nhwc_ref(x, bt, prep.act_scale,
                                                     p.algorithm.M)
        return int((xq != xq_ref).sum()), xq.numel()

    # ---- 3. each kernel against its plain version ------------------------
    max_err = {k: 0.0 for k in REPLACES}

    def check_b5(case, x, xr, xq_raw, bt, scale, M, padding="SAME"):
        """B5 against its plain version: exact on snapped inputs x, within
        1e-6 of the output's scale on raw inputs xr; on xr exactly the
        value B1 quantized into xq_raw (one device function, one order);
        and at B1_ALT bit for bit the per-layer geometry's."""
        tx = kernels.sfc_transform(x, bt, M, padding=padding)
        tx_ref = ref.sfc_transform_nhwc_ref(x, bt, M, padding)
        case["b5_mismatch_snapped"] = int((tx != tx_ref).sum())
        txr = kernels.sfc_transform(xr, bt, M, padding=padding)
        txr_ref = ref.sfc_transform_nhwc_ref(xr, bt, M, padding)
        err = (txr - txr_ref).abs().max().item()
        case["b5_scaled_err_raw"] = err / txr_ref.abs().max().item()
        q = torch.clamp(torch.round(txr / scale[None, :, :, None]), -127,
                        127).to(torch.int8)
        case["b5_b1_grid_mismatch"] = int((q != xq_raw).sum())
        case["b5_alt_geometry_equal"] = bool(torch.equal(
            kernels.sfc_transform(xr, bt, M, padding=padding, **B1_ALT),
            txr))
        if case["b5_mismatch_snapped"] or case["b5_scaled_err_raw"] > 1e-6 \
                or case["b5_b1_grid_mismatch"] \
                or not case["b5_alt_geometry_equal"]:
            raise AssertionError(f"B5 differs from its plain version, from "
                                 f"what B1 quantizes or across geometries: "
                                 f"{case}")
        max_err["sfc_transform"] = max(max_err["sfc_transform"], err)

    def check_b1_pt(case, x, xr, xq, xq_raw, bt, scale, M, padding="SAME"):
        """B1's (P, T, C) entry, which the staged paths call: exact against
        its plain version on snapped inputs x, and bit for bit the tile
        entry's values xq (on x) and xq_raw (on raw inputs xr) written
        position-major; both entries at B1_ALT bit for bit the per-layer
        geometry's."""
        T, t, _, C = xq.shape

        def pt(q):
            return q.reshape(T, t * t, C).transpose(0, 1)
        xp = kernels.sfc_transform_quantize_pt(x, bt, scale, M,
                                               padding=padding)
        case["b1_pt_mismatch_snapped"] = int((
            xp != ref.sfc_transform_quantize_pt_ref(x, bt, scale, M,
                                                    padding)).sum())
        case["b1_pt_equals_tiles"] = bool(
            torch.equal(xp, pt(xq)) and torch.equal(
                kernels.sfc_transform_quantize_pt(xr, bt, scale, M,
                                                  padding=padding),
                pt(xq_raw)))
        case["b1_alt_geometry_equal"] = all(
            torch.equal(kernels.sfc_transform_quantize(
                xx, bt, scale, M, padding=padding, **B1_ALT), q)
            and torch.equal(kernels.sfc_transform_quantize_pt(
                xx, bt, scale, M, padding=padding, **B1_ALT), pt(q))
            for xx, q in ((x, xq), (xr, xq_raw)))
        if case["b1_pt_mismatch_snapped"] or not case["b1_pt_equals_tiles"] \
                or not case["b1_alt_geometry_equal"]:
            raise AssertionError(f"B1's (P, T, C) entry differs from its "
                                 f"plain version or from the tile entry, or "
                                 f"B1 differs across geometries: {case}")
    checks = []
    rng = np.random.RandomState(11)
    for algo_name, hw, cin, cout, batch in KERNEL_CHECKS:
        x = snapped(rng, (batch, hw, hw, cin))
        w = he_normal(rng, cin, cout)
        p, prep = prepared(x, w, algo_name)
        algo = p.algorithm
        t, P = algo.t, algo.t ** 2
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        case = {"algo": algo_name, "hw": hw, "cin": cin, "cout": cout,
                "batch": batch}
        # B1 on snapped inputs: B^T X B is exact in f32 in any order
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale, algo.M)
        xq_ref = ref.sfc_transform_quantize_nhwc_ref(x, bt, prep.act_scale,
                                                     algo.M)
        case["b1_mismatch_snapped"] = int((xq != xq_ref).sum())
        if case["b1_mismatch_snapped"]:
            raise AssertionError(f"B1 differs from its plain version on "
                                 f"snapped inputs: {case}")
        # B1 on raw inputs: summation order may flip a .5 tie by one LSB
        xr = torch.tensor(rng.randn(batch, hw, hw, cin), dtype=torch.float32,
                          device=dev)
        xq_raw = kernels.sfc_transform_quantize(xr, bt, prep.act_scale,
                                                algo.M)
        d = (xq_raw.int() - ref.sfc_transform_quantize_nhwc_ref(
            xr, bt, prep.act_scale, algo.M).int()).abs()
        flips, worst = int((d != 0).sum()), int(d.max())
        case["b1_flips_raw"], case["b1_values"] = flips, d.numel()
        if worst > 1 or flips * 10000 > d.numel():
            raise AssertionError(f"B1 flips beyond 1 in 1e4 or by more than "
                                 f"one step: {case}, worst {worst}")
        max_err["sfc_transform_quantize"] = max(
            max_err["sfc_transform_quantize"], float(worst))
        # B5 on snapped inputs: exact; on raw inputs: max |diff| <= 1e-6 of
        # the output's scale, and exactly the value B1 quantizes (one
        # device function, one summation order)
        check_b5(case, x, xr, xq_raw, bt, prep.act_scale, algo.M)
        check_b1_pt(case, x, xr, xq, xq_raw, bt, prep.act_scale, algo.M)
        # B2 on the same int8 operands: bit for bit its plain version (int32
        # exact, one dequant), with k_block None and 64 and at b2_alt
        X = xq.reshape(-1, P, cin).transpose(0, 1).contiguous()
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, -1).contiguous()
        Y_ref = ref.tdmm_int8_ref(X, prep.wq, sx, sw)
        alt = b2_alt(sfc_tdmm.tdmm_geometry(P, X.shape[1], cin, cout))
        for what, knobs in (("kblock_None", {}),
                            ("kblock_64", {"k_block": 64}), ("alt", alt)):
            Y = kernels.tdmm_int8(X, prep.wq, sx, sw, **knobs)
            case[f"b2_bit_equal_{what}"] = bool(torch.equal(Y, Y_ref))
            max_err["tdmm_int8"] = max(max_err["tdmm_int8"],
                                       (Y - Y_ref).abs().max().item())
        Y = kernels.tdmm_int8(X, prep.wq, sx, sw)
        if not all(v for k, v in case.items() if k.startswith("b2_bit")):
            raise AssertionError(f"B2 differs from its plain version: {case}")
        # B3: rtol 1e-5, atol 1e-5 of the output's scale
        ty = Y.transpose(0, 1).reshape(-1, t, t, cout).contiguous()
        yt, yt_ref = kernels.sfc_inverse(ty, at), ref.sfc_inverse_ref(ty, at)
        torch.testing.assert_close(yt, yt_ref, rtol=1e-5,
                                   atol=1e-5 * yt_ref.abs().max().item())
        max_err["sfc_inverse"] = max(max_err["sfc_inverse"],
                                     (yt - yt_ref).abs().max().item())
        # B3's NHWC entry: bit for bit sfc_inverse + untile, from B2's
        # (P, T, C_out) output in place and from the tile layout
        grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
        untiled = kernels.untile(yt, algo, (batch, grid.out_h, grid.out_w,
                                            grid.nH, grid.nW))
        case["b3_nhwc_equal"] = all(
            torch.equal(kernels.sfc_inverse_nhwc(yy, at, grid), untiled)
            for yy in (Y, ty))
        if not case["b3_nhwc_equal"]:
            raise AssertionError(f"B3's NHWC entry is not bit-identical to "
                                 f"sfc_inverse + untile: {case}")
        # B4 against its plain version within DEFAULT_TOL of the output's
        # scale on snapped inputs, and bit-identical to the staged CUDA path
        # (B1 -> B2 -> B3) on snapped and on raw inputs, at the per-layer
        # geometry and at B4_ALT
        args = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        yf = kernels.sfc_fused_conv2d(*args)
        ys = kernels.quantized_fastconv2d(*args)
        y_ref = ref.sfc_fused_conv2d_ref(*args)
        scale = y_ref.abs().max().item()
        torch.testing.assert_close(yf, y_ref, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL * scale)
        torch.testing.assert_close(yf, ys, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL * scale)
        case["b4_scaled_err"] = scaled_err(yf, y_ref)
        case["b4_fused_equals_staged"] = bool(torch.equal(yf, ys))
        rargs = (xr,) + args[1:]
        case["b4_fused_equals_staged_raw"] = bool(torch.equal(
            kernels.sfc_fused_conv2d(*rargs),
            kernels.quantized_fastconv2d(*rargs)))
        case["b4_alt_geometry_equal"] = bool(torch.equal(
            kernels.sfc_fused_conv2d(*args, **B4_ALT), yf))
        case["b4_geometry"] = geometry_of(x, prep, algo)
        if not (case["b4_fused_equals_staged"]
                and case["b4_fused_equals_staged_raw"]
                and case["b4_alt_geometry_equal"]):
            raise AssertionError(f"B4 is not bit-identical to the staged "
                                 f"path or across geometries: {case}")
        max_err["sfc_fused_conv2d"] = max(max_err["sfc_fused_conv2d"],
                                          (yf - y_ref).abs().max().item())
        torch.cuda.synchronize()
        log("kernels:", json.dumps(case))
        checks.append(case)

    for algo_name, hw, c, batch, padding in DW_CHECKS:
        x = snapped(rng, (batch, hw, hw, c))
        w = he_normal(rng, 1, c)
        p, prep = prepared(x, w, algo_name, depthwise=True)
        algo = p.algorithm
        t, P = algo.t, algo.t ** 2
        bt = c2d.transform_matrices(algo, torch.float32, dev)[0]
        case = {"algo": algo_name, "hw": hw, "depthwise_c": c,
                "batch": batch, "padding": padding}
        xr = torch.tensor(rng.randn(batch, hw, hw, c), dtype=torch.float32,
                          device=dev)
        xq_raw = kernels.sfc_transform_quantize(xr, bt, prep.act_scale,
                                                algo.M, padding=padding)
        check_b5(case, x, xr, xq_raw, bt, prep.act_scale, algo.M, padding)
        # B1 on snapped inputs: exact; its (P, T, C) entry
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale, algo.M,
                                            padding=padding)
        case["b1_mismatch_snapped"] = int((
            xq != ref.sfc_transform_quantize_nhwc_ref(
                x, bt, prep.act_scale, algo.M, padding)).sum())
        if case["b1_mismatch_snapped"]:
            raise AssertionError(f"B1 differs from its plain version on "
                                 f"snapped inputs: {case}")
        check_b1_pt(case, x, xr, xq, xq_raw, bt, prep.act_scale, algo.M,
                    padding)
        # B6 on the same int8 operands: exact (int32 products, one dequant),
        # at the per-layer geometry and at B6_ALT
        X = xq.reshape(-1, P, c).transpose(0, 1).contiguous()
        wq2 = prep.wq.reshape(P, c)
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, c).contiguous()
        Y = kernels.tdmm_int8_depthwise(X, wq2, sx, sw)
        Y_ref = ref.tdmm_int8_depthwise_ref(X, wq2, sx, sw)
        case["b6_bit_equal"] = bool(torch.equal(Y, Y_ref)) and bool(
            torch.equal(kernels.tdmm_int8_depthwise(X, wq2, sx, sw, **B6_ALT),
                        Y_ref))
        if not case["b6_bit_equal"]:
            raise AssertionError(f"B6 differs from its plain version: {case}")
        max_err["tdmm_int8_depthwise"] = max(
            max_err["tdmm_int8_depthwise"], (Y - Y_ref).abs().max().item())
        # B7 against its plain version within DEFAULT_TOL of the output's
        # scale on snapped inputs, and bit-identical to the staged CUDA
        # depthwise path (B1 -> B6 -> B3) on snapped and raw inputs, at the
        # per-layer geometry, at B7_ALT and at 24 channels a block
        args = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        yf = kernels.sfc_fused_conv2d(*args, depthwise=True, padding=padding)
        y_ref = ref.sfc_fused_conv2d_ref(*args, padding=padding,
                                         depthwise=True)
        scale = y_ref.abs().max().item()
        torch.testing.assert_close(yf, y_ref, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL * scale)
        case["b7_scaled_err"] = scaled_err(yf, y_ref)
        grid = c2d.tile_grid(hw, hw, algo.M, algo.R, padding)
        g = sfc_fused.depthwise_geometry(algo, (batch * grid.nH, grid.nW), c)
        case["b7_geometry"] = [g.cb, g.tiles, g.splits, g.blocks]
        for inputs, xx in (("snapped", x), ("raw", xr)):
            xargs = (xx,) + args[1:]
            ys = kernels.quantized_fastconv2d_depthwise(*xargs,
                                                        padding=padding)
            case[f"b7_fused_equals_staged_{inputs}"] = all(
                torch.equal(kernels.sfc_fused_conv2d_depthwise(
                    *xargs, padding=padding, **knobs), ys)
                for knobs in ({}, B7_ALT, {"cout_block": 24}))
        if not (case["b7_fused_equals_staged_snapped"]
                and case["b7_fused_equals_staged_raw"]):
            raise AssertionError(f"B7 is not bit-identical to the staged "
                                 f"depthwise path at every geometry: {case}")
        max_err["sfc_fused_conv2d_depthwise"] = max(
            max_err["sfc_fused_conv2d_depthwise"],
            (yf - y_ref).abs().max().item())
        torch.cuda.synchronize()
        log("kernels:", json.dumps(case))
        checks.append(case)
    report["phases"]["kernel_checks"] = checks

    # B2 bit for bit at every VGG-16 layer shape and at B2_CHECKS, B6 at
    # every depthwise layer and at B6_CHECKS, each at the per-layer
    # geometry and at a second one, on random int8 operands
    prng = np.random.RandomState(12)
    vgg, _ = vgg_layers()
    b2_shapes = [(math.ceil(hw / 6) ** 2, cin, cout)
                 for _, hw, cin, cout in vgg]
    b2_rows = []
    for T, K, N in b2_shapes + list(B2_CHECKS):
        X, W, sx, sw = int8_operands(prng, dev, (100, T, K), (100, K, N))
        Y_ref = ref.tdmm_int8_ref(X, W, sx, sw)
        g = sfc_tdmm.tdmm_geometry(100, T, K, N)
        alt = b2_alt(g)
        ga = sfc_tdmm.tdmm_geometry(100, T, K, N, **alt)
        row = {"T": T, "K": K, "N": N,
               "geometry": [g.bm, g.bn, g.bk, g.stages, g.tiles],
               "alt": [ga.bm, ga.bn, ga.bk, ga.stages, ga.tiles],
               "equal": bool(torch.equal(kernels.tdmm_int8(X, W, sx, sw),
                                         Y_ref)),
               "alt_equal": bool(torch.equal(
                   kernels.tdmm_int8(X, W, sx, sw, **alt), Y_ref))}
        b2_rows.append(row)
        if not (row["equal"] and row["alt_equal"]):
            raise AssertionError(f"B2 differs from its plain version: {row}")
    b6_shapes = [(math.ceil(hw / 6) ** 2, c) for _, hw, c in DW_LAYERS]
    b6_rows = []
    for T, C in b6_shapes + [(9, c) for c in B6_CHECKS]:
        X, W, sx, sw = int8_operands(prng, dev, (100, T, C), (100, C))
        Y_ref = ref.tdmm_int8_depthwise_ref(X, W, sx, sw)
        g = sfc_tdmm.dw_product_geometry(100, T, C)
        row = {"T": T, "C": C, "geometry": [g.groups, g.lanes, g.run],
               "equal": bool(torch.equal(
                   kernels.tdmm_int8_depthwise(X, W, sx, sw), Y_ref)),
               "alt_equal": bool(torch.equal(
                   kernels.tdmm_int8_depthwise(X, W, sx, sw, **B6_ALT),
                   Y_ref))}
        b6_rows.append(row)
        if not (row["equal"] and row["alt_equal"]):
            raise AssertionError(f"B6 differs from its plain version: {row}")
    torch.cuda.synchronize()
    log(f"kernels: B2 bit-identical to its plain version at {len(b2_rows)} "
        f"shapes, each at two geometries: "
        + json.dumps([[r["T"], r["K"], r["N"], r["geometry"], r["alt"]]
                      for r in b2_rows]))
    log(f"kernels: B6 bit-identical to its plain version at {len(b6_rows)} "
        f"shapes, each at two geometries: "
        + json.dumps([[r["T"], r["C"], r["geometry"]] for r in b6_rows]))
    report["phases"]["b2_b6_checks"] = {"b2": b2_rows, "b6": b6_rows}

    # ---- 4. the direct path under PyTorch's default TF32 flags -----------
    # the same "direct" plan on the card and on CPU copies of its inputs
    # (the CPU has no TF32); and with the port's cuDNN guard taken out,
    # what the default flags would give
    from repro_torch.core import conv2d as core_c2d
    direct_rows = []
    for label, shape, w_shape, stride, algo_name in DIRECT_CHECKS:
        drng = np.random.RandomState(shape[1] + w_shape[-1])
        x = torch.tensor(drng.randn(*shape), dtype=torch.float32, device=dev)
        w = torch.tensor(drng.randn(*w_shape) / math.sqrt(
            w_shape[0] * w_shape[1] * w_shape[2]), dtype=torch.float32,
            device=dev)
        p = plan(ConvSpec.for_conv2d(x.shape, w.shape, stride=stride,
                                     quant=FP32), backend="cuda",
                 algo=algo_name)
        if p.path != "direct":
            raise AssertionError(f"direct check {label}: the plan took the "
                                 f"{p.path} path")
        y_cpu = p.apply(x.cpu(), w.cpu())
        y = p.apply(x, w).cpu()
        guard = core_c2d.full_fp32_conv
        try:
            core_c2d.full_fp32_conv = contextlib.nullcontext
            y_unguarded = p.apply(x, w).cpu()
        finally:
            core_c2d.full_fp32_conv = guard
        row = {"plan": label, "flags": tf32_flags()}
        for what, yy in (("", y), ("unguarded_", y_unguarded)):
            row[f"{what}rel_l2"] = ((yy - y_cpu).norm()
                                    / y_cpu.norm().clamp_min(1e-30)).item()
            row[f"{what}scaled_max"] = scaled_err(yy, y_cpu)
        direct_rows.append(row)
        log("direct:", json.dumps(row))
        if not (row["rel_l2"] <= 1e-4 and row["scaled_max"] <= 1e-4
                and torch.isfinite(y).all()):
            raise AssertionError(f"direct plan {label} on the card misses "
                                 f"1e-4 against the CPU: {row}")
    report["phases"]["direct_default_flags"] = direct_rows

    # ---- 5. the paths ----------------------------------------------------
    launches = {k: 0 for k in REPLACES}   # summed over the paths' forwards
    path_launches = {path: {k: 0 for k in REPLACES} for path in EXPECTED}
    n_forwards = {path: 0 for path in EXPECTED}

    def counted(path, what, fn, times=1):
        """Run one forward of ``path`` (``times`` layers of a depthwise
        stack) with every launch count set to 0 just before it, and check
        just after it what it launched."""
        want = {k: n * times for k, n in EXPECTED[path].items()}
        kernels.reset_launch_counts()
        out = fn()
        got = kernels.launch_counts()
        if got != want:
            raise AssertionError(f"{what}: the {path} forward launched "
                                 f"{got}, not {want}")
        for k in launches:
            launches[k] += got[k]
            path_launches[path][k] += got[k]
        n_forwards[path] += 1
        return out

    def walls(path, what, fn, times=1):
        """Wall ms of SERVE_REPEATS counted forwards, and their median."""
        runs = []
        for _ in range(SERVE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counted(path, what, fn, times)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs, statistics.median(runs)

    # -- 5a/5b. VGG-16, int8 (fused, staged) and fp ------------------------
    layers, stage_ends = vgg_layers()
    wrng = np.random.RandomState(0)
    weights = {n: he_normal(wrng, cin, cout) for n, _, cin, cout in layers}
    biases = {n: torch.zeros(cout, device=dev) for n, _, _, cout in layers}
    requests = [torch.tensor(np.random.RandomState(100 + i).randn(
        b, IMAGE, IMAGE, 3), dtype=torch.float32, device=dev)
        for i, b in enumerate(REQUEST_BATCHES)]
    fp_requests = [torch.tensor(np.random.RandomState(200 + i).randn(
        b, IMAGE, IMAGE, 3), dtype=torch.float32, device=dev)
        for i, b in enumerate(FP_REQUEST_BATCHES)]
    datapaths = {"fused": tuning.DEFAULT_FUSED,
                 "staged": tuning.DEFAULT_STAGED}
    saved = []                    # (request, datapath, layer, x, plan, prep)
    fused_out = {}                # (request, layer) -> the fused output
    vgg_equal = []                # (request, layer) where fused == staged
    per_layer, stacks, served = [], [], {}

    def forward(images, state):
        """The served forward: 13 convs with prepared weights."""
        h = images
        for li, (p, prep, bias) in enumerate(state):
            h = torch.relu(p.apply(h, prep, bias=bias))
            if li in stage_ends:
                h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(
                    0, 2, 3, 1).contiguous()
        return h

    def check_pass(ri, images, dp):
        """One forward of a request, every layer checked on its way."""
        h, state = images, []
        kind = "fp" if dp == "fp" else "int8"
        for li, (lname, hw, cin, cout) in enumerate(layers):
            if dp == "fp":
                p, prep = prepared_fp(h, weights[lname], ALGO)
            else:
                p, prep = prepared(h, weights[lname], ALGO, datapaths[dp])
            y = p.apply(h, prep, bias=biases[lname])
            y_ref = plan(p.spec, backend="reference", algo=ALGO).apply(
                h, prep, bias=biases[lname])
            rel_l2, scaled = held(f"request {ri} {dp} {lname}", y, y_ref,
                                  kind)
            per_layer.append({"request": ri, "batch": h.shape[0],
                              "datapath": dp, "layer": lname, "hw": hw,
                              "cin": cin, "cout": cout, "rel_l2": rel_l2,
                              "scaled_max": scaled})
            saved.append((ri, dp, lname, h, p, prep))
            # the fused and the staged datapath of one request: bit-identical
            # at every layer (so every layer's input and calibration agree)
            if dp == "fused":
                fused_out[(ri, lname)] = y
            elif dp == "staged":
                if not torch.equal(fused_out.pop((ri, lname)), y):
                    raise AssertionError(f"request {ri} {lname}: the fused "
                                         f"and the staged outputs differ")
                vgg_equal.append((ri, lname))
            state.append((p, prep, biases[lname]))
            h = torch.relu(y)
            if li in stage_ends:
                h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(
                    0, 2, 3, 1).contiguous()
        return h, state

    vgg_runs = [(ri, images, dp) for ri, images in enumerate(requests)
                for dp in datapaths]
    vgg_runs += [(ri, images, "fp") for ri, images in enumerate(fp_requests)]
    for ri, images, dp in vgg_runs:
        path = f"vgg_{dp}"
        # the checking pass: calibrate, prepare and apply every layer, each
        # held against the reference backend on the same input
        h, state = counted(path, f"request {ri} checked",
                           lambda: check_pass(ri, images, dp))
        want = (images.shape[0], IMAGE // 32, IMAGE // 32, VGG_WIDTHS[-1])
        if h.shape != want or not torch.isfinite(h).all():
            raise AssertionError(f"request {ri} {dp}: stack output "
                                 f"{tuple(h.shape)} is not a finite {want}")
        # the served forward with these prepared weights, wall clock (host
        # and card); the card's own time is taken after the paths ran
        if not torch.equal(counted(path, f"request {ri} served",
                                   lambda: forward(images, state)), h):
            raise AssertionError(f"request {ri} {dp}: the served forward "
                                 f"differs from the checked one")
        runs, wall = walls(path, f"request {ri} timed",
                           lambda: forward(images, state))
        stacks.append({"request": ri, "batch": images.shape[0],
                       "datapath": dp, "wall_ms_runs": runs,
                       "wall_ms": wall})
        served[(ri, dp)] = (images, state)
    torch.cuda.synchronize()
    if len(vgg_equal) != N_VGG * len(REQUEST_BATCHES):
        raise AssertionError(f"fused and staged were compared on "
                             f"{len(vgg_equal)} layer requests, not "
                             f"{N_VGG * len(REQUEST_BATCHES)}")

    # -- 5b, TF32 on. The fp path's product runs in full float32 whatever
    # the caller allowed: one more forward of the batch-1 fp request with
    # the caller's TF32 on for cuBLAS, every layer held to the fp bounds
    # against the reference (TF32 off) and to bit equality with the same
    # forward under TF32 off; the caller's setting must be intact after it.
    # The same forward with the guard taken out shows what TF32 would give.
    matmul = torch.backends.cuda.matmul
    tf32_name, tf32_on = (("fp32_precision", "tf32")
                          if hasattr(matmul, "fp32_precision")
                          else ("allow_tf32", True))
    fp_saved = [(lname, x, p, prep) for ri, dp, lname, x, p, prep in saved
                if ri == 0 and dp == "fp"]

    def fp_layers():
        return [p.apply(x, prep, bias=biases[lname])
                for lname, x, p, prep in fp_saved]

    fp_refs = [plan(p.spec, backend="reference", algo=ALGO).apply(
        x, prep, bias=biases[lname]) for lname, x, p, prep in fp_saved]
    fp_off = fp_layers()
    caller = getattr(matmul, tf32_name)
    guard = ops.full_fp32_matmul
    try:
        setattr(matmul, tf32_name, tf32_on)
        fp_on = counted("vgg_fp", "request 0 with TF32 on", fp_layers)
        kept = getattr(matmul, tf32_name) == tf32_on
        ops.full_fp32_matmul = contextlib.nullcontext
        fp_unguarded = fp_layers()
    finally:
        ops.full_fp32_matmul = guard
        setattr(matmul, tf32_name, caller)
    if not kept:
        raise AssertionError("the fp path did not restore the caller's TF32 "
                             "setting")
    tf32_rows = []
    for (lname, *_), y, y_off, y_tf32, y_ref in zip(
            fp_saved, fp_on, fp_off, fp_unguarded, fp_refs):
        rel_l2, scaled = held(f"request 0 fp {lname} with TF32 on", y, y_ref,
                              "fp")
        if not torch.equal(y, y_off):
            raise AssertionError(f"request 0 fp {lname}: the output with the "
                                 f"caller's TF32 on differs from the one "
                                 f"with TF32 off")
        tf32_rows.append({
            "layer": lname, "rel_l2": rel_l2, "scaled_max": scaled,
            "unguarded_rel_l2": ((y_tf32 - y_ref).norm()
                                 / y_ref.norm().clamp_min(1e-30)).item(),
            "unguarded_scaled_max": scaled_err(y_tf32, y_ref)})
    log(f"vgg: fp request 0 with the caller's TF32 on ({tf32_name}="
        f"{tf32_on!r}): all {len(fp_saved)} layers bit-identical to TF32 "
        f"off, worst rel L2 {max(r['rel_l2'] for r in tf32_rows):.3e}, "
        f"setting restored; "
        f"without the guard, TF32 gives worst rel L2 "
        f"{max(r['unguarded_rel_l2'] for r in tf32_rows):.3e}, max |diff| / "
        f"max |ref| {max(r['unguarded_scaled_max'] for r in tf32_rows):.3e} "
        f"(bounds {BOUNDS['fp'][0]}, {BOUNDS['fp'][1]})")

    # -- 5c. depthwise: MobileNetV2's stride-1 depthwise convs and dw3x3 ---
    dw_weights = [he_normal(np.random.RandomState(300 + li), 1, c)
                  for li, (_, _, c) in enumerate(DW_LAYERS)]
    dw_rows, dw_stacks, dw_states = [], [], {}

    def dw_stack(state):
        """The served depthwise forward: every layer on its own input."""
        return [p.apply(x, prep) for _, p, prep, x in state]

    for bi, batch in enumerate(DW_BATCHES):
        states = {"fused": [], "staged": [], "fp": []}
        outputs = {"fused": [], "staged": [], "fp": []}
        for li, (lname, hw, c) in enumerate(DW_LAYERS):
            x = torch.tensor(np.random.RandomState(400 + 100 * bi + li).randn(
                batch, hw, hw, c), dtype=torch.float32, device=dev)
            w = dw_weights[li]
            p8, prep8 = prepared(x, w, ALGO, depthwise=True)
            pfp, prepfp = prepared_fp(x, w, ALGO, depthwise=True)
            plans = {"fused": (p8.with_config(tuning.DEFAULT_FUSED), prep8),
                     "staged": (p8.with_config(tuning.DEFAULT_STAGED), prep8),
                     "fp": (pfp, prepfp)}
            row = {"batch": batch, "layer": lname, "hw": hw, "c": c}
            for mode, (p, prep) in plans.items():
                y = counted(f"dw_{mode}", f"batch {batch} {lname} checked",
                            lambda: p.apply(x, prep))
                y_ref = plan(p.spec, backend="reference", algo=ALGO).apply(
                    x, prep)
                if y.shape != x.shape:
                    raise AssertionError(f"{lname} {mode}: output "
                                         f"{tuple(y.shape)}, not "
                                         f"{tuple(x.shape)}")
                row[f"{mode}_rel_l2"], row[f"{mode}_scaled_max"] = held(
                    f"depthwise batch {batch} {lname} {mode}", y, y_ref,
                    "fp" if mode == "fp" else "int8")
                states[mode].append((lname, p, prep, x))
                outputs[mode].append(y)
            row["fused_equals_staged"] = bool(torch.equal(
                outputs["fused"][-1], outputs["staged"][-1]))
            if not row["fused_equals_staged"]:
                raise AssertionError(f"depthwise batch {batch} {lname}: the "
                                     f"fused and the staged outputs differ")
            row["xq_flips"], row["xq_values"] = xq_flips(x, p8, prep8)
            dw_rows.append(row)
        for mode, state in states.items():
            got = counted(f"dw_{mode}", f"batch {batch} stack served",
                          lambda: dw_stack(state), times=len(DW_LAYERS))
            if not all(torch.equal(a, b) for a, b in zip(got, outputs[mode])):
                raise AssertionError(f"depthwise batch {batch} {mode}: the "
                                     f"served outputs differ from the "
                                     f"checked ones")
            runs, wall = walls(f"dw_{mode}", f"batch {batch} stack timed",
                               lambda: dw_stack(state), times=len(DW_LAYERS))
            dw_stacks.append({"batch": batch, "path": mode,
                              "wall_ms_runs": runs, "wall_ms": wall})
            dw_states[(batch, mode)] = state
    torch.cuda.synchronize()

    for path in EXPECTED:
        log(f"paths: each of {n_forwards[path]} {path} forwards launched "
            f"{json.dumps({k: v for k, v in EXPECTED[path].items() if v})}"
            f"{' per layer' if path.startswith('dw_') else ''}")
        ran = {k for k, v in EXPECTED[path].items() if v}
        if n_forwards[path] == 0 \
                or any(path_launches[path][k] <= 0 for k in ran):
            raise AssertionError(f"a kernel of {path} never launched: "
                                 f"{path_launches[path]}")
    log("paths: launches over all paths", json.dumps(launches))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")

    for row in stacks:
        images, state = served[(row["request"], row["datapath"])]
        row["card_ms"] = timed(lambda: forward(images, state),
                               runs=SERVE_REPEATS)
        log(f"vgg: request {row['request']} batch {row['batch']} "
            f"{row['datapath']}: 13 convs {row['wall_ms']:.3f} ms wall, "
            f"{row['card_ms']:.3f} ms on the card (medians of "
            f"{SERVE_REPEATS})")
    for row in dw_stacks:
        state = dw_states[(row["batch"], row["path"])]
        row["card_ms"] = timed(lambda: dw_stack(state), runs=SERVE_REPEATS)
        log(f"depthwise: batch {row['batch']} {row['path']}: "
            f"{len(DW_LAYERS)} convs {row['wall_ms']:.3f} ms wall, "
            f"{row['card_ms']:.3f} ms on the card (medians of "
            f"{SERVE_REPEATS})")
    for kind in ("int8", "fp"):
        rows = [r for r in per_layer if (r["datapath"] == "fp") == (kind == "fp")]
        worst = max(rows, key=lambda r: r["rel_l2"])
        log(f"vgg: {kind} worst layer vs reference rel L2 "
            f"{worst['rel_l2']:.3e}, max |diff| / max |ref| "
            f"{max(r['scaled_max'] for r in rows):.3e} ({worst['layer']}, "
            f"{worst['datapath']})"
            + (f"; fused equals staged on all {len(vgg_equal)} layer "
               f"requests" if kind == "int8" else ""))
    for mode in ("fused", "staged", "fp"):
        worst = max(dw_rows, key=lambda r: r[f"{mode}_rel_l2"])
        log(f"depthwise: {mode} worst layer vs reference rel L2 "
            f"{worst[f'{mode}_rel_l2']:.3e}, max |diff| / max |ref| "
            f"{max(r[f'{mode}_scaled_max'] for r in dw_rows):.3e} "
            f"({worst['layer']}, batch {worst['batch']}); fused equals "
            f"staged on all {len(dw_rows)} layer requests")

    # xq grid flips between B1 and the reference's transform, per layer
    flips, n_values = [], 0
    for ri, dp, lname, x, p, prep in saved:
        if dp == "fp":
            continue
        f, n = xq_flips(x, p, prep)
        flips.append(f)
        n_values += n
    for row, f in zip((r for r in per_layer if r["datapath"] != "fp"), flips):
        row["xq_flips"] = f
    log(f"vgg: xq values that differ between B1 and its plain version "
        f"on the path's own inputs: {sum(flips)} of {n_values}, worst "
        f"layer {max(flips)}")
    log(f"depthwise: xq values that differ between B1 and its plain "
        f"version: {sum(r['xq_flips'] for r in dw_rows)} of "
        f"{sum(r['xq_values'] for r in dw_rows)}")

    # ---- 6. per-kernel times over the layers of a batch-1 request --------
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None}
              for k in REPLACES}
    # B1, B5 and B3 over the depthwise layers at batch 1, as the staged and
    # fp depthwise paths run them
    dw_totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None}
                 for k in ("sfc_transform_quantize", "sfc_transform",
                           "sfc_inverse")}
    glue = {"fp_contraction_ms": 0.0}
    fp_b3 = {"sfc_inverse_ms": 0.0}         # B3 on the fp request's inputs
    # B3's tile entry on the same values (the JAX kernel's contract, which
    # no path calls), its bound, and the copies the staged path made around
    # it before the NHWC entry
    b3_tile = {"tile_ms": 0.0, "tile_bound_ms": 0.0, "glue_ms": 0.0}
    layer_times = []
    # the card's time for one launch of nothing: a one-float fill
    one = torch.zeros(1, device=dev)
    launch_floor_ms = timed(lambda: one.zero_())

    def time_kernels(row, fns, work, sums=totals):
        """Time each kernel, its plain version and its library call; add
        them and the kernel's bound to ``sums`` and ``row``."""
        for k, (kern, plain, lib) in fns.items():
            nbytes, int8_ops, f32_ops = work[k]
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = (int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S) \
                * 1e3
            ms, plain_ms = timed(kern), timed(plain)
            tot = sums[k]
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bytes_ms"] += bytes_ms
            tot["ops_ms"] += ops_ms
            tot["bound_ms"] += max(bytes_ms, ops_ms)
            row[k] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms
                      else "operations"}
            if lib is not None:
                lib_ms = timed(lib)
                tot["library_ms"] = (tot["library_ms"] or 0.0) + lib_ms
                row[k]["library_ms"] = lib_ms

    def transform_ops(algo, T, C, bt, quantize):
        """f32 operations of B^T X B for T tiles x C channels: B^T rows
        over L columns, then B^T over the t rows (an FMA is two), and for
        the quantizer a divide, round and clip per value."""
        t, L = algo.t, algo.L
        nnz_bt = int((bt != 0).sum())
        return T * C * (2 * nnz_bt * L + 2 * t * nnz_bt
                        + (3 * t * t if quantize else 0))

    def inverse_ops(algo, T, C, at):
        nnz_at = int((at != 0).sum())
        return T * C * (2 * nnz_at * algo.t + 2 * algo.M * nnz_at)

    for ri, dp, lname, x, p, prep in saved:
        if ri != 0 or dp not in ("fused", "fp"):
            continue
        algo = p.algorithm
        t, M, P = algo.t, algo.M, algo.t ** 2
        B, H, W, cin = x.shape
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        grid = c2d.tile_grid(H, W, M, algo.R, "SAME")
        T = B * grid.nH * grid.nW
        row = {"layer": lname, "hw": H, "cin": cin, "path": f"vgg_{dp}"}
        if dp == "fp":
            # B5 over the fp path's inputs; the tiles for its library
            # yardstick, one einsum, are cut out beforehand
            tx = kernels.sfc_transform(x, bt, M)
            tiles, _ = kernels.extract_tiles(x, algo)
            cout = prep.tw.shape[-1]
            row["cout"] = cout
            time_kernels(row, {"sfc_transform": (
                lambda: kernels.sfc_transform(x, bt, M),
                lambda: ref.sfc_transform_nhwc_ref(x, bt, M),
                lambda: torch.einsum("ti,nijc,uj->ntuc", bt, tiles, bt))},
                {"sfc_transform": (4 * x.numel() + 4 * tx.numel(), 0,
                                   transform_ops(algo, T, cin, bt, False))})
            # glue, not a kernel: the P-batched f32 product between B5 and B3
            row["fp_contraction_ms"] = timed(
                lambda: ops.transform_domain_fp(tx, prep.tw))
            glue["fp_contraction_ms"] += row["fp_contraction_ms"]
            # B3 on the fp request's own transform-domain output
            Y = ops.transform_domain_fp(tx, prep.tw)
            row["fp_sfc_inverse_ms"] = timed(
                lambda: kernels.sfc_inverse_nhwc(Y, at, grid))
            fp_b3["sfc_inverse_ms"] += row["fp_sfc_inverse_ms"]
            layer_times.append(row)
            log("times:", json.dumps(row))
            continue
        cout = prep.wq.shape[2]
        row["cout"] = cout
        row["b4_geometry"] = geometry_of(x, prep, algo)
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, -1).contiguous()
        X = kernels.sfc_transform_quantize_pt(x, bt, prep.act_scale, M)
        Y = kernels.tdmm_int8(X, prep.wq, sx, sw)
        g2 = sfc_tdmm.tdmm_geometry(P, T, cin, cout)
        row["b2_geometry"] = [g2.bm, g2.bn, g2.bk, g2.stages, g2.tiles,
                              g2.blocks]
        ty = Y.transpose(0, 1).reshape(T, t, t, cout).contiguous()
        Y6 = Y.view(t, t, B, grid.nH, grid.nW, cout)
        args4 = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        # library yardsticks, timed here and called nowhere in the port: one
        # einsum computes B3's function (NHWC before the crop, a view);
        # cuDNN's fp16 conv of the same shapes stands beside B4
        x16 = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        w16 = prep.w.permute(3, 2, 0, 1).half().contiguous(
            memory_format=torch.channels_last)
        # least bytes and operations of each function on these inputs
        f32_b1 = transform_ops(algo, T, cin, bt, True)
        f32_b3 = inverse_ops(algo, T, cout, at)
        f32_dq = T * cout * 2 * t * t
        work = {
            "sfc_transform_quantize": (4 * x.numel() + X.numel(), 0, f32_b1),
            "tdmm_int8": (X.numel() + prep.wq.numel() + 4 * (P + sw.numel())
                          + 4 * Y.numel(), 2 * P * T * cin * cout, 0),
            "sfc_inverse": (4 * Y.numel() + 4 * B * grid.out_h * grid.out_w
                            * cout + 4 * at.numel(), 0, f32_b3),
            "sfc_fused_conv2d": (4 * x.numel() + prep.wq.numel()
                                 + 4 * (P + sw.numel())
                                 + 4 * B * H * W * cout,
                                 2 * P * T * cin * cout,
                                 f32_b1 + f32_dq + f32_b3),
        }
        fns = {
            "sfc_transform_quantize": (
                lambda: kernels.sfc_transform_quantize_pt(
                    x, bt, prep.act_scale, M),
                lambda: ref.sfc_transform_quantize_pt_ref(
                    x, bt, prep.act_scale, M), None),
            "tdmm_int8": (lambda: kernels.tdmm_int8(X, prep.wq, sx, sw),
                          lambda: ref.tdmm_int8_ref(X, prep.wq, sx, sw),
                          None),
            "sfc_inverse": (lambda: kernels.sfc_inverse_nhwc(Y, at, grid),
                            lambda: ref.sfc_inverse_nhwc_ref(Y, at, grid),
                            lambda: torch.einsum("mt,tubhwo,pu->bhmwpo", at,
                                                 Y6, at)),
            "sfc_fused_conv2d": (
                lambda: kernels.sfc_fused_conv2d(*args4),
                lambda: ref.sfc_fused_conv2d_ref(*args4),
                lambda: F.conv2d(x16, w16, padding=1)),
        }
        time_kernels(row, fns, work)
        row["sfc_inverse_tile_ms"] = timed(
            lambda: kernels.sfc_inverse(ty, at))
        geom = (B, grid.out_h, grid.out_w, grid.nH, grid.nW)
        yt = kernels.sfc_inverse(ty, at)
        row["b3_glue_ms"] = timed(lambda: (
            Y.transpose(0, 1).reshape(T, t, t, cout).contiguous(),
            ops.untile(yt, algo, geom)))
        b3_tile["tile_ms"] += row["sfc_inverse_tile_ms"]
        b3_tile["tile_bound_ms"] += max(
            (4 * ty.numel() + 4 * T * M * M * cout + 4 * at.numel())
            / HBM_BYTES_PER_S * 1e3, f32_b3 / F32_OPS_PER_S * 1e3)
        b3_tile["glue_ms"] += row["b3_glue_ms"]
        layer_times.append(row)
        log("times:", json.dumps(row))

    # B6 and B7 over the depthwise layers of the batch-1 requests, and B1,
    # B5 and B3 on the same inputs as the staged and fp depthwise paths run
    # them
    for lname, p, prep, x in dw_states[(1, "fused")]:
        algo = p.algorithm
        t, M, P = algo.t, algo.M, algo.t ** 2
        B, H, W, c = x.shape
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        grid = c2d.tile_grid(H, W, M, algo.R, "SAME")
        T = B * grid.nH * grid.nW
        sx = prep.act_scale.reshape(P).contiguous()
        wq2 = prep.wq.reshape(P, c)
        sw = prep.w_scale.reshape(P, c).contiguous()
        X = kernels.sfc_transform_quantize_pt(x, bt, prep.act_scale, M)
        args7 = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        # cuDNN's fp16 depthwise conv of the same shape, a yardstick only
        x16 = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        w16 = prep.w.permute(3, 2, 0, 1).half().contiguous(
            memory_format=torch.channels_last)
        scales = 4 * (P + sw.numel())
        Y = kernels.tdmm_int8_depthwise(X, wq2, sx, sw)
        Y6 = Y.view(t, t, B, grid.nH, grid.nW, c)
        work = {
            "tdmm_int8_depthwise": (X.numel() + wq2.numel() + scales
                                    + 4 * X.numel(), 0, 2 * X.numel()),
            "sfc_fused_conv2d_depthwise": (
                4 * x.numel() + wq2.numel() + scales + 4 * x.numel(), 0,
                transform_ops(algo, T, c, bt, True) + 2 * T * c * P
                + inverse_ops(algo, T, c, at)),
        }
        fns = {
            "tdmm_int8_depthwise": (
                lambda: kernels.tdmm_int8_depthwise(X, wq2, sx, sw),
                lambda: ref.tdmm_int8_depthwise_ref(X, wq2, sx, sw), None),
            "sfc_fused_conv2d_depthwise": (
                lambda: kernels.sfc_fused_conv2d(*args7, depthwise=True),
                lambda: ref.sfc_fused_conv2d_ref(*args7, depthwise=True),
                lambda: F.conv2d(x16, w16, padding=1, groups=c)),
        }
        g6 = sfc_tdmm.dw_product_geometry(P, T, c)
        row = {"layer": lname, "hw": H, "c": c, "path": "dw_fused",
               "b6_geometry": [g6.groups, g6.lanes, g6.run, g6.blocks]}
        time_kernels(row, fns, work)
        tiles, _ = kernels.extract_tiles(x, algo)
        time_kernels(row, {
            "sfc_transform_quantize": (
                lambda: kernels.sfc_transform_quantize_pt(
                    x, bt, prep.act_scale, M),
                lambda: ref.sfc_transform_quantize_pt_ref(
                    x, bt, prep.act_scale, M), None),
            "sfc_transform": (
                lambda: kernels.sfc_transform(x, bt, M),
                lambda: ref.sfc_transform_nhwc_ref(x, bt, M),
                lambda: torch.einsum("ti,nijc,uj->ntuc", bt, tiles, bt)),
            "sfc_inverse": (
                lambda: kernels.sfc_inverse_nhwc(Y, at, grid),
                lambda: ref.sfc_inverse_nhwc_ref(Y, at, grid),
                lambda: torch.einsum("mt,tubhwo,pu->bhmwpo", at, Y6, at))}, {
            "sfc_transform_quantize": (4 * x.numel() + X.numel(), 0,
                                       transform_ops(algo, T, c, bt, True)),
            "sfc_transform": (4 * x.numel() + 4 * X.numel(), 0,
                              transform_ops(algo, T, c, bt, False)),
            "sfc_inverse": (4 * Y.numel() + 4 * x.numel() + 4 * at.numel(),
                            0, inverse_ops(algo, T, c, at))}, sums=dw_totals)
        layer_times.append(row)
        log("times:", json.dumps(row))

    # one batch-1 forward of the fp and the staged VGG-16 path under
    # torch.profiler: the card's kernels by name (whether anything runs
    # between the port's kernels and the product, a copy of an operand
    # say) and the card's busy share of the forward
    def profile_forward(fn):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            spans = [(e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        except Exception as e:     # the profiler may not trace this card
            return {"not_measured": f"{type(e).__name__}: {e}"[:200]}
        if not spans:
            return {"not_measured": "the trace holds no device events"}
        by_name = {}
        for start, end, kname in spans:
            n, us = by_name.get(kname, (0, 0.0))
            by_name[kname] = (n + 1, us + end - start)
        busy = sum(end - start for start, end, _ in spans)
        span = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
        return {"kernels": {k: {"count": n, "us": us}
                            for k, (n, us) in sorted(by_name.items())},
                "busy_us": busy, "device_span_us": span, "wall_us": wall_us,
                "busy_share_of_span": busy / span if span else None,
                "busy_share_of_wall": busy / wall_us}

    profiles = {}
    for dp in ("fp", "staged"):
        images, state = served[(0, dp)]
        profiles[dp] = profile_forward(lambda: forward(images, state))
        pf = profiles[dp]
        if "not_measured" in pf:
            log(f"profile: batch-1 {dp} VGG-16 forward not measured: "
                f"{pf['not_measured']}")
            continue
        log(f"profile: batch-1 {dp} VGG-16 forward: card busy "
            f"{pf['busy_us']:.1f} us of a {pf['device_span_us']:.1f} us "
            f"device span ({pf['busy_share_of_span']:.3f}) and "
            f"{pf['wall_us']:.1f} us wall ({pf['busy_share_of_wall']:.3f}), "
            f"the profiler's own cost included; kernels "
            + json.dumps({k[:60]: v["count"] for k, v in
                          pf["kernels"].items()}))

    # device memory of serving the batch-4 int8 request: the peak above
    # what was allocated before it (weights, inputs, everything resident)
    memory = {}
    for dp in datapaths:
        images, state = served[(len(requests) - 1, dp)]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        forward(images, state)
        torch.cuda.synchronize()
        memory[dp] = {
            "peak_above_resident_bytes":
                torch.cuda.max_memory_allocated() - resident,
            "int8_weights_bytes": sum(
                pr.wq.numel() + 4 * (pr.w_scale.numel()
                                     + pr.act_scale.numel())
                for _, pr, _ in state),
            "f32_transformed_weights_bytes": sum(4 * pr.tw.numel()
                                                 for _, pr, _ in state)}
        log(f"memory: batch {images.shape[0]} {dp}: peak "
            f"{memory[dp]['peak_above_resident_bytes'] / 2**20:.1f} MiB "
            f"above resident; int8 weights and scales "
            f"{memory[dp]['int8_weights_bytes'] / 2**20:.1f} MiB; the f32 "
            f"transformed weights PreparedWeights also keeps "
            f"{memory[dp]['f32_transformed_weights_bytes'] / 2**20:.1f} MiB")
    report["phases"]["vgg_paths"] = {"per_layer": per_layer,
                                     "stacks": stacks, "memory": memory,
                                     "fused_equals_staged_layers":
                                         len(vgg_equal)}
    report["phases"]["fp_with_caller_tf32"] = {"setting": tf32_name,
                                               "per_layer": tf32_rows}
    report["phases"]["depthwise_path"] = {"per_layer": dw_rows,
                                          "stacks": dw_stacks}
    report["phases"]["launches"] = {"total": launches,
                                    "per_path": path_launches,
                                    "forwards": n_forwards}
    report["phases"]["kernel_times"] = {
        "per_layer": layer_times, "totals": totals, "glue": glue,
        "fp_request": fp_b3, "depthwise_staged": dw_totals,
        "b3_tile": b3_tile, "launch_floor_ms": launch_floor_ms,
        "profiles": profiles}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))

    line = {"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
        "bound_ms": totals[k]["bound_ms"],
        "bound_by": "bytes" if totals[k]["bytes_ms"] >= totals[k]["ops_ms"]
        else "operations",
        "library_ms": totals[k]["library_ms"]}
        for k, (src, rep) in REPLACES.items()]}
    log(f"glue: the fp path's P-batched f32 product (torch.bmm, not a "
        f"kernel of the port) {glue['fp_contraction_ms']:.4f} ms over the "
        f"13 convs of the batch-1 fp request")
    log(f"fp path: B3 {fp_b3['sfc_inverse_ms']:.4f} ms over the 13 convs "
        f"of the batch-1 fp request")
    log(f"staged path: B3's NHWC entry {totals['sfc_inverse']['ms']:.4f} ms "
        f"(bound {totals['sfc_inverse']['bound_ms']:.4f}) over the 13 convs "
        f"of the batch-1 int8 request, against its tile entry "
        f"{b3_tile['tile_ms']:.4f} ms (bound {b3_tile['tile_bound_ms']:.4f}) "
        f"and the copies around the tile entry {b3_tile['glue_ms']:.4f} ms")
    log("depthwise staged and fp paths: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, plain "
        f"{v['plain_ms']:.4f})" for k, v in dw_totals.items())
        + f" over the {len(DW_LAYERS)} depthwise convs at batch 1")
    log(f"launch floor: {launch_floor_ms:.4f} ms a timed call (a one-float "
        f"fill)")
    log(f"times above: sums, median of {TIMED_RUNS} runs each, on {smi}: "
        f"B1-B4 over the 13 convs of one batch-1 int8 VGG-16 request (B1 "
        f"its (P, T, C) entry, B3 its NHWC entry), B5 "
        f"over those of the batch-1 fp request, B6 and B7 over the "
        f"{len(DW_LAYERS)} depthwise convs at batch 1")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
