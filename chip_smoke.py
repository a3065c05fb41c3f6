#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SFC (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (an H100) and the CUDA
toolkit's ``nvcc``; it builds the port's kernels from ``src/repro_torch/
csrc`` at first use.  Phases, each of which raises on failure:

  1. probe: PyTorch, CUDA, the card, ``nvcc``, its name and power limit;
  2. build the kernels and report the seconds it took;
  3. each kernel against its plain PyTorch version on the card, at VGG-16
     layer shapes, with the tolerance stated beside each check;
  4. the main path: requests through VGG-16's 13-layer conv stack at
     224x224 and its published widths, every layer through
     ``ConvSpec -> plan(backend="cuda", algo="sfc6_6") -> calibrate ->
     prepare_weights -> apply``, on the fused and the staged datapath,
     each layer held against the ``reference`` backend on the same input;
     every forward of it starts from launch counts of 0 and must launch
     its datapath's kernels once per conv and the other datapath's never;
  5. per kernel, the times over the 13 layers of one batch-1 request:
     the kernel, its plain version, one PyTorch library call where one
     computes the same function, and the least time the card could take.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  A longer report goes to
``build/chip_smoke_report.json``.  Weights and images are random, from
numpy seeds.
"""
from __future__ import annotations

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
ALGO = "sfc6_6"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM, int8 tensor cores, and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
TIMED_RUNS = 25
SPIN_CYCLES = 20_000_000        # ~10 ms at the H100's clock; doubled on need
SERVE_REPEATS = 5
KERNEL_CHECKS = (("sfc6_6", 224, 3, 64), ("sfc6_6", 56, 256, 256),
                 ("sfc6_6", 14, 512, 512), ("sfc6_7", 56, 256, 256))
REPLACES = {
    "sfc_transform_quantize": ("src/repro_torch/csrc/sfc_transform.cu",
                               "src/repro/kernels/sfc_transform.py:36"),
    "tdmm_int8": ("src/repro_torch/csrc/sfc_tdmm.cu",
                  "src/repro/kernels/sfc_tdmm.py:41"),
    "sfc_inverse": ("src/repro_torch/csrc/sfc_inverse.cu",
                    "src/repro/kernels/sfc_inverse.py:20"),
    "sfc_fused_conv2d": ("src/repro_torch/csrc/sfc_fused.cu",
                         "src/repro/kernels/sfc_fused.py:490"),
}


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.api import ConvSpec, plan, tuning
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import _build, ref
    from repro_torch.quant import INT8_FREQ
    from repro_torch.testing import DEFAULT_TOL

    dev = torch.device("cuda", 0)
    # every reference compared against runs in full float32: cuDNN and
    # cuBLAS would otherwise use TF32 for f32 convolutions / matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    log("probe: TF32 off for cuDNN and cuBLAS (references run in float32)")
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

    def snapped(rng, shape):
        return torch.tensor(np.round(rng.randn(*shape) * 16) / 16,
                            dtype=torch.float32, device=dev)

    def he_normal(rng, cin, cout):
        w = rng.randn(3, 3, cin, cout) * math.sqrt(2.0 / (9 * cin))
        return torch.tensor(w, dtype=torch.float32, device=dev)

    def prepared(x, w, algo_name, config=None):
        spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
        p = plan(spec, backend="cuda", algo=algo_name)
        if config is not None:
            p = p.with_config(config)
        act = tuning.calibrate_act_scale(x, p.algorithm, INT8_FREQ)
        return p, p.prepare_weights(w, act_scale=act)

    def scaled_err(got, want):
        return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
                ).item()

    # ---- 3. each kernel against its plain version ------------------------
    max_err = {k: 0.0 for k in REPLACES}
    checks = []
    rng = np.random.RandomState(11)
    for algo_name, hw, cin, cout in KERNEL_CHECKS:
        x = snapped(rng, (1, hw, hw, cin))
        w = he_normal(rng, cin, cout)
        p, prep = prepared(x, w, algo_name)
        algo = p.algorithm
        t, P = algo.t, algo.t ** 2
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        case = {"algo": algo_name, "hw": hw, "cin": cin, "cout": cout}
        # B1 on snapped inputs: B^T X B is exact in f32 in any order
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale, algo.M)
        xq_ref = ref.sfc_transform_quantize_nhwc_ref(x, bt, prep.act_scale,
                                                     algo.M)
        case["b1_mismatch_snapped"] = int((xq != xq_ref).sum())
        if case["b1_mismatch_snapped"]:
            raise AssertionError(f"B1 differs from its plain version on "
                                 f"snapped inputs: {case}")
        # B1 on raw inputs: summation order may flip a .5 tie by one LSB
        xr = torch.tensor(rng.randn(1, hw, hw, cin), dtype=torch.float32,
                          device=dev)
        d = (kernels.sfc_transform_quantize(xr, bt, prep.act_scale, algo.M)
             .int() - ref.sfc_transform_quantize_nhwc_ref(
                 xr, bt, prep.act_scale, algo.M).int()).abs()
        flips, worst = int((d != 0).sum()), int(d.max())
        case["b1_flips_raw"], case["b1_values"] = flips, d.numel()
        if worst > 1 or flips * 10000 > d.numel():
            raise AssertionError(f"B1 flips beyond 1 in 1e4 or by more than "
                                 f"one step: {case}, worst {worst}")
        max_err["sfc_transform_quantize"] = max(
            max_err["sfc_transform_quantize"], float(worst))
        # B2 on the same int8 operands: int32 exact, f32 output to 1e-6
        X = xq.reshape(-1, P, cin).transpose(0, 1).contiguous()
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, -1).contiguous()
        Y_ref = ref.tdmm_int8_ref(X, prep.wq, sx, sw)
        for k_block in (None, 64):
            Y = kernels.tdmm_int8(X, prep.wq, sx, sw, k_block=k_block)
            torch.testing.assert_close(Y, Y_ref, rtol=1e-6, atol=0)
            case[f"b2_bit_equal_kblock_{k_block}"] = bool(torch.equal(Y, Y_ref))
            max_err["tdmm_int8"] = max(max_err["tdmm_int8"],
                                       (Y - Y_ref).abs().max().item())
        # B3: rtol 1e-5, atol 1e-5 of the output's scale
        ty = Y.transpose(0, 1).reshape(-1, t, t, cout).contiguous()
        yt, yt_ref = kernels.sfc_inverse(ty, at), ref.sfc_inverse_ref(ty, at)
        torch.testing.assert_close(yt, yt_ref, rtol=1e-5,
                                   atol=1e-5 * yt_ref.abs().max().item())
        max_err["sfc_inverse"] = max(max_err["sfc_inverse"],
                                     (yt - yt_ref).abs().max().item())
        # B4 against its plain version and against the staged CUDA path,
        # within DEFAULT_TOL of the output's scale, on snapped inputs
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
        max_err["sfc_fused_conv2d"] = max(max_err["sfc_fused_conv2d"],
                                          (yf - y_ref).abs().max().item())
        torch.cuda.synchronize()
        log("kernels:", json.dumps(case))
        checks.append(case)
    report["phases"]["kernel_checks"] = checks

    # ---- 4. the main path ------------------------------------------------
    layers, stage_ends = vgg_layers()
    wrng = np.random.RandomState(0)
    weights = {n: he_normal(wrng, cin, cout) for n, _, cin, cout in layers}
    biases = {n: torch.zeros(cout, device=dev) for n, _, _, cout in layers}
    requests = [torch.tensor(np.random.RandomState(100 + i).randn(
        b, IMAGE, IMAGE, 3), dtype=torch.float32, device=dev)
        for i, b in enumerate(REQUEST_BATCHES)]
    datapaths = {"fused": tuning.DEFAULT_FUSED,
                 "staged": tuning.DEFAULT_STAGED}
    saved = []                    # (request, datapath, layer, x, plan, prep)
    per_layer, stacks, served = [], [], {}
    # what one forward of each datapath launches: its kernels once per conv
    expected = {
        "fused": {k: len(layers) if k == "sfc_fused_conv2d" else 0
                  for k in REPLACES},
        "staged": {k: 0 if k == "sfc_fused_conv2d" else len(layers)
                   for k in REPLACES}}
    launches = {k: 0 for k in REPLACES}   # summed over the main path's forwards
    n_forwards = {dp: 0 for dp in datapaths}

    def counted(dp, what, fn):
        """Run one forward of datapath ``dp`` with every launch count set
        to 0 just before it, and check just after it what it launched."""
        kernels.reset_launch_counts()
        out = fn()
        got = kernels.launch_counts()
        if got != expected[dp]:
            raise AssertionError(f"{what}: the {dp} forward launched {got}, "
                                 f"not {expected[dp]}")
        for k in launches:
            launches[k] += got[k]
        n_forwards[dp] += 1
        return out

    def forward(images, state):
        """The served forward: 13 convs with prepared int8 weights."""
        h = images
        for li, (p, prep, bias) in enumerate(state):
            h = torch.relu(p.apply(h, prep, bias=bias))
            if li in stage_ends:
                h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(
                    0, 2, 3, 1).contiguous()
        return h

    def check_pass(ri, images, dp, config):
        """One forward of a request, every layer checked on its way."""
        h, state = images, []
        for li, (lname, hw, cin, cout) in enumerate(layers):
            p, prep = prepared(h, weights[lname], ALGO, config)
            y = p.apply(h, prep, bias=biases[lname])
            y_ref = plan(p.spec, backend="reference", algo=ALGO).apply(
                h, prep, bias=biases[lname])
            rel_l2 = ((y - y_ref).norm() / y_ref.norm()).item()
            scaled = scaled_err(y, y_ref)
            if not (rel_l2 <= 1e-4 and scaled <= 1e-2
                    and torch.isfinite(y).all()):
                raise AssertionError(
                    f"request {ri} {dp} {lname}: rel L2 {rel_l2}, max "
                    f"|diff| / max |ref| {scaled} against the reference")
            per_layer.append({"request": ri, "batch": h.shape[0],
                              "datapath": dp, "layer": lname, "hw": hw,
                              "cin": cin, "cout": cout, "rel_l2": rel_l2,
                              "scaled_max": scaled})
            saved.append((ri, dp, lname, h, p, prep))
            state.append((p, prep, biases[lname]))
            h = torch.relu(y)
            if li in stage_ends:
                h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(
                    0, 2, 3, 1).contiguous()
        return h, state

    for ri, images in enumerate(requests):
        for dp, config in datapaths.items():
            # the checking pass: calibrate, prepare and apply every layer,
            # each held against the reference backend on the same input
            h, state = counted(dp, f"request {ri} checked",
                               lambda: check_pass(ri, images, dp, config))
            if h.shape != (images.shape[0], 7, 7, 512) \
                    or not torch.isfinite(h).all():
                raise AssertionError(f"request {ri} {dp}: stack output "
                                     f"{tuple(h.shape)} not finite 7x7x512")
            # the served forward with these prepared weights, wall clock
            # (host and card); the card's own time is taken after the
            # launch counts are read
            if not torch.equal(counted(dp, f"request {ri} served",
                                       lambda: forward(images, state)), h):
                raise AssertionError(f"request {ri} {dp}: the served "
                                     f"forward differs from the checked one")
            walls = []
            for _ in range(SERVE_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                counted(dp, f"request {ri} timed",
                        lambda: forward(images, state))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            stacks.append({"request": ri, "batch": images.shape[0],
                           "datapath": dp, "wall_ms_runs": walls,
                           "wall_ms": statistics.median(walls)})
            served[(ri, dp)] = state
    torch.cuda.synchronize()
    for dp in datapaths:
        log(f"main: each of {n_forwards[dp]} {dp} forwards launched "
            f"{json.dumps(expected[dp])}")
    log("main: launches over the main path", json.dumps(launches))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    for row in stacks:
        images = requests[row["request"]]
        state = served[(row["request"], row["datapath"])]
        row["card_ms"] = timed(lambda: forward(images, state),
                               runs=SERVE_REPEATS)
        log(f"main: request {row['request']} batch {row['batch']} "
            f"{row['datapath']}: 13 convs {row['wall_ms']:.3f} ms wall, "
            f"{row['card_ms']:.3f} ms on the card (medians of "
            f"{SERVE_REPEATS})")
    worst = max(per_layer, key=lambda r: r["rel_l2"])
    log(f"main: worst layer vs reference rel L2 {worst['rel_l2']:.3e} "
        f"({worst['layer']}, {worst['datapath']})")

    # xq grid flips between B1 and the reference's transform, per layer
    flips, n_values = [], 0
    for ri, dp, lname, x, p, prep in saved:
        bt = c2d.transform_matrices(p.algorithm, torch.float32, dev)[0]
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale,
                                            p.algorithm.M)
        xq_ref = ref.sfc_transform_quantize_nhwc_ref(x, bt, prep.act_scale,
                                                     p.algorithm.M)
        flips.append(int((xq != xq_ref).sum()))
        n_values += xq.numel()
    for row, f in zip(per_layer, flips):
        row["xq_flips"] = f
    log(f"main: xq values that differ between B1 and its plain version "
        f"on the path's own inputs: {sum(flips)} of {n_values}, worst "
        f"layer {max(flips)}")

    # ---- 5. per-kernel times over the 13 layers of request 0 ------------
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None}
              for k in REPLACES}
    layer_times = []
    for ri, dp, lname, x, p, prep in saved:
        if ri != 0 or dp != "fused":
            continue
        algo = p.algorithm
        t, M, L, P = algo.t, algo.M, algo.L, algo.t ** 2
        B, H, W, cin = x.shape
        cout = prep.wq.shape[2]
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        grid = c2d.tile_grid(H, W, M, algo.R, "SAME")
        T = B * grid.nH * grid.nW
        nnz_bt = int((bt != 0).sum())
        nnz_at = int((at != 0).sum())
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, -1).contiguous()
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale, M)
        X = xq.reshape(T, P, cin).transpose(0, 1).contiguous()
        Y = kernels.tdmm_int8(X, prep.wq, sx, sw)
        ty = Y.transpose(0, 1).reshape(T, t, t, cout).contiguous()
        args4 = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        # library yardsticks, timed here and called nowhere in the port: one
        # einsum computes B3's function; cuDNN's fp16 conv of the same
        # shapes stands beside B4
        x16 = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        w16 = prep.w.permute(3, 2, 0, 1).half().contiguous(
            memory_format=torch.channels_last)
        # least bytes and operations of each function on these inputs
        # per (tile, channel): B^T rows over L columns, then B^T over the
        # t rows, then divide, round, clip; the inverse likewise with A^T;
        # an FMA is two operations
        f32_b1 = T * cin * (2 * nnz_bt * L + 2 * t * nnz_bt + 3 * t * t)
        f32_b3 = T * cout * (2 * nnz_at * t + 2 * M * nnz_at)
        f32_dq = T * cout * 2 * t * t
        work = {
            "sfc_transform_quantize": (4 * x.numel() + xq.numel(), 0, f32_b1),
            "tdmm_int8": (X.numel() + prep.wq.numel() + 4 * (P + sw.numel())
                          + 4 * Y.numel(), 2 * P * T * cin * cout, 0),
            "sfc_inverse": (4 * ty.numel() + 4 * T * M * M * cout
                            + 4 * at.numel(), 0, f32_b3),
            "sfc_fused_conv2d": (4 * x.numel() + prep.wq.numel()
                                 + 4 * (P + sw.numel())
                                 + 4 * B * H * W * cout,
                                 2 * P * T * cin * cout,
                                 f32_b1 + f32_dq + f32_b3),
        }
        fns = {
            "sfc_transform_quantize": (
                lambda: kernels.sfc_transform_quantize(x, bt, prep.act_scale,
                                                       M),
                lambda: ref.sfc_transform_quantize_nhwc_ref(
                    x, bt, prep.act_scale, M), None),
            "tdmm_int8": (lambda: kernels.tdmm_int8(X, prep.wq, sx, sw),
                          lambda: ref.tdmm_int8_ref(X, prep.wq, sx, sw),
                          None),
            "sfc_inverse": (lambda: kernels.sfc_inverse(ty, at),
                            lambda: ref.sfc_inverse_ref(ty, at),
                            lambda: torch.einsum("mt,ntuo,pu->nmpo", at, ty,
                                                 at)),
            "sfc_fused_conv2d": (
                lambda: kernels.sfc_fused_conv2d(*args4),
                lambda: ref.sfc_fused_conv2d_ref(*args4),
                lambda: F.conv2d(x16, w16, padding=1)),
        }
        row = {"layer": lname, "hw": H, "cin": cin, "cout": cout}
        for k, (kern, plain, lib) in fns.items():
            nbytes, int8_ops, f32_ops = work[k]
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = (int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S) \
                * 1e3
            ms, plain_ms = timed(kern), timed(plain)
            tot = totals[k]
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
        layer_times.append(row)
        log("times:", json.dumps(row))
    # device memory of serving the batch-4 request: the peak above what
    # was allocated before it (weights, inputs, everything resident)
    memory = {}
    for dp in datapaths:
        state = served[(len(requests) - 1, dp)]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        forward(requests[-1], state)
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
        log(f"memory: batch {requests[-1].shape[0]} {dp}: peak "
            f"{memory[dp]['peak_above_resident_bytes'] / 2**20:.1f} MiB "
            f"above resident; int8 weights and scales "
            f"{memory[dp]['int8_weights_bytes'] / 2**20:.1f} MiB; the f32 "
            f"transformed weights PreparedWeights also keeps "
            f"{memory[dp]['f32_transformed_weights_bytes'] / 2**20:.1f} MiB")
    report["phases"]["main_path"] = {"per_layer": per_layer,
                                     "stacks": stacks, "launches": launches,
                                     "memory": memory}
    report["phases"]["kernel_times"] = {"per_layer": layer_times,
                                        "totals": totals}
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
    log(f"times above: sums over the 13 convs of one batch-1 request, "
        f"median of {TIMED_RUNS} runs each, on {smi}")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
