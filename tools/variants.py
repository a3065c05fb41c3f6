#!/usr/bin/env python3
"""Time a kernel of the port against variants of its CUDA source on one GPU.

    python3 tools/variants.py b7-loaders   # B7: TMA copies or plain loads
    python3 tools/variants.py b3-splits    # B3: 1, 2 or 3 threads a tile
    python3 tools/variants.py b1-quantizer # B1: reciprocal or division
    python3 tools/variants.py b1-loaders   # B1 and B5: TMA or plain loads
    python3 tools/variants.py b4-zero      # B4: division or zero guard

A variant is a copy of ``src/repro_torch`` under ``build/variants/<study>/
<name>/`` with lines of one CUDA source replaced (the first variant is the
source as it is).  The copies are built at once, then timed each in its
own process in turns (first .. last, last .. first) at the layer shapes of
``chip_smoke.py`` (B7: the depthwise layers at batch 1 and 4; B3: VGG-16's
and the depthwise layers' shapes at batch 1, both entries; B1 and B5: B1's
(P, T, C) entry and B5 at VGG-16's and the depthwise layers' input shapes
at batch 1; B4: VGG-16's layers at batch 1), each output held bit for bit
to the first variant's.  VGG-16's inputs past the first layer are
non-negative with a quarter of the channels zero, as a ReLU leaves them,
and the activation scales are calibrated on the inputs.  Card milliseconds
are the median of 25 spin-queued runs, as in ``chip_smoke.py``.  Writes
``chiprun_out/<study>.json`` and a summary to standard output.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNS = 25

# study -> variants: name -> (csrc file, line as it is, line replaced)
STUDIES = {
    "b7-loaders": {
        "tma": [],
        "plain": [("sfc_fused_dw.cu", "  a.tma = C % 16 == 0",
                   "  a.tma = false && C % 16 == 0")],
    },
    "b1-loaders": {
        "tma": [],
        "plain": [("sfc_transform.cu",
                   "  a.tma = sfc::region_tma_ok(x, C, cb, (int)region_w);",
                   "  a.tma = false;")],
    },
    "b1-quantizer": {
        "reciprocal": [],
        "division": [
            ("sfc_transform.cu",
             "        sfc::transform_quantize_row_by_reciprocal<kT, kL,",
             "        sfc::transform_quantize_row<kT, kL,"),
            ("sfc_transform.cu",
             "            x_at, a.bt, a.sc, a.rc, a.qmax, u, store);",
             "            x_at, a.bt, s, a.qmax, u, store);")],
    },
    # a zero dividend sends the IEEE division down its slow path, and
    # whole tiles are zero where a ReLU left a channel dead: "guard"
    # divides |s| / 4 instead (|s| capped at the largest float), whose
    # quotient rounds to the same 0 (0 where s is infinite, NaN where s is
    # 0 or NaN, as 0 / s)
    "b4-zero": {
        "divide": [],
        "guard": [("sfc_common.cuh",
                   "  const float q = rintf(__fdiv_rn(tx, s));",
                   "  const float q = rintf(__fdiv_rn(tx == 0.f ? 0.25f * "
                   "fminf(fabsf(s), 0x1.fffffep127f) : tx, s));")],
    },
    "b3-splits": {
        f"splits{k}": [] if k == 2 else
        [("sfc_inverse.cu", "constexpr int kSplits = 2;",
          f"constexpr int kSplits = {k};")]
        for k in (2, 1, 3)
    },
}


def make_copy(study: str, name: str) -> pathlib.Path:
    """The variant's copy of the port, its sources patched."""
    dest = ROOT / "build" / "variants" / study / name
    shutil.rmtree(dest / "src", ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in STUDIES[study][name]:
        path = dest / "src" / "repro_torch" / "csrc" / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{study}/{name}: {old!r} is not one line of "
                             f"{fname}")
        path.write_text(text.replace(old, new))
    return dest


def timed(fn, torch):
    """Median card ms of one ``fn`` call, the calls queued behind a spin
    kernel so the host's launch overhead does not show."""
    fn()
    torch.cuda.synchronize()
    for doubling in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(RUNS + 2)]
        ev[0].record()
        torch.cuda._sleep(20_000_000 << doubling)
        ev[1].record()
        t0 = time.perf_counter()
        for e in ev[2:]:
            fn()
            e.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        times = [ev[i].elapsed_time(ev[i + 1]) for i in range(1, RUNS + 1)]
        if enqueue_ms < ev[0].elapsed_time(ev[1]):
            break
    return statistics.median(times)


def digest(y) -> str:
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()


def worker(study: str, copy: pathlib.Path, build_only: bool) -> None:
    """In the variant's process: time each shape, print one JSON line."""
    sys.path.insert(0, str(copy / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch import kernels
    from repro_torch.kernels import _build

    import chip_smoke   # after the copy's package: it puts src/ first
    assert pathlib.Path(repro_torch.__file__).is_relative_to(copy)
    _build.library()
    if build_only:
        return
    dev = torch.device("cuda", 0)
    algo = registry.get_algorithm(chip_smoke.ALGO)
    t, M, P = algo.t, algo.M, algo.t ** 2
    rows = []
    if study == "b7-loaders":
        shapes = dict.fromkeys((hw, c) for _, hw, c in chip_smoke.DW_LAYERS)
        for batch in chip_smoke.DW_BATCHES:
            for hw, c in shapes:
                rng = np.random.RandomState(hw + c)
                x = torch.tensor(rng.randn(batch, hw, hw, c),
                                 dtype=torch.float32, device=dev)
                wq = torch.tensor(rng.randint(-127, 128, (P, 1, c)),
                                  dtype=torch.int8, device=dev)
                act = torch.full((t, t), 0.05, device=dev)
                ws = torch.full((t, t, c), 1e-3, device=dev)

                def run():
                    return kernels.sfc_fused_conv2d_depthwise(
                        x, wq, act, ws, algo)
                rows.append({"batch": batch, "hw": hw, "c": c,
                             "digest": digest(run()),
                             "ms": timed(run, torch)})
    elif study == "b4-zero":
        from repro_torch.api import tuning
        from repro_torch.quant import INT8_FREQ
        vgg, _ = chip_smoke.vgg_layers()
        for hw, cin, cout in dict.fromkeys((hw, cin, cout)
                                           for _, hw, cin, cout in vgg):
            rng = np.random.RandomState(hw + cin)
            x = rng.randn(1, hw, hw, cin)
            if cin > 3:     # a ReLU's output: a quarter of the channels dead
                x = np.maximum(x, 0) * (rng.rand(cin) >= 0.25)
            x = torch.tensor(x, dtype=torch.float32, device=dev)
            wq = torch.tensor(rng.randint(-127, 128, (P, cin, cout)),
                              dtype=torch.int8, device=dev)
            ws = torch.full((t, t, cout), 1e-3, device=dev)
            act = tuning.calibrate_act_scale(x, algo, INT8_FREQ)

            def run():
                return kernels.sfc_fused_conv2d(x, wq, act, ws, algo)
            rows.append({"hw": hw, "cin": cin, "cout": cout,
                         "digest": digest(run()), "ms": timed(run, torch)})
    elif study.startswith("b1-"):
        from repro_torch.api import tuning
        from repro_torch.quant import INT8_FREQ
        bt = c2d.transform_matrices(algo, torch.float32, dev)[0]
        vgg, _ = chip_smoke.vgg_layers()
        shapes = [(hw, cin, cin > 3) for _, hw, cin, _ in vgg] \
            + [(hw, c, False) for _, hw, c in chip_smoke.DW_LAYERS]
        for hw, c, relu in dict.fromkeys(shapes):
            rng = np.random.RandomState(hw + c)
            x = rng.randn(1, hw, hw, c)
            if relu:    # a ReLU's output: a quarter of the channels dead
                x = np.maximum(x, 0) * (rng.rand(c) >= 0.25)
            x = torch.tensor(x, dtype=torch.float32, device=dev)
            act = tuning.calibrate_act_scale(x, algo, INT8_FREQ)

            def b1():
                return kernels.sfc_transform_quantize_pt(x, bt, act, M)

            def b5():
                return kernels.sfc_transform(x, bt, M)
            rows.append({"hw": hw, "c": c, "relu": relu,
                         "digest": digest(b1()) + digest(b5()),
                         "ms": timed(b1, torch), "b5_ms": timed(b5, torch)})
    else:
        at = c2d.transform_matrices(algo, torch.float32, dev)[2]
        vgg, _ = chip_smoke.vgg_layers()
        shapes = [(hw, cout) for _, hw, _, cout in vgg] \
            + [(hw, c) for _, hw, c in chip_smoke.DW_LAYERS]
        for hw, O in dict.fromkeys(shapes):
            grid = c2d.tile_grid(hw, hw, M, algo.R, "SAME")
            T = grid.nH * grid.nW
            Y = torch.tensor(np.random.RandomState(hw + O).randn(P, T, O),
                             dtype=torch.float32, device=dev)
            ty = Y.transpose(0, 1).reshape(T, t, t, O).contiguous()
            rows.append({
                "hw": hw, "O": O,
                "digest": digest(kernels.sfc_inverse_nhwc(Y, at, grid))
                + digest(kernels.sfc_inverse(ty, at)),
                "nhwc_ms": timed(
                    lambda: kernels.sfc_inverse_nhwc(Y, at, grid), torch),
                "tile_ms": timed(
                    lambda: kernels.sfc_inverse(ty, at), torch)})
    print(json.dumps(rows), flush=True)


def run_worker(study, copy, build_only=False):
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
           study, str(copy)] + (["--build-only"] if build_only else [])
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"{copy.name}: exit {done.returncode}\n"
                         f"{done.stderr[-3000:]}")
    return None if build_only else json.loads(done.stdout.splitlines()[-1])


def main(study: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tools/variants.py needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    names = list(STUDIES[study])
    copies = {n: make_copy(study, n) for n in names}
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(lambda n: run_worker(study, copies[n], True), names))
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(run_worker(study, copies[n]))
    keys = {"b3-splits": ("nhwc_ms", "tile_ms"),
            "b1-quantizer": ("ms", "b5_ms"),
            "b1-loaders": ("ms", "b5_ms")}.get(study, ("ms",))
    rows = []
    for i, first in enumerate(runs[names[0]][0]):
        row = {k: v for k, v in first.items()
               if k not in ("digest",) + keys}
        for n in names:
            for r in runs[n]:
                if r[i]["digest"] != first["digest"]:
                    raise SystemExit(f"{study}: {n} differs from "
                                     f"{names[0]} at {row}")
            for k in keys:
                row[f"{n}_{k}"] = [r[i][k] for r in runs[n]]
        rows.append(row)
        print(json.dumps(row), flush=True)
    totals = {f"{n}_{k}": sum(statistics.mean(r[f"{n}_{k}"]) for r in rows)
              for n in names for k in keys}
    print(f"{study} on {smi}: every variant bit-identical to {names[0]}; "
          f"ms summed over the shapes (mean of two turns): "
          f"{json.dumps(totals)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{study}.json").write_text(json.dumps(
        {"device": smi, "totals": totals, "rows": rows}, indent=1))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], pathlib.Path(sys.argv[3]),
               "--build-only" in sys.argv[4:])
    elif len(sys.argv) == 2 and sys.argv[1] in STUDIES:
        main(sys.argv[1])
    else:
        raise SystemExit(f"usage: tools/variants.py {{{','.join(STUDIES)}}}")
