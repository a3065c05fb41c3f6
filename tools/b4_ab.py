#!/usr/bin/env python3
"""B4 over VGG-16's 13 convs at batch 1 (sfc6_6 and sfc6_7, default
geometry), card ms summed over the layers, for the tree at argv[1].

    python3 tools/b4_ab.py <tree> <label>

Compares two trees of the repo on one GPU: unpack the other commit with
``git archive`` under ``build/`` and run both in turns (parent, change,
change, parent, ...), one process each, on one card.  Each layer's input
and He-normal weights come from a numpy seed (the layer's index), the
activation scales are calibrated on the input, and each time is the
median of 25 runs queued behind a spin kernel.  Prints the label and a
JSON object {algorithm: ms}.
"""
import json
import math
import statistics
import sys

sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.api import ConvSpec, plan, tuning  # noqa: E402
from repro_torch.quant import INT8_FREQ  # noqa: E402

dev = torch.device("cuda", 0)
VGG = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
       (56, 128, 256), (56, 256, 256), (56, 256, 256), (28, 256, 512),
       (28, 512, 512), (28, 512, 512), (14, 512, 512), (14, 512, 512),
       (14, 512, 512)]


def timed(fn, runs=25):
    fn()
    torch.cuda.synchronize()
    for doubling in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 2)]
        ev[0].record()
        torch.cuda._sleep(20_000_000 << doubling)
        ev[1].record()
        for e in ev[2:]:
            fn()
            e.record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 0:
            break
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(1, runs + 1))


out = {}
for name in ("sfc6_6", "sfc6_7"):
    total = 0.0
    for li, (hw, cin, cout) in enumerate(VGG):
        rng = np.random.RandomState(li)
        x = torch.tensor(rng.randn(1, hw, hw, cin), dtype=torch.float32,
                         device=dev)
        w = torch.tensor(rng.randn(3, 3, cin, cout)
                         * math.sqrt(2.0 / (9 * cin)), dtype=torch.float32,
                         device=dev)
        spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
        p = plan(spec, backend="cuda", algo=name)
        act = tuning.calibrate_act_scale(x, p.algorithm, INT8_FREQ, "SAME")
        prep = p.prepare_weights(w, act_scale=act)
        args = (x, prep.wq, prep.act_scale, prep.w_scale, p.algorithm)
        total += timed(lambda: kernels.sfc_fused_conv2d(*args))
    out[name] = total
print(sys.argv[2], json.dumps(out), flush=True)
