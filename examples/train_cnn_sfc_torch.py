"""End-to-end driver through the PyTorch port: train a CNN, swap its 3x3
stride-1 convs for quantized SFC, compare.

    PYTHONPATH=src python examples/train_cnn_sfc_torch.py [--steps 150]
        [--device cuda]

The port's counterpart of ``examples/train_cnn_sfc.py``, on the same CNN,
data and schedule: train fp32 -> swap every 3x3 stride-1 conv for
quantized SFC-6 (dynamic transform-domain fake quant on the reference
backend) -> measure accuracy retention, vs the same swap with Winograd
F(4x4,3x3).  Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import CNNConfig
from repro_torch.data import ImagePipelineConfig, SyntheticImagePipeline
from repro_torch.models.cnn import cnn_loss, init_resnet, resnet_forward
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import init_train_state, make_train_step

CFG = CNNConfig(name="example-cnn", stages=(1, 1), widths=(16, 32),
                image_size=24, n_classes=10)

ROWS = [("direct fp32", {}),
        ("direct int8", {"quant": "int8", "conv_algo": "direct"}),
        ("SFC-6(6x6,3x3) int8", {"conv_algo": "sfc6_6", "quant": "int8"}),
        ("SFC-6(7x7,3x3) int8", {"conv_algo": "sfc6_7", "quant": "int8"}),
        ("SFC-6 int6", {"conv_algo": "sfc6_6", "quant": "int6"}),
        ("Wino(4x4,3x3) int8", {"conv_algo": "wino4", "quant": "int8"}),
        ("Wino(4x4,3x3) int6", {"conv_algo": "wino4", "quant": "int6"})]


class CNNModel:
    """A CNN as ``make_train_step`` takes a model: ``init(generator)`` and
    ``loss(params, batch) -> (loss, metrics)``."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, gen):
        return init_resnet(gen, self.cfg, device=gen.device)

    def loss(self, params, batch):
        return cnn_loss(params, self.cfg, batch)


def to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def accuracy(cfg, params, pipe, device, n=6, start=5000):
    """Held-out accuracy over ``n`` batches from index ``start``."""
    correct = total = 0
    for i in range(start, start + n):
        b = pipe.batch(i)
        logits = resnet_forward(params, cfg,
                                torch.from_numpy(b["images"]).to(device))
        correct += int((logits.argmax(-1).cpu().numpy()
                        == b["labels"]).sum())
        total += len(b["labels"])
    return correct / total


def accuracy_table(cfg, params, pipe, device):
    """The seven variants' held-out accuracy: [(name, accuracy), ...]."""
    return [(name, accuracy(dataclasses.replace(cfg, **kw), params, pipe,
                            device)) for name, kw in ROWS]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)

    pipe = SyntheticImagePipeline(ImagePipelineConfig(
        image_size=CFG.image_size, n_classes=CFG.n_classes,
        global_batch=32, seed=3))
    model = CNNModel(CFG)
    opt = AdamW(lr=cosine_schedule(3e-3, 10, args.steps), weight_decay=1e-4)
    state = init_train_state(model, opt, seed=0, device=device)
    step = make_train_step(model, opt)

    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, to_device(pipe.batch(i), device))
        if i % 25 == 0:
            print(f"step {i:4d}  loss {float(m['loss']):.3f}  "
                  f"acc {float(m['acc']):.3f}")
    print(f"trained {args.steps} steps in {time.time()-t0:.0f}s\n")

    print(f"{'variant':26s} accuracy")
    base = None
    for name, acc in accuracy_table(CFG, state.params, pipe, device):
        base = acc if base is None else base
        print(f"{name:26s} {acc:.3f}  (delta {acc-base:+.3f})")
    print("\nExpected: SFC int8 within noise of fp32 (paper: -0.17%); "
          "Winograd degrades, especially at int6 (paper: -5.4%).")


if __name__ == "__main__":
    main()
