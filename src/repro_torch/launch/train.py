"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --steps 50 --batch 2 --seq 2048

``--smoke`` selects the reduced config; without it the full config is
used.  ``--device`` is ``cuda`` unless the caller says ``cpu`` (the smoke
configs run there: ``--smoke --device cpu``), and it raises without a card.
The launcher wires: config -> model -> data pipeline
(``SyntheticTokenPipeline``) -> AdamW on a cosine schedule -> the
fault-tolerant ``Trainer`` (checkpoints, auto-resume, straggler count).
The vision and audio front ends are stubs, as in the JAX launcher: a vlm
trains on zero vision embeddings (batch, ``n_vision_tokens``, d_model), an
encdec on zero frames (batch, seq, d_model).  Weights are drawn from a
``torch.Generator`` seeded ``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import SyntheticTokenPipeline, TokenPipelineConfig
from repro_torch.models.registry import build
from repro_torch.optim.optimizers import AdamW, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def token_batches(cfg, batch: int, seq: int, device):
    """``batches(step)`` for the Trainer: the synthetic token stream's
    batch ``step`` on ``device``, with the stub front end's zeros."""
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))

    def batches(step: int):
        b = pipe.batch(step)
        out = {"tokens": torch.from_numpy(b["tokens"]).to(device),
               "labels": torch.from_numpy(b["labels"]).to(device)}
        if cfg.family == "vlm":
            out["vision"] = torch.zeros(
                (batch, cfg.n_vision_tokens, cfg.d_model),
                dtype=torch.float32, device=device)
        if cfg.family == "encdec":
            out["frames"] = torch.zeros((batch, seq, cfg.d_model),
                                        dtype=torch.float32, device=device)
        return out
    return batches


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 20, 1),
                                   total=args.steps))
    trainer = Trainer(model, opt, TrainerConfig(
        total_steps=args.steps,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression,
    ), device=device)
    report = trainer.run(token_batches(cfg, args.batch, args.seq, device),
                         args.seed)
    first = np.mean(report.losses[:5])
    last = np.mean(report.losses[-5:])
    print(f"\ndone: {report.steps_run} steps on {device.type}, loss "
          f"{first:.3f} -> {last:.3f}, restarts={report.restarts} "
          f"stragglers={report.stragglers}")
    return report


if __name__ == "__main__":
    main()
