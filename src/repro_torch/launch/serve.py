"""Serving launcher: continuous-batch greedy decoding loop (thin CLI).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
      --no-smoke --batch 4 --gen 32

Requests queue in, are packed into the fixed decode batch, and finished
sequences are replaced without reshaping it.  The admission, drain and
KV-wrap state machine is ``repro_torch.serve.slots.SlotLoop``, the prompt
source ``repro_torch.serve.traffic.PromptStream``; this module parses
arguments, builds the model (weights from a ``torch.Generator`` seeded 0
on the device), and feeds a greedy ``decode_step`` to the loop.
``--smoke`` (the default) runs the reduced config, ``--no-smoke`` the full
architecture; ``--device`` is ``cuda`` unless the caller says ``cpu``.
Every family of the zoo serves.  The vision and audio front ends are
stubs, as in the JAX launcher: a vlm attends to zero vision embeddings
(batch, ``n_vision_tokens``, d_model), an encdec encodes zero frames
(batch, ``max_len``, d_model).  ``serve`` runs the loop for a config the
caller has made (``main`` for the one the arguments name).

Conv-bearing architectures (the ssm and hybrid families) warm the
ConvSpec-keyed serving cache (``repro_torch.api.serving_cache``) before
traffic is admitted (``warm_conv_plans``).
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import serve_spmd
from repro_torch.distributed.sharding import Sharded
from repro_torch.models import ssm, transformer
from repro_torch.models.registry import build
from repro_torch.serve import PromptStream, SlotLoop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced smoke config (--no-smoke: full config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-min", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    return ap.parse_args(argv)


def resolve_config(args: argparse.Namespace):
    return get_smoke_config(args.arch) if args.smoke else get_config(args.arch)


def warm_conv_plans(cfg, params, batch: int, seq: int) -> Dict[str, int]:
    """Resolve every conv layer's plan and prepared weights through the
    serving cache, at a (batch, seq) input; returns the cache's stats.

    The token-by-token decode loop runs the ring-buffer conv and never
    plans, so the warm moves the per-layer planning and SFC weight
    transform to startup, where a failure (a missing algorithm, a bad
    spec) surfaces before traffic is admitted; its entries serve a
    forward (prefill) of that shape.  It walks the compute copy of the
    tree (``transformer.cast_compute``), the weights a forward reads:
    unstacked (R, C) leaves by their identity, the layers of a stacked
    (L, R, C) leaf by ``ssm.conv_cache_key``, the key the forward's layer
    loop looks them up by.  Warming twice prepares nothing new.
    """
    from repro_torch.api import ConvSpec, serving_cache
    algo = "auto" if getattr(cfg, "use_sfc_conv", False) else "direct"
    params = transformer.cast_compute(params, cfg)
    for path, leaf in tree_util.flatten_with_path(params):
        if path[-1] != "conv_w" or not isinstance(leaf, torch.Tensor):
            continue
        convs = [(None, leaf)] if leaf.dim() == 2 else \
            [(ssm.conv_cache_key(path, i, leaf), leaf[i])
             for i in range(leaf.shape[0])]
        for key, w in convs:
            spec = ConvSpec.for_conv1d_depthwise((batch, seq, w.shape[1]),
                                                 w.shape)
            serving_cache.get(spec, w, algo=algo, key=key)
    return serving_cache.stats()


class GreedyStep:
    """One greedy decode step over every slot: the ``SlotLoop``'s
    ``step_fn``.  ``logits`` runs the step on the device and leaves the
    result there (over placed parameters a ``Sharded``, its vocab blocks
    where they were computed); calling the object also takes the argmax
    (by vocab block where the logits lie, ``serve_spmd.greedy``) to the
    host."""

    def __init__(self, model, params, cache, device):
        self.model, self.params, self.cache = model, params, cache
        self.device = torch.device(device)

    def logits(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    tok, pos)
        return logits

    def __call__(self, tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        logits = self.logits(torch.from_numpy(tok).to(self.device),
                             torch.from_numpy(pos).to(self.device))
        if isinstance(logits, Sharded):
            return serve_spmd.greedy(logits).gather("cpu")[:, 0].numpy()
        return logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()


def stub_memory(cfg, batch: int, max_len: int,
                device) -> Optional[torch.Tensor]:
    """The stub front end's output: zero vision embeddings (vlm), zero
    encoder frames (encdec), else None."""
    if cfg.family == "vlm":
        return torch.zeros((batch, cfg.n_vision_tokens, cfg.d_model),
                           dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        return torch.zeros((batch, max_len, cfg.d_model),
                           dtype=torch.float32, device=device)
    return None


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    return serve(resolve_config(args), args)


def serve(cfg, args: argparse.Namespace):
    """Serve ``args.requests`` requests of ``cfg`` (weights from a
    generator seeded 0 on ``args.device``) and print the summary."""
    model = build(cfg)
    device = torch.device(args.device)
    with torch.no_grad():
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device=device)
        prompts = PromptStream(cfg.vocab_size,
                               lengths=(args.prompt_min, args.prompt_max),
                               seed=args.seed)
        cache_stats = warm_conv_plans(cfg, params, args.batch, args.max_len)
        if cache_stats["size"]:
            print(f"conv serving cache warmed: {cache_stats}")
        memory = stub_memory(cfg, args.batch, args.max_len, device)
        step = GreedyStep(model, params,
                          model.init_cache(params, args.batch, args.max_len,
                                           memory),
                          device)
        loop = SlotLoop(batch=args.batch, gen=args.gen, max_len=args.max_len,
                        requests=args.requests, prompts=prompts)
        stats = loop.run(step)
    lat = stats.latency_ms
    print(f"served {stats.served} requests in {stats.elapsed_s:.1f}s "
          f"({stats.steps} steps, {stats.tok_per_s:.0f} tok/s on "
          f"{device.type}; {stats.wrapped} KV-wrapped; "
          f"request latency p50={lat.percentile(50):.0f}ms "
          f"p99={lat.percentile(99):.0f}ms)")
    if cache_stats["size"]:
        from repro_torch.api import serving_cache
        print(f"conv_cache,{serving_cache.stats()}")
    return stats


if __name__ == "__main__":
    main()
