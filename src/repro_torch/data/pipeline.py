"""Deterministic synthetic data pipelines (offline container — no datasets).

Production-shaped: host-sharded (each host materializes only its slice of
the global batch), seeded/stateless (batch i is a pure function of (seed,
i) so restarts and elastic rescales reproduce the stream), with background
prefetch.  Token streams follow a Zipf unigram + Markov bigram mixture so
models actually have structure to learn (losses fall; used by the
end-to-end examples and convergence tests).

A copy of the JAX package's module (pure numpy, line for line): batches
are numpy arrays, byte for byte the JAX package's, and the caller moves
them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    zipf_a: float = 1.2
    markov_weight: float = 0.5      # fraction of tokens from bigram chain


class SyntheticTokenPipeline:
    """batch(i) -> {'tokens': (B_host, S), 'labels': (B_host, S)} int32."""

    def __init__(self, cfg: TokenPipelineConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.host_count
        rng = np.random.RandomState(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._unigram = (ranks ** -cfg.zipf_a)
        self._unigram /= self._unigram.sum()
        # sparse deterministic bigram successor table
        self._succ = rng.randint(0, V, size=(V, 4))

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + index * 65_537 + cfg.host_index)
            % (2 ** 31))
        B, S, V = self.host_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.randint(0, V, size=B)
        uni = rng.choice(V, size=(B, S), p=self._unigram)
        use_markov = rng.rand(B, S) < cfg.markov_weight
        pick = rng.randint(0, self._succ.shape[1], size=(B, S))
        for t in range(S):
            succ = self._succ[toks[:, t], pick[:, t]]
            toks[:, t + 1] = np.where(use_markov[:, t], succ, uni[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


@dataclasses.dataclass(frozen=True)
class ImagePipelineConfig:
    image_size: int
    n_classes: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class SyntheticImagePipeline:
    """Class-conditional structured images (learnable, CNN benchmarks).

    Each class is a fixed random low-frequency template; samples are
    template + noise, so accuracy above chance is meaningful and PTQ
    degradation is measurable.
    """

    def __init__(self, cfg: ImagePipelineConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.host_count
        rng = np.random.RandomState(cfg.seed)
        s = cfg.image_size
        base = rng.randn(cfg.n_classes, s // 4 + 1, s // 4 + 1, 3)
        templates = np.stack([
            np.kron(base[c], np.ones((4, 4, 1)))[:s, :s, :]
            for c in range(cfg.n_classes)])
        self._templates = (templates /
                           np.abs(templates).max()).astype(np.float32)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + index * 65_537 + cfg.host_index)
            % (2 ** 31))
        B = self.host_batch
        labels = rng.randint(0, cfg.n_classes, size=B)
        imgs = self._templates[labels] + \
            0.35 * rng.randn(B, cfg.image_size, cfg.image_size, 3
                             ).astype(np.float32)
        return {"images": imgs.astype(np.float32),
                "labels": labels.astype(np.int32)}

    def __iter__(self):
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class Prefetcher:
    """Background-thread prefetch (bounded queue) around any pipeline."""

    def __init__(self, pipeline, depth: int = 2, start_index: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            i = start_index
            while not self._stop.is_set():
                try:
                    self._q.put(pipeline.batch(i), timeout=0.5)
                    i += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
