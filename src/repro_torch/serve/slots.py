"""Fixed-batch decode slot loop (continuous batching for the LM path).

The host-side bookkeeping behind ``repro_torch.launch.serve``: a fixed decode
batch of ``batch`` slots, each slot consuming its prompt then generating
``gen`` tokens; finished sequences are swapped for queued requests
*without reshaping the batch* (static shapes), subject to an admission budget
(``requests`` total — surplus slots idle/drain), with a KV safety wrap
when a sequence hits the cache length (``max_len``).

Extracted from the launcher so the admission/drain/wrap state machine is
deterministic and testable without a model: ``run`` takes any
``step_fn(tok, pos) -> next_tokens`` (the launcher passes a greedy
``decode_step``; tests pass a pure-numpy stub).  All timing uses
``time.perf_counter`` and per-request completion latency lands in a
streaming histogram.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.metrics import LatencyHistogram
from repro_torch.serve.traffic import PromptStream


@dataclasses.dataclass
class SlotLoopStats:
    """What one slot-loop run produced and how fast."""

    served: int = 0                 # completed requests (incl. truncated)
    wrapped: int = 0                # requests truncated by the KV wrap
    steps: int = 0                  # decode_step invocations
    tokens: int = 0                 # tokens pushed through active slots
    elapsed_s: float = 0.0
    latency_ms: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def summary(self) -> Dict:
        return {"served": self.served, "wrapped": self.wrapped,
                "steps": self.steps, "tokens": self.tokens,
                "elapsed_s": self.elapsed_s, "tok_per_s": self.tok_per_s,
                "request_latency_ms": self.latency_ms.summary()}


class SlotLoop:
    """The serve launcher's continuous-batching state machine.

    Semantics (locked by tests/test_torch_serve_slots.py):

      * the initial fill admits ``min(batch, requests)`` prompts — the
        admission budget bounds total work, surplus slots idle from the
        start;
      * a slot first consumes its prompt token-by-token, then generates
        from ``step_fn``'s predictions until its ``gen`` budget is spent;
      * on completion the slot swaps in a new prompt only while the
        budget allows, otherwise the slot *drains* (goes inactive);
      * a slot whose position reaches ``max_len - 1`` hits the KV-cache
        safety wrap: the truncated request still counts as served, and a
        replacement is admitted under the same budget as the normal
        completion path.
    """

    def __init__(self, *, batch: int, gen: int, max_len: int,
                 requests: int, prompts: PromptStream,
                 clock: Callable[[], float] = time.perf_counter):
        if batch < 1 or gen < 1 or max_len < 2 or requests < 1:
            raise ValueError(
                f"need batch/gen/requests >= 1 and max_len >= 2: "
                f"batch={batch} gen={gen} max_len={max_len} "
                f"requests={requests}")
        self.batch, self.gen = batch, gen
        self.max_len, self.requests = max_len, requests
        self.prompts, self.clock = prompts, clock

    def run(self, step_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
            max_steps: Optional[int] = None) -> SlotLoopStats:
        """Serve ``requests`` prompts through ``step_fn``; returns stats.

        ``step_fn(tok (B, 1) int32, pos (B,) int32) -> (B,) int32`` is
        one decode step over ALL slots (inactive slots included — the
        batch shape is static); the loop ignores predictions for slots
        still consuming their prompt.  ``max_steps`` is a safety bound
        for tests (None = run to completion).
        """
        B = self.batch
        stats = SlotLoopStats()
        prompts: List[List[int]] = [self.prompts.next_prompt()
                                    for _ in range(B)]
        pos = np.zeros(B, np.int32)
        remaining = np.full(B, self.gen, np.int32)
        tok = np.array([[p[0]] for p in prompts], np.int32)
        started = min(B, self.requests)
        active = np.arange(B) < started
        admit_t = np.full(B, self.clock(), np.float64)
        done = 0
        t0 = self.clock()

        def finish(i: int) -> None:
            nonlocal done
            done += 1
            stats.latency_ms.record((self.clock() - admit_t[i]) * 1e3)

        def admit(i: int) -> bool:
            nonlocal started
            if started >= self.requests:
                return False
            prompts[i] = self.prompts.next_prompt()
            pos[i] = 0
            remaining[i] = self.gen
            tok[i, 0] = prompts[i][0]
            admit_t[i] = self.clock()
            started += 1
            return True

        while done < self.requests:
            if max_steps is not None and stats.steps >= max_steps:
                break
            nxt = np.asarray(step_fn(tok, pos), np.int32)
            stats.steps += 1
            for i in range(B):
                if not active[i]:              # drained slot: budget hit
                    continue
                stats.tokens += 1
                pos[i] += 1
                if pos[i] < len(prompts[i]):   # still consuming prompt
                    tok[i, 0] = prompts[i][pos[i]]
                elif remaining[i] > 0:         # generating
                    tok[i, 0] = nxt[i]
                    remaining[i] -= 1
                else:                          # finished -> swap or drain
                    finish(i)
                    if not admit(i):
                        active[i] = False
                if active[i] and pos[i] >= self.max_len - 1:
                    # safety wrap: the sequence hit the KV budget — the
                    # truncated request counts, and a replacement is
                    # admitted only within the same budget as the normal
                    # completion path above
                    stats.wrapped += 1
                    finish(i)
                    if not admit(i):
                        active[i] = False
        stats.served = done
        stats.elapsed_s = self.clock() - t0
        return stats
