"""Fault-tolerant training loop.

Production behaviors, all exercised by tests:
  * **checkpoint/restart**: periodic async checkpoints; on (re)start the
    trainer resumes from the latest valid snapshot and replays the data
    stream deterministically from the restored step;
  * **step-failure containment**: transient failures (preemption,
    injected faults, a non-finite loss) roll back to the last checkpoint
    and continue; repeated failures abort;
  * **straggler mitigation**: per-step wall times feed an EWMA; steps slower
    than ``straggler_factor`` x EWMA are counted (on real fleets this
    signal drives hot-spare swaps; here it drives the report so the policy
    is testable).

The step runs where the parameters are: ``device`` (the card unless the
caller asks for the CPU) and the caller's batches, which
``batches(step)`` puts there.  With ``state_shardings``
(``distributed.lm_spmd.state_shardings`` over ``mesh``) the state is
drawn onto the mesh (the generator on ``device``), restored onto it, and
stepped by the sharded step; ``restore_elastic`` re-shards the latest
checkpoint onto other shardings, from a template of shapes alone.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.optim.optimizers import AdamW
from repro_torch.train.steps import (TrainState, abstract_train_state,
                                     init_train_state, make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "/tmp/repro_torch_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    max_retries: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    grad_compression: bool = False
    microbatches: int = 1


class TransientError(RuntimeError):
    """Raised by failure injectors / preemption signals."""


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    step_times: List[float] = dataclasses.field(default_factory=list)


class Trainer:
    def __init__(self, model, optimizer: AdamW, cfg: TrainerConfig,
                 mesh=None, state_shardings=None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.mesh = mesh
        self.state_shardings = state_shardings
        self.device = device
        self.fault_hook = fault_hook          # tests inject failures here
        self.ckpt = Checkpointer(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
        self._step_fn = make_train_step(
            model, optimizer, grad_compression=cfg.grad_compression,
            microbatches=cfg.microbatches)

    # ------------------------------------------------------------------
    def init_or_restore(self, seed: int) -> tuple[TrainState, int]:
        if self.state_shardings is not None \
                and self.ckpt.latest_step() is not None:
            return self.ckpt.restore(
                abstract_train_state(self.model, self.optimizer),
                shardings=self.state_shardings)
        state = init_train_state(self.model, self.optimizer, seed,
                                 self.device, self.state_shardings)
        if self.ckpt.latest_step() is not None:
            return self.ckpt.restore(state)
        return state, 0

    def restore_elastic(self, seed: int, new_shardings
                        ) -> tuple[TrainState, int]:
        """Re-shard the latest checkpoint onto other shardings (another
        mesh); the template is the state's shapes alone, nothing is
        drawn.  ``seed`` is the JAX package's key, unused here."""
        return self.ckpt.restore(
            abstract_train_state(self.model, self.optimizer),
            shardings=new_shardings)

    # ------------------------------------------------------------------
    def run(self, batches: Callable[[int], Dict[str, Any]], seed: int
            ) -> TrainerReport:
        report = TrainerReport()
        state, step = self.init_or_restore(seed)
        retries = 0
        ewma: Optional[float] = None
        while step < self.cfg.total_steps:
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)     # may raise TransientError
                batch = batches(step)
                state, metrics = self._step_fn(state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise TransientError(f"non-finite loss at step {step}")
            except TransientError as e:
                retries += 1
                report.restarts += 1
                if retries > self.cfg.max_retries:
                    raise RuntimeError(
                        f"giving up after {retries} retries: {e}") from e
                self.ckpt.wait()
                state, step = self.init_or_restore(seed)
                continue
            retries = 0
            dt = time.perf_counter() - t0
            report.step_times.append(dt)
            if ewma is not None and dt > self.cfg.straggler_factor * ewma:
                report.stragglers += 1
            ewma = dt if ewma is None else \
                (1 - self.cfg.ewma_alpha) * ewma + self.cfg.ewma_alpha * dt
            report.losses.append(loss)
            report.steps_run += 1
            step += 1
            if step % self.cfg.checkpoint_every == 0 or \
                    step == self.cfg.total_steps:
                self.ckpt.save(step, state)
            if step % self.cfg.log_every == 0:
                print(f"step {step:6d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
        self.ckpt.wait()
        return report
