"""The training loop: checkpoint / restart, failure injection, immune
scheduling (PyTorch port of ``repro/train/trainer.py``).

Fault-tolerance contract, as in the JAX package:
  * auto-resume: on start, the trainer restores the newest valid checkpoint
    and continues from its step — a killed run resumes bitwise-identically
    (the data pipeline is a pure function of the step counter, and every
    op on the training path is deterministic run to run)
  * crash-safety: checkpoints are atomic (see ``dist.checkpoint``); a
    failure mid-save falls back to the previous step
  * failure injection: ``failure_at`` raises mid-run to simulate a node loss
  * the immune scheduler tracks per-worker throughput and is checkpointed
    next to the train state (under ``sched/``), so anergy verdicts and shard
    fractions survive a restart: a restored run resumes the paper's anergy
    -> checkpoint-restore -> revival loop. ``heartbeats`` injects the
    fleet's per-worker throughput; by default every worker reports the
    measured local step rate.

Checkpoints hold the state in the JAX package's layout
(``train_step.state_tree``), so either package resumes the other's run.
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..core import router as irouter
from ..core import scheduler as ischeduler
from ..data import pipeline
from ..dist import checkpoint as ckpt
from . import train_step as ts

log = logging.getLogger(__name__)

_SCHED_SUBDIR = "sched"


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


@dataclass
class Trainer:
    cfg: ModelConfig
    tcfg: TrainConfig
    workdir: str
    batch: int = 8
    seq: int = 64
    ckpt_every: int = 50
    log_every: int = 10
    keep: Optional[int] = None             # checkpoint retention (None = all)
    rcfg: irouter.RouterConfig = field(default_factory=irouter.RouterConfig)
    scfg: ischeduler.SchedulerConfig = field(
        default_factory=ischeduler.SchedulerConfig)
    failure_at: Optional[int] = None       # simulate a node loss at this step
    num_workers: Optional[int] = None      # fleet size (default: world size)
    # (step, local_throughput) -> (num_workers,) observed per-worker
    # throughput; 0 entries are missed heartbeats (anergy candidates)
    heartbeats: Optional[Callable[[int, float], np.ndarray]] = None
    on_metrics: Optional[Callable] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.num_workers is None:
            self.num_workers = _world_size()
        self.scheduler = ischeduler.init_scheduler(self.num_workers,
                                                   self.device)
        self.history: list[dict] = []

    def init_or_restore(self) -> tuple[ts.TrainState, int]:
        """Newest valid checkpoint (with its scheduler state), else a fresh
        init from ``tcfg.seed``. Returns ``(state, step)``; the step is the
        checkpoint's label, which must agree with the ``state.step`` leaf it
        stored (on a disagreement the leaf wins, with a warning)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        state = ts.init_train_state(gen, self.cfg, self.tcfg,
                                    device=self.device)
        restored, step = ckpt.restore(self.workdir,
                                      ts.state_tree(state, self.cfg))
        if restored is None:
            return state, 0
        state = ts.load_state_tree(state, restored, self.cfg)
        if int(state.step) != step:
            log.warning("checkpoint dir says step %d but state.step is %d; "
                        "resuming from the state leaf", step, int(state.step))
            step = int(state.step)
        # the scheduler snapshot of the train state's step, failing that the
        # newest one not newer: stale anergy memory beats amnesia
        for s in [step] + [x for x in reversed(ckpt.all_steps(
                self._sched_dir())) if x < step]:
            sched, _ = ckpt.restore(self._sched_dir(), self.scheduler, step=s)
            if sched is not None:
                self.scheduler = sched
                break
        return state, step

    def _sched_dir(self) -> str:
        return os.path.join(self.workdir, _SCHED_SUBDIR)

    def _checkpoint(self, state: ts.TrainState, step: int) -> None:
        ckpt.save(self.workdir, ts.state_tree(state, self.cfg), step,
                  keep=self.keep)
        ckpt.save(self._sched_dir(), self.scheduler, step, keep=self.keep)

    def worker_fracs(self) -> np.ndarray:
        """Current per-worker shard fractions (drives per-host microbatch
        sizing)."""
        return self.scheduler.frac.cpu().numpy()

    def train(self, num_steps: int) -> ts.TrainState:
        state, start = self.init_or_restore()
        data_state = pipeline.DataState(
            step=torch.tensor(start, dtype=torch.int32, device=self.device))
        for step in range(start, num_steps):
            if self.failure_at is not None and step == self.failure_at:
                raise RuntimeError(f"injected node failure at step {step}")
            t0 = time.perf_counter()
            batch, data_state = pipeline.sample_batch(self.cfg, self.batch,
                                                      self.seq, data_state)
            state, metrics = ts.train_step(state, batch, self.cfg, self.tcfg,
                                           self.rcfg)
            dt = time.perf_counter() - t0
            local_tput = 1.0 / max(dt, 1e-9)
            hb = (self.heartbeats(step, local_tput)
                  if self.heartbeats is not None
                  else np.full((self.num_workers,), local_tput, np.float32))
            self.scheduler = ischeduler.observe(self.scheduler, hb, self.scfg)

            if step % self.log_every == 0 or step == num_steps - 1:
                rec = {"step": step, "loss": float(metrics.loss),
                       "grad_norm": float(metrics.grad_norm),
                       "lr": float(metrics.lr),
                       "load_cv": float(metrics.load_cv),
                       "drop_frac": float(metrics.drop_frac),
                       "anergic_workers": int(self.scheduler.anergic.sum()),
                       "sec_per_step": dt}
                self.history.append(rec)
                if self.on_metrics:
                    self.on_metrics(rec)
            if (step + 1) % self.ckpt_every == 0 or step == num_steps - 1:
                self._checkpoint(state, step + 1)
        return state
