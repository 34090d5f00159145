"""Fault-tolerant training runner (the JAX package's
``runtime/fault_tolerance.py``): checkpoint/restart, failure injection,
straggler statistics.

  * the state is (params, optimizer state, step) only: the data pipeline
    is step-indexed (``data.pipeline``), so a resume needs no iterator
    state;
  * an asynchronous checkpoint every ``ckpt_every`` steps and at the
    last, renamed into place atomically (a crash during a save leaves
    the previous checkpoint whole);
  * ``TrainRunner.run`` restores the latest step and continues (under
    ``shardings``, (parameter, optimizer-state) trees of
    ``launch.sharding.NamedSharding``, the restored leaves are placed on
    any mesh: a run saved at one world size resumes at another); a
    ``FailureInjector`` raised at ``fail_at`` stands for a lost host, and
    a fresh runner reproduces the uninterrupted losses;
  * ``StragglerDetector`` keeps per-step wall times per host and names
    the hosts slower than ``factor`` x the median.
"""
from __future__ import annotations

import os
import tempfile
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)


class FailureInjector(Exception):
    """Raised inside the loop to stand for a host loss."""


@dataclass
class RunnerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 10
    keep: int = 3
    max_steps: int = 100


class StragglerDetector:
    """A ring buffer of per-step wall times (one per host) and the
    ``factor`` x median rule."""

    def __init__(self, window: int = 32, factor: float = 2.0):
        self.window = window
        self.factor = factor
        self.times: deque = deque(maxlen=window)

    def observe(self, per_host_seconds):
        self.times.append(np.asarray(per_host_seconds, np.float64))

    def stragglers(self) -> list[int]:
        if not self.times:
            return []
        avg = np.mean(np.stack(self.times), axis=0)
        med = np.median(avg)
        return [int(i) for i in np.nonzero(avg > self.factor * med)[0]]

    def step_stats(self) -> dict:
        if not self.times:
            return {}
        t = np.stack(self.times)
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "max_s": float(t.max())}


class TrainRunner:
    """Drives ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with checkpoint/restart.  ``init_state() -> (params,
    opt_state)`` gives the structure a restore fills (and the state of a
    fresh run); ``shardings`` (param, opt) where the restore places it."""

    def __init__(self, cfg: RunnerConfig, step_fn: Callable,
                 init_state: Callable[[], tuple], data,
                 shardings: Optional[tuple] = None,
                 fail_at: Optional[int] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.init_state = init_state
        self.data = data
        self.shardings = shardings
        self.fail_at = fail_at
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.detector = StragglerDetector()
        self.history: list[float] = []
        self.step_s: list[float] = []
        self.restore_s: Optional[float] = None

    def _restore_or_init(self):
        last = latest_step(self.cfg.ckpt_dir)
        params, opt_state = self.init_state()
        if last is None:
            return params, opt_state, 0
        t0 = time.perf_counter()
        sh = None
        if self.shardings is not None:
            sh = {"params": self.shardings[0], "opt": self.shardings[1]}
        restored, manifest = restore_checkpoint(
            self.cfg.ckpt_dir, last, {"params": params, "opt": opt_state},
            shardings=sh)
        self.restore_s = time.perf_counter() - t0
        return restored["params"], restored["opt"], int(manifest["step"])

    def run(self) -> dict:
        """-> {"final_step", "losses" (this run's), "timing" (step
        statistics), "step_s" (each step's seconds), "restore_s" (None
        without a restore), "ckpt_s" (``AsyncCheckpointer.timings``),
        "params", "opt_state" (the final state)}."""
        params, opt_state, start = self._restore_or_init()
        step = start
        while step < self.cfg.max_steps:
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            if self.fail_at is not None and step == self.fail_at:
                raise FailureInjector(f"injected failure at step {step}")
            params, opt_state, metrics = self.step_fn(
                params, opt_state,
                {k: v for k, v in batch.items() if k != "step"})
            loss = float(metrics["loss"])
            self.history.append(loss)
            dt = time.perf_counter() - t0
            self.step_s.append(dt)
            self.detector.observe([dt])
            step += 1
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.max_steps:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               meta={"loss": loss})
        self.ckpt.wait()
        return {"final_step": step, "losses": self.history,
                "timing": self.detector.step_stats(), "step_s": self.step_s,
                "restore_s": self.restore_s, "ckpt_s": self.ckpt.timings,
                "params": params,
                "opt_state": opt_state}
