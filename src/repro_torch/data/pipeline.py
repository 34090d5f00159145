"""Tokenized training data (the JAX package's ``data/pipeline.py``; the
port keeps its own copy and imports nothing of the JAX package).

Per-host slicing (each host builds only its rows of the global batch),
deterministic step-indexed sampling (a resume needs no iterator state:
the checkpoint stores only the step) and a background prefetch thread
that keeps ``prefetch`` batches ready while the device computes.  Batches
are numpy; the train step moves them to the device.

Sources: ``SyntheticSource`` (a zipf-like token stream seeded by step
and row) and ``MemmapSource`` (a flat int32 token file read through
``np.memmap``).  Both draw exactly the reference's numbers.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32000
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2
    seed: int = 0


def _rng(cfg: DataConfig, step: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 65_537 + index)


class SyntheticSource:
    """Deterministic pseudo-corpus: step- and row-seeded zipf(1.3)
    tokens, clipped to the vocabulary."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def sample(self, step: int, index: int) -> np.ndarray:
        cfg = self.cfg
        z = _rng(cfg, step, index).zipf(1.3, size=cfg.seq_len + 1)
        return np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)


class MemmapSource:
    """A flat int32 token file; windows at step- and row-seeded
    offsets."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        if len(self.tokens) <= cfg.seq_len + 1:
            raise ValueError(f"corpus of {len(self.tokens)} tokens is too "
                             f"small for windows of {cfg.seq_len + 1}")

    @staticmethod
    def write_corpus(path: str, tokens: np.ndarray):
        np.asarray(tokens, np.int32).tofile(path)

    def sample(self, step: int, index: int) -> np.ndarray:
        cfg = self.cfg
        off = int(_rng(cfg, step, index).integers(
            0, len(self.tokens) - cfg.seq_len - 1))
        return np.asarray(self.tokens[off:off + cfg.seq_len + 1], np.int32)


class DataPipeline:
    """Host-local ``{"tokens", "labels", "step"}`` batches, by step
    (``batch_at``) or in order with a prefetch thread (``start``,
    ``next``)."""

    def __init__(self, source, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.host_count} hosts")
        self.source = source
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_step = 0

    def _make(self, step: int) -> dict:
        cfg = self.cfg
        arr = np.stack([
            self.source.sample(step, cfg.host_index * self.local_batch + i)
            for i in range(self.local_batch)])
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:], "step": step}

    def start(self, from_step: int = 0):
        self._next_step = from_step
        self._stop.clear()

        def loop():
            s = from_step
            while not self._stop.is_set():
                try:
                    self._q.put(self._make(s), timeout=0.1)
                    s += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __next__(self) -> dict:
        if self._thread is None:
            b = self._make(self._next_step)
            self._next_step += 1
            return b
        return self._q.get()

    def batch_at(self, step: int) -> dict:
        """Random access by step (a resume's batches)."""
        return self._make(step)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
