"""Checkpoints in the JAX package's on-disk format (its
``checkpoint/ckpt.py``): one ``leaf_i.npy`` per leaf and a JSON
manifest, so a checkpoint written by either package restores in the
other.

  * atomic: a save lands in ``step_K.tmp`` and is renamed to ``step_K``
    only after the manifest is fsync'd, so a crash mid-save never
    corrupts the latest checkpoint;
  * leaves in ``jax.tree_util`` order, each under its path
    (``params/pat/0/wq``, ``opt/step``; ``repro_torch.tree``), with its
    shape and dtype name in the manifest; restore matches by path;
  * bf16 (which numpy cannot name without ``ml_dtypes``) is stored as its
    raw bytes, a ``uint8`` array whose last dim is doubled, beside the
    dtype name ``bfloat16``; the port views the bytes as
    ``torch.bfloat16`` itself;
  * ``AsyncCheckpointer`` snapshots every leaf to host memory on the
    caller's thread, before the next step can touch it, and writes on a
    background thread, keeping the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, tree_map, unflatten

_TORCH = {"bfloat16": torch.bfloat16}      # dtypes stored as raw bytes


def _to_numpy(leaf):
    """(array to save, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.reshape(t.shape or (1,)).view(torch.uint8).numpy(),
                    "bfloat16")
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    meta: Optional[dict] = None) -> str:
    """Write ``tree`` (tensors or numpy leaves) as ``ckpt_dir/step_K``."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names = []
    for i, (key, leaf) in enumerate(flatten_with_path(tree)):
        arr, dtype = _to_numpy(leaf)
        shape = list(leaf.shape)
        np.save(tmp / f"leaf_{i}.npy", arr)
        names.append({"path": key, "file": f"leaf_{i}.npy",
                      "shape": shape, "dtype": dtype})
    manifest = {"step": step, "leaves": names, "time": time.time(),
                **(meta or {})}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return str(final)


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _load(path: Path, entry: dict) -> torch.Tensor:
    arr = np.load(path)
    name = entry["dtype"]
    if name in _TORCH:
        t = torch.from_numpy(arr).view(_TORCH[name])
    else:
        t = torch.from_numpy(arr.view(np.dtype(name)))
    return t.reshape(entry["shape"])


def restore_checkpoint(ckpt_dir: str, step: int, target_tree: Any, *,
                       device=None) -> tuple[Any, dict]:
    """Restore ``ckpt_dir/step_K`` into the structure of ``target_tree``
    (tensors, ``param_struct``'s meta tensors, or arrays): each leaf by
    its path, at its saved dtype and the target's shape, on ``device``
    (by default the target leaf's, or the CPU for a meta or numpy
    target).  Returns (tree, manifest)."""
    d = Path(ckpt_dir) / f"step_{step}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    flat = flatten_with_path(target_tree)
    saved = {e["path"]: e for e in manifest["leaves"]}
    if len(saved) != len(flat):
        raise ValueError(f"checkpoint holds {len(saved)} leaves, the "
                         f"target {len(flat)}")
    out = []
    for key, leaf in flat:
        e = saved.get(key)
        if e is None:
            raise KeyError(f"missing leaf {key} in checkpoint")
        t = _load(d / e["file"], e)
        want = tuple(leaf.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: saved shape {tuple(t.shape)}, "
                             f"target {want}")
        dev = device
        if dev is None:
            dev = (leaf.device if isinstance(leaf, torch.Tensor)
                   and leaf.device.type != "meta" else "cpu")
        out.append(t.to(dev))
    return unflatten(target_tree, out), manifest


class AsyncCheckpointer:
    """Non-blocking saves: snapshot on the caller's thread, write on a
    background thread; at most one write in flight (a newer request
    waits for it).  ``timings`` holds each save's step and seconds:
    ``snapshot_s`` on the caller's thread, ``write_s`` on the writer's."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.last_saved: Optional[int] = None
        self.timings: list = []

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        t0 = time.perf_counter()
        host_tree = tree_map(
            lambda t: t.detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else np.array(t), tree)
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.wait()

        def work():
            t1 = time.perf_counter()
            save_checkpoint(str(self.ckpt_dir), step, host_tree, meta=meta)
            timing["write_s"] = time.perf_counter() - t1
            with self._lock:
                self.last_saved = step
                self.timings.append(timing)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.ckpt_dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s}", ignore_errors=True)
