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
    background thread, keeping the newest ``keep`` checkpoints; a write
    that fails raises at the next ``save`` or ``wait``;
  * sharded: a DTensor leaf (``launch.sharding.place``) is saved as its
    whole logical value, gathered on every rank; rank 0 writes and the
    other ranks wait for it (one barrier), so the files are those of an
    unsharded save;
  * elastic: ``restore_checkpoint(..., shardings=...)`` places each
    leaf under any mesh (a tree of ``launch.sharding.NamedSharding``),
    whatever the mesh it was saved from; a DTensor target leaf keeps its
    own mesh and placements.
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


def _whole(leaf):
    """A DTensor gathered to its whole value (collective: every rank
    calls it); any other leaf as it is."""
    full = getattr(leaf, "full_tensor", None)
    return full() if full is not None else leaf


def _sharded(tree) -> bool:
    return any(hasattr(leaf, "full_tensor")
               for _, leaf in flatten_with_path(tree))


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


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
    """Write ``tree`` (tensors or numpy leaves) as ``ckpt_dir/step_K``.
    With DTensor leaves every rank calls it: the leaves are gathered,
    rank 0 writes, the others wait."""
    if _sharded(tree):
        tree = tree_map(_whole, tree)
        if _writer():
            _write(ckpt_dir, step, tree, meta)
        _barrier()
        return str(Path(ckpt_dir) / f"step_{step}")
    return _write(ckpt_dir, step, tree, meta)


def _write(ckpt_dir, step: int, tree: Any, meta: Optional[dict]) -> str:
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
                       device=None, shardings: Any = None) -> tuple[Any, dict]:
    """Restore ``ckpt_dir/step_K`` into the structure of ``target_tree``
    (tensors, DTensors, ``param_struct``'s meta tensors, or arrays): each
    leaf by its path, at its saved dtype and the target's shape, on
    ``device`` (by default the target leaf's, or the CPU for a meta or
    numpy target).  ``shardings``: a matching tree of
    ``launch.sharding.NamedSharding`` (None leaves: unplaced) under
    which each leaf is placed, the elastic path; without it a DTensor
    target leaf is placed as it is.  Returns (tree, manifest)."""
    d = Path(ckpt_dir) / f"step_{step}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    flat = flatten_with_path(target_tree)
    saved = {e["path"]: e for e in manifest["leaves"]}
    if len(saved) != len(flat):
        raise ValueError(f"checkpoint holds {len(saved)} leaves, the "
                         f"target {len(flat)}")
    shard_leaves = (None if shardings is None else
                    [sh for _, sh in flatten_with_path(shardings)])
    out = []
    for i, (key, leaf) in enumerate(flat):
        e = saved.get(key)
        if e is None:
            raise KeyError(f"missing leaf {key} in checkpoint")
        t = _load(d / e["file"], e)
        want = tuple(leaf.shape)
        if tuple(t.shape) != want:
            raise ValueError(f"{key}: saved shape {tuple(t.shape)}, "
                             f"target {want}")
        sharding = _sharding_of(leaf, None if shard_leaves is None
                                else shard_leaves[i])
        if sharding is not None:
            from repro_torch.launch.sharding import place_leaf
            out.append(place_leaf(t, sharding))
            continue
        dev = device
        if dev is None:
            dev = (leaf.device if isinstance(leaf, torch.Tensor)
                   and leaf.device.type != "meta" else "cpu")
        out.append(t.to(dev))
    return unflatten(target_tree, out), manifest


def _sharding_of(leaf, given):
    """The ``NamedSharding`` a restored leaf goes under: the one given,
    else a DTensor target's own, else None."""
    if given is not None:
        return given
    pl = getattr(leaf, "placements", None)
    if pl is None:
        return None
    from repro_torch.launch.sharding import NamedSharding
    from repro_torch.models.common import Dist
    mesh = leaf.device_mesh
    return NamedSharding(mesh, Dist(mesh=mesh).spec_of(pl, leaf.ndim))


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
        self._sharded = False
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        """Snapshot ``tree`` and write it in the background.  With DTensor
        leaves every rank calls it: each gathers the whole leaves, rank 0
        writes, and every rank's next ``wait`` meets the others' after
        the write."""
        t0 = time.perf_counter()
        sharded = _sharded(tree)
        host_tree = tree_map(
            lambda t: _whole(t).detach().to("cpu", copy=True)
            if isinstance(t, torch.Tensor) else np.array(t), tree)
        timing = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.wait()
        self._sharded = sharded
        if sharded and not _writer():
            with self._lock:
                self.last_saved = step
            return

        def work():
            try:
                t1 = time.perf_counter()
                save_checkpoint(str(self.ckpt_dir), step, host_tree,
                                meta=meta)
                timing["write_s"] = time.perf_counter() - t1
                with self._lock:
                    self.last_saved = step
                    self.timings.append(timing)
                self._gc()
            except BaseException as e:     # raised by the next ``wait``
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Wait for the write in flight; a write that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.ckpt_dir.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s}", ignore_errors=True)
