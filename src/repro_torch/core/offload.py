"""Memory-tier stores for offloading: Disk (files), Host (pinned CPU
tensors), Device (tensors on the card).

The port of the JAX package's ``core/offload.py``.  ``HostStore`` keeps
page-locked buffers when the engine runs on a CUDA device, so a
host->device copy is one asynchronous DMA on a transfer worker's stream.
``DeviceStore`` puts tensors on an explicit device.  Every store tracks
bytes for the memory-footprint stats.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def as_tensor(arr) -> torch.Tensor:
    """numpy array or tensor -> tensor (no copy for a contiguous,
    writable array; a read-only one is copied)."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


class Store:
    name = "base"

    def __init__(self):
        self._items: Dict[str, object] = {}
        self._bytes = 0
        self._peak = 0
        self._lock = threading.Lock()

    def _account(self, delta: int):
        with self._lock:
            self._bytes += delta
            self._peak = max(self._peak, self._bytes)

    @property
    def peak_bytes(self) -> int:
        return self._peak

    def delete(self, key: str):
        item = self._items.pop(key, None)
        if item is not None:
            self._account(-self._nbytes(item))

    @staticmethod
    def _nbytes(x) -> int:
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return int(getattr(x, "nbytes", 0))


class HostStore(Store):
    """CPU-memory tier: contiguous CPU tensors, page-locked when
    ``pin`` (the engine sets it when its device is a card)."""

    name = "host"

    def __init__(self, pin: bool = False):
        super().__init__()
        self.pin = pin

    def put(self, key: str, arr) -> torch.Tensor:
        src = as_tensor(arr)
        t = torch.empty(src.shape, dtype=src.dtype, pin_memory=self.pin)
        t.copy_(src)
        if key in self._items:
            self.delete(key)
        self._items[key] = t
        self._account(self._nbytes(t))
        return t

    def get(self, key: str) -> torch.Tensor:
        return self._items[key]


class DeviceStore(Store):
    """Device (HBM) tier: tensors on ``device`` (CUDA unless the caller
    passes "cpu"; raises without a card)."""

    name = "device"

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)

    def put(self, key: str, arr) -> torch.Tensor:
        t = as_tensor(arr).to(self.device)
        if key in self._items:
            self.delete(key)
        self._items[key] = t
        self._account(self._nbytes(t))
        return t

    def get(self, key: str) -> torch.Tensor:
        return self._items[key]


class DiskStore(Store):
    """NVMe tier: one file per tensor under ``root``; reads go through
    plain file reads into preallocated buffers."""

    name = "disk"

    def __init__(self, root: str):
        super().__init__()
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._meta: Dict[str, tuple] = {}

    def _path(self, key: str) -> Path:
        return self.root / (key.replace("/", "_") + ".bin")

    def put(self, key: str, arr):
        arr = np.ascontiguousarray(
            arr.numpy() if isinstance(arr, torch.Tensor) else arr)
        path = self._path(key)
        arr.tofile(path)
        self._meta[key] = (arr.shape, arr.dtype)
        self._items[key] = path
        self._account(arr.nbytes)
        return path

    def meta(self, key: str):
        return self._meta[key]

    def get(self, key: str) -> np.ndarray:
        shape, dtype = self._meta[key]
        return np.fromfile(self._path(key), dtype=dtype).reshape(shape)

    def read_range(self, key: str, offset_bytes: int, size_bytes: int,
                   out: np.ndarray):
        """Read a byte range into a preallocated buffer (blockwise path)."""
        with open(self._path(key), "rb", buffering=0) as f:
            f.seek(offset_bytes)
            data = f.read(size_bytes)
        flat = out.reshape(-1).view(np.uint8)
        flat[offset_bytes:offset_bytes + len(data)] = np.frombuffer(
            data, np.uint8)
        return len(data)

    def drop_cache(self, key: str) -> bool:
        """Evict the file from the OS page cache (POSIX_FADV_DONTNEED) so
        reads measure the disk, not memcpy."""
        try:
            with open(self._path(key), "rb") as f:
                os.fsync(f.fileno())
                os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)
            return True
        except (OSError, AttributeError):
            return False


@dataclass
class MemoryBudget:
    """Tier capacities for plan resolution (bytes)."""
    device: int = 6 * 2**30        # paper laptop: RTX3060 6GB
    host: int = 16 * 2**30         # 16GB DRAM
    disk: int = 1 * 2**40          # 1TB SSD
    device_bw: float = 12e9        # PCIe x8-ish GPU link (B/s)
    disk_bw: float = 3.5e9         # NVMe read bw (B/s)
