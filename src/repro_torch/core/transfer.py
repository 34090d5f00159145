"""PIPO data-transfer suite (paper §3.3 + Appendix A), ported.

  * blockwise transfer   — disk reads move in fixed-size blocks;
  * multi-thread parallel transfer — several reader threads each own a
    chunk of the block stream, keeping the NVMe queue full;
  * data merging         — all weight tensors of a layer are stored as ONE
    contiguous buffer + manifest, so a layer is one I/O request and one
    host->device copy.

Merged buffers and manifests are byte-identical to the JAX package's
(``merge_tensors`` works on numpy arrays, sorted by name), so the link
bytes a trace records are the same in both.

The link probe (the reference's suite, with its signatures and an
explicit ``device``): ``naive_disk_to_host`` (one read), the parallel
``blockwise_disk_to_host``, ``host_to_device`` (a pinned buffer to the
card, synchronized), ``pipelined_disk_to_device`` (blockwise reads
overlapped with staged copies of the finished blocks on a side stream,
the Fig. 3 timeline) and ``sweep_block_size`` (Appendix A).
"""
from __future__ import annotations

import contextlib
import math
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.offload import DiskStore, as_tensor
from repro_torch.device import resolve_device
from repro_torch.quant.int4 import GROUP, dequantize_int4, quantize_int4

DEFAULT_BLOCK = 8 * 2**20          # 8MB disk blocks (paper Appendix A)


# ---------------------------------------------------------------------------
# Data merging
# ---------------------------------------------------------------------------

@dataclass
class Manifest:
    """Layout of tensors merged into one flat uint8 buffer."""
    entries: Dict[str, tuple]       # name -> (offset, shape, numpy dtype)
    total_bytes: int


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a)


def merge_tensors(tensors: Dict[str, object]) -> tuple[np.ndarray, Manifest]:
    """Flatten a unit's tensors (sorted by name) into one contiguous
    uint8 buffer + manifest, so one layer is ONE I/O request (§3.3)."""
    arrays = {name: _numpy(a) for name, a in sorted(tensors.items())}
    entries, off = {}, 0
    for name, a in arrays.items():
        entries[name] = (off, a.shape, a.dtype)
        off += a.nbytes
    buf = np.empty(off, np.uint8)
    for name, a in arrays.items():
        o = entries[name][0]
        buf[o:o + a.nbytes] = a.view(np.uint8).reshape(-1)
    return buf, Manifest(entries, off)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def split_views(buf: torch.Tensor, manifest: Manifest) -> Dict[str, torch.Tensor]:
    """Views back out of a merged uint8 tensor (inverse of
    merge_tensors), on the buffer's device.  Zero-copy wherever the
    entry's offset is aligned to its element size (always, for the
    engines' units); a misaligned entry is copied out."""
    out = {}
    for name, (off, shape, dtype) in manifest.entries.items():
        itemsize = np.dtype(dtype).itemsize
        n = int(np.prod(shape)) * itemsize
        raw = buf[off:off + n]
        if off % itemsize:
            raw = raw.clone()
        out[name] = raw.view(_torch_dtype(dtype)).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# INT4 streaming (paper §3.4: W4 weights quarter the transfer bytes)
# ---------------------------------------------------------------------------

QUANT_MIN_GROUP = 16


def int4_group(arr) -> Optional[int]:
    """The groupwise-quantization group size for one tensor, or None if
    the tensor streams unquantized: 2-D, an even number of columns, and
    a contraction dim whose gcd with 128 is at least 16."""
    shape = tuple(getattr(arr, "shape", ()))
    if len(shape) != 2 or shape[1] % 2 != 0:
        return None
    g = math.gcd(int(shape[0]), GROUP)
    return g if g >= QUANT_MIN_GROUP else None


def quantize_unit(tensors: Dict[str, object], device="cpu"
                  ) -> Dict[str, np.ndarray]:
    """Quantize a unit's eligible tensors to packed INT4 (``int4_group``):
    each eligible ``name`` becomes ``name#q`` (packed uint8, half the
    columns) and ``name#s`` (groupwise f32 scales); the rest pass
    through.  Quantizes on ``device`` (bit-identical to the CPU result)
    and returns numpy arrays.  Build time, main thread."""
    out = {}
    for name, arr in tensors.items():
        g = int4_group(arr)
        if g is None:
            out[name] = _numpy(arr)
            continue
        packed, scale = quantize_int4(
            torch.as_tensor(arr).to(device, torch.float32), g)
        out[name + "#q"] = packed.cpu().numpy()
        out[name + "#s"] = scale.cpu().numpy()
    return out


def int4_roundtrip(arr):
    """One tensor through the INT4 codec the offloaded engines stream
    (``int4_group``): the resident INT4 reference whose tokens the INT4
    offloaded engines must match.  Ineligible tensors come back
    unchanged.  A numpy array comes back as one; a tensor as a tensor on
    its device (the codec is bit-identical on the card and the CPU)."""
    g = int4_group(arr)
    if g is None:
        return arr
    if isinstance(arr, torch.Tensor):
        packed, scale = quantize_int4(arr.to(torch.float32), g)
        return dequantize_int4(packed, scale, torch.float32, g)
    packed, scale = quantize_int4(torch.from_numpy(
        np.asarray(arr, np.float32)), g)
    return dequantize_int4(packed, scale, torch.float32, g).numpy()


# ---------------------------------------------------------------------------
# Transfers
# ---------------------------------------------------------------------------


@dataclass
class SimLink:
    """Fixed-bandwidth interconnect model shared by every transfer that
    crosses the offload boundary (weights and KV hold the same
    instance).  ``floor(nbytes, t0)`` sleeps out the remainder of
    ``nbytes / bw`` seconds since ``t0``; ``bw=None`` disables it."""

    bw: Optional[float] = None

    def floor(self, nbytes: int, t0: float):
        if self.bw:
            remain = nbytes / self.bw - (time.perf_counter() - t0)
            if remain > 0:
                time.sleep(remain)


class TieredWeightStore:
    """Merged-buffer weight tiering for ``core.engine.PipelinedLM``.

    ``put`` merges a unit's tensors into ONE contiguous buffer + manifest
    on the placement tier (device/host/disk); ``fetch`` moves it to the
    device with one copy on the calling thread's current stream (a
    transfer worker's stream in the pipeline) and ``split`` cuts the
    named views out of it (``load`` does both).  INT4
    units: with ``fused_int4`` the ``name#q``/``name#s`` pairs stay packed
    on the device and the unit functions hand them to ``int4_matmul``;
    without it they are dequantized here, on the transfer thread, as the
    JAX package does.  Link bytes are the packed bytes either way."""

    def __init__(self, *, placement: str, host, device, disk,
                 quant: Optional[str] = None, fused_int4: bool = True,
                 block_bytes: int = DEFAULT_BLOCK, n_io_threads: int = 3,
                 cold_reads: bool = False, sim_bw: Optional[float] = None):
        if placement not in ("device", "host", "disk"):
            raise ValueError(f"placement {placement!r}")
        self.placement = placement
        self.host, self.device, self.disk = host, device, disk
        self.quant = quant
        self.fused_int4 = fused_int4
        self.block_bytes = block_bytes
        self.n_io_threads = n_io_threads
        self.cold_reads = cold_reads
        self.link = SimLink(sim_bw)
        self.manifests: Dict[str, Manifest] = {}
        # fetches per key (each a link crossing): the MoE routed-union
        # invariant (union bytes < the whole bank's) is read from these
        self.load_counts: Dict[str, int] = {}

    def put(self, key: str, tensors: Dict[str, object]):
        """Merge + place a unit's tensors on the placement tier (main
        thread, once at engine build)."""
        buf, man = merge_tensors(tensors)
        self.manifests[key] = man
        if self.placement == "disk":
            self.disk.put(key, buf)
        elif self.placement == "host":
            self.host.put(key, buf)
        else:
            self.device.put(key, buf)

    def nbytes(self, key: str) -> int:
        """Bytes one load() of ``key`` moves over the link (packed bytes
        for INT4 units)."""
        return self.manifests[key].total_bytes

    @property
    def sim_bw(self) -> Optional[float]:
        return self.link.bw

    def sim_floor(self, nbytes: int, t0: float):
        """Sleep out the remainder of ``nbytes / sim_bw`` seconds since
        ``t0`` (the shared ``SimLink``)."""
        self.link.floor(nbytes, t0)

    def fetch(self, key: str) -> torch.Tensor:
        """Placement tier -> the unit's merged buffer on the device: one
        copy, on the calling thread's current stream (a transfer
        worker's, whose pool waits for it before the task completes)."""
        t0 = time.perf_counter()
        self.load_counts[key] = self.load_counts.get(key, 0) + 1
        dev = self.device.device
        if self.placement == "device":
            buf = self.device.get(key)
        elif self.placement == "host":
            buf = self.host.get(key).to(dev, non_blocking=True)
        else:
            if self.cold_reads:
                self.disk.drop_cache(key)
            host_buf = blockwise_disk_to_host(
                self.disk, key, block_bytes=self.block_bytes,
                n_threads=self.n_io_threads)
            buf = torch.from_numpy(host_buf.view(np.uint8).reshape(-1)).to(dev)
        self.sim_floor(self.manifests[key].total_bytes, t0)
        return buf

    def split(self, key: str, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A fetched buffer -> the unit's named tensors (views; unfused
        INT4 pairs dequantized)."""
        return self._maybe_dequant(split_views(buf, self.manifests[key]))

    def load(self, key: str) -> Dict[str, torch.Tensor]:
        """``fetch`` then ``split``: the unit's tensors on the device."""
        return self.split(key, self.fetch(key))

    def _maybe_dequant(self, views):
        """Unfused INT4 baseline: dequantize ``#q``/``#s`` pairs on the
        transfer thread after the packed bytes crossed.  The fused path
        (and fp32) returns the views as they are."""
        if self.quant != "int4" or self.fused_int4:
            return views
        out = {}
        for name, arr in views.items():
            if name.endswith("#q"):
                base = name[:-2]
                scale = views[base + "#s"]
                g = arr.shape[0] // scale.shape[0]
                out[base] = dequantize_int4(arr, scale, torch.float32, g)
            elif not name.endswith("#s"):
                out[name] = arr
        return out


def blockwise_disk_to_host(disk: DiskStore, key: str,
                           block_bytes: int = DEFAULT_BLOCK,
                           n_threads: int = 3,
                           out: Optional[np.ndarray] = None) -> np.ndarray:
    """Parallel blockwise read into a preallocated host buffer."""
    shape, dtype = disk.meta(key)
    total = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if out is None:
        out = np.empty(total, np.uint8)
    blocks = [(o, min(block_bytes, total - o))
              for o in range(0, total, block_bytes)]
    if len(blocks) <= 1 or n_threads <= 1:
        disk.read_range(key, 0, total, out)
        return out.view(dtype).reshape(shape)
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        list(ex.map(lambda b: disk.read_range(key, b[0], b[1], out), blocks))
    return out.view(dtype).reshape(shape)


def naive_disk_to_host(disk: DiskStore, key: str) -> np.ndarray:
    """Baseline: one read of the whole file (the ``torch.load`` analogue)."""
    return disk.get(key)


def host_to_device(arr, device="cuda") -> torch.Tensor:
    """``arr`` (a numpy array or a host tensor) copied to ``device``
    from a pinned buffer, synchronized before it returns (the card unless
    the caller asks for the CPU, where it is a copy)."""
    dev = resolve_device(device)
    src = as_tensor(arr)
    if dev.type == "cuda" and not src.is_pinned():
        src = src.pin_memory()
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    out.copy_(src, non_blocking=dev.type == "cuda")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def pipelined_disk_to_device(disk: DiskStore, key: str,
                             block_bytes: int = DEFAULT_BLOCK,
                             n_threads: int = 3,
                             device="cuda") -> torch.Tensor:
    """The whole suite: blockwise reads on ``n_threads`` threads into a
    pinned host buffer, each finished block copied on to ``device`` on a
    side stream while later blocks are still being read (Fig. 3), then
    one synchronize.  Returns the key's array on ``device``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    shape, dtype = disk.meta(key)
    total = int(np.prod(shape)) * np.dtype(dtype).itemsize
    host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
    host_np = host.numpy()
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    blocks = [(o, min(block_bytes, total - o))
              for o in range(0, total, block_bytes)]

    def read_block(b):
        disk.read_range(key, b[0], b[1], host_np)
        return b

    stream = torch.cuda.Stream(dev) if cuda else None
    with ThreadPoolExecutor(max_workers=max(1, n_threads)) as ex:
        futs = [ex.submit(read_block, b) for b in blocks]
        with (torch.cuda.stream(stream) if cuda
              else contextlib.nullcontext()):
            for fut in as_completed(futs):
                o, n = fut.result()      # overlap: copy while reads go on
                out[o:o + n].copy_(host[o:o + n], non_blocking=cuda)
    if cuda:
        stream.synchronize()
    return out.view(_torch_dtype(dtype)).reshape(shape)


def sweep_block_size(disk: DiskStore, key: str, sizes=None,
                     n_threads: int = 3, repeats: int = 2):
    """Appendix A: [(block bytes, bytes/s)] of ``blockwise_disk_to_host``
    at each block size, the best of ``repeats`` reads each."""
    sizes = sizes or [1 * 2**20, 2 * 2**20, 4 * 2**20, 8 * 2**20,
                      16 * 2**20, 32 * 2**20, 64 * 2**20]
    shape, dtype = disk.meta(key)
    total = int(np.prod(shape)) * np.dtype(dtype).itemsize
    out = []
    for bs in sizes:
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            blockwise_disk_to_host(disk, key, block_bytes=bs,
                                   n_threads=n_threads)
            ts.append(time.perf_counter() - t0)
        out.append((bs, total / min(ts)))
    return out
