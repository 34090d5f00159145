"""Tiered KV store: host-resident decode cache with live-row loads.

The port of the JAX package's ``core/kvstore.py`` for ``kv_mode="fp32"``.
``load(j, live_b, live_len)`` moves only the occupied rows over the link
(slots ``0..live_b-1``, positions ``0..live_len-1``) with one asynchronous
host->device copy per slot and leaf, on the calling transfer worker's
stream, from page-locked host tensors.  (One strided copy per leaf
measured slower on the H100 host: PyTorch stages a non-contiguous pinned
source through a pageable temporary; PERF.md, Findings.)
``load_nbytes`` prices exactly the bytes that cross, which is what
``Task.nbytes`` records on KV_LOAD trace events.

The device slab a load returns is zero beyond the live rows and holds
``KV_LEN_BUCKET``-rounded room for the decode step's own row: the
caching allocator then sees one slab size per 32 positions instead of a
new size every step, and the attention kernels read only rows
``<= pos``.  The reference returns the full ``max_len`` slab; the rows
between are zeros either way, so the values attended are the same.

``kv_mode="int4"`` (packed rows, quantized once at save) comes with the
next slice of the port, together with ``decode_attention_int4_kernel``.

Thread affinity: construction runs on the main thread at engine build;
``load``/``save_*`` run on transfer-pool threads.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TieredKVStore", "PhasedKVExtents", "KV_LEN_BUCKET"]

KV_LEN_BUCKET = 32


class TieredKVStore:
    """Host-resident decode cache with live-row loads (fp32 rows).

    ``unit_shapes``/``unit_kinds``: one dict per schedulable unit, name ->
    ((b_max, [max_len,] *feat) shape, numpy dtype) / name -> cache kind
    (``"kv"`` for sequence-extent leaves).  ``link`` is a
    ``transfer.SimLink`` shared with the weight store.  ``device`` is
    where loads land (CUDA unless the caller passes "cpu"; raises without
    a card); ``pin`` page-locks the host tensors."""

    def __init__(self, unit_shapes: List[Dict[str, tuple]],
                 unit_kinds: List[Dict[str, str]], *, b_max: int,
                 max_len: int, kv_mode: str = "fp32", link=None,
                 device="cuda", pin: bool = False):
        if kv_mode == "int4":
            raise NotImplementedError(
                "kv_mode='int4' (packed KV rows + decode_attention_int4_"
                "kernel) comes with the next slice of the port")
        if kv_mode != "fp32":
            raise ValueError(f"kv_mode {kv_mode!r}")
        self.b_max = b_max
        self.max_len = max_len
        self.kv_mode = kv_mode
        self.link = link
        self.device = resolve_device(device)
        self.kinds: List[Dict[str, str]] = [dict(k) for k in unit_kinds]
        self._units: List[Dict[str, torch.Tensor]] = []
        self._feat: List[Dict[str, Tuple[int, ...]]] = []
        for shapes, kinds in zip(unit_shapes, unit_kinds):
            leaves, feats = {}, {}
            for name, (shape, dtype) in shapes.items():
                feats[name] = (tuple(shape[2:]) if kinds[name] == "kv"
                               else tuple(shape[1:]))
                tdt = torch.from_numpy(np.empty(0, dtype)).dtype
                leaves[name] = torch.zeros(shape, dtype=tdt, pin_memory=pin)
            self._units.append(leaves)
            self._feat.append(feats)

    # ---- byte accounting (any thread; non-blocking) ------------------------
    def load_nbytes(self, j: int, live_b: Optional[int] = None,
                    live_len: Optional[int] = None) -> int:
        """Bytes one ``load(j, live_b, live_len)`` moves over the link —
        exactly the sliced rows."""
        lb = self.b_max if live_b is None else min(int(live_b), self.b_max)
        ll = self.max_len if live_len is None else min(int(live_len),
                                                      self.max_len)
        total = 0
        for name, arr in self._units[j].items():
            shape = list(arr.shape)
            shape[0] = lb
            if self.kinds[j][name] == "kv":
                shape[1] = ll
            total += int(np.prod(shape)) * arr.element_size()
        return total

    def save_nbytes(self, j: int, live_b: Optional[int] = None,
                    rows: int = 1) -> int:
        """Bytes one decode ``save_decode`` payload moves device->host:
        ``rows`` fresh rows of ``live_b`` slots."""
        lb = self.b_max if live_b is None else min(int(live_b), self.b_max)
        total = 0
        for name, arr in self._units[j].items():
            row = int(np.prod(self._feat[j][name])) * arr.element_size()
            if self.kinds[j][name] == "kv":
                row *= max(1, int(rows))
            total += lb * row
        return total

    def prefill_save_nbytes(self, j: int, live_b: int = 1,
                            length: Optional[int] = None) -> int:
        """Bytes a prefill save moves: ``live_b`` slots' rows, ``length``
        positions each for kv kinds (default the full per-slot extent)."""
        ll = self.max_len if length is None else min(int(length),
                                                     self.max_len)
        total = 0
        for name, arr in self._units[j].items():
            n = int(np.prod(self._feat[j][name])) * arr.element_size()
            if self.kinds[j][name] == "kv":
                n *= ll
            total += n
        return total * max(1, int(live_b))

    # ---- loads (transfer-pool thread) --------------------------------------
    def _bucket_len(self, ll: int) -> int:
        """``ll`` rounded up to ``KV_LEN_BUCKET``, clamped to the slab."""
        return min(self.max_len,
                   -(-int(ll) // KV_LEN_BUCKET) * KV_LEN_BUCKET)

    def load(self, j: int, live_b: Optional[int] = None,
             live_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """KV_LOAD body: live host rows -> a zeroed device slab of
        ``(b_max, bucket(live_len + 1), *feat)`` for kv leaves (room for
        the step's own row) and the full per-slot shape otherwise.  Pays
        the link floor on exactly the live bytes."""
        t0 = time.perf_counter()
        lb = self.b_max if live_b is None else \
            max(1, min(int(live_b), self.b_max))
        ll = self.max_len if live_len is None else \
            max(1, min(int(live_len), self.max_len))
        out: Dict[str, torch.Tensor] = {}
        for name, arr in self._units[j].items():
            if self.kinds[j][name] == "kv":
                cap = self._bucket_len(ll + 1)
                dev = torch.zeros((arr.shape[0], cap) + arr.shape[2:],
                                  dtype=arr.dtype, device=self.device)
                for s in range(lb):
                    dev[s, :ll].copy_(arr[s, :ll], non_blocking=True)
            else:
                dev = torch.zeros(arr.shape, dtype=arr.dtype,
                                  device=self.device)
                dev[:lb].copy_(arr[:lb], non_blocking=True)
            out[name] = dev
        if self.link is not None:
            self.link.floor(self.load_nbytes(j, lb, ll), t0)
        return out

    # ---- saves (transfer-pool thread) --------------------------------------
    def save_prefill_batch(self, j: int, rows: Dict[str, torch.Tensor],
                           length: Optional[int] = None) -> None:
        """Scatter ALL slots' freshly-prefilled rows at once (name ->
        ``(b, length, *feat)`` for kv kinds, ``(b, *feat)`` for per-slot
        state).  Positions beyond ``length`` reset to zeros."""
        for name, arr in self._units[j].items():
            row = rows[name].to("cpu")
            b = row.shape[0]
            if self.kinds[j][name] == "kv":
                ll = row.shape[1] if length is None else int(length)
                arr[:b, :ll] = row[:, :ll]
                arr[:b, ll:] = 0
            else:
                arr[:b] = row

    def save_decode(self, j: int, rows: Dict[str, torch.Tensor],
                    active: Sequence[int], pos: np.ndarray) -> None:
        """Scatter a decode step's new rows: for kv kinds ``rows[name]``
        is ``(live_b, n, *feat)`` (slot s's ``n`` rows at positions
        ``pos[s]..pos[s]+n-1``); other kinds carry the full per-slot
        state.  One device->host copy per leaf, then a host scatter."""
        for name, arr in self._units[j].items():
            row = rows[name].to("cpu")
            if self.kinds[j][name] == "kv":
                n = row.shape[1]
                for s in active:
                    p = int(pos[s])
                    arr[s, p:p + n] = row[s]
            else:
                for s in active:
                    arr[s] = row[s]


class PhasedKVExtents:
    """Phase-aware KV hooks for the ``PipelineScheduler`` (the JAX
    package's mixin, unchanged): the host engine answers what an
    iteration is doing and what is live; the mixin derives the
    scheduler-facing ``kv_nbytes`` / ``kv_extent`` / ``kv_save_nbytes`` /
    ``load_kv``.  Pricing and shipping share the same ``_kv_live``
    extents, so trace bytes never overstate what crossed.  Host hooks::

        _kv_phase(i)   -> "prefill" | "decode" | "chunk"
        _kv_live(i)    -> (live_batch, live_len) of iteration i's load
        _kv_streams(j) -> does unit j's cache cross the link at all?
        _kv_prefill_save_nbytes(j)   whole-prompt save payload bytes
        _kv_chunk_save_nbytes(j)     in-flight chunk append bytes

    plus ``self.kvstore`` (a ``TieredKVStore``)."""

    kvstore: "TieredKVStore"

    def _kv_phase(self, i: int) -> str:
        raise NotImplementedError

    def _kv_live(self, i: int) -> Tuple[int, int]:
        raise NotImplementedError

    def _kv_streams(self, j: int) -> bool:
        raise NotImplementedError

    def _kv_prefill_save_nbytes(self, j: int) -> int:
        raise NotImplementedError

    def _kv_chunk_save_nbytes(self, j: int) -> int:
        return 0

    def _kv_save_rows(self) -> int:
        """Rows per live slot a decode save ships."""
        return getattr(self, "_spec_s", 1)

    def kv_nbytes(self, i: int, j: int) -> int:
        """Bytes iteration i's KV_LOAD of unit j moves over the link —
        the LIVE rows only, 0 outside decode."""
        if not self._kv_streams(j) or self._kv_phase(i) != "decode":
            return 0
        lb, ll = self._kv_live(i)
        return self.kvstore.load_nbytes(j, lb, ll)

    def kv_extent(self, i: int, j: int):
        """Live (batch, len) of iteration i's KV_LOAD payload (None
        outside decode)."""
        if not self._kv_streams(j) or self._kv_phase(i) != "decode":
            return None
        return self._kv_live(i)

    def kv_save_nbytes(self, i: int, j: int) -> int:
        """Bytes iteration i's KV_SAVE payload moves device->host."""
        if not self._kv_streams(j):
            return 0
        phase = self._kv_phase(i)
        if phase == "prefill":
            return self._kv_prefill_save_nbytes(j)
        n = self._kv_chunk_save_nbytes(j)
        if phase == "decode":
            lb, _ = self._kv_live(i)
            n += self.kvstore.save_nbytes(j, lb, rows=self._kv_save_rows())
        return n

    def load_kv(self, i: int, j: int):
        """KV_LOAD body (transfer-pool thread): live host rows -> device
        slab via the tiered store.  None outside decode."""
        if not self._kv_streams(j) or self._kv_phase(i) != "decode":
            return None
        lb, ll = self._kv_live(i)
        return self.kvstore.load(j, lb, ll)
