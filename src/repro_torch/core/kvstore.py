"""Tiered KV store: host-resident decode cache with live-row loads and
optional INT4 row packing.

The port of the JAX package's ``core/kvstore.py``.  ``load(j, live_b,
live_len)`` moves only the occupied rows over the link (slots
``0..live_b-1``, positions ``0..live_len-1``) with one asynchronous
host->device copy per slot and array, on the calling transfer worker's
stream, from page-locked host tensors.  (One strided copy per leaf
measured slower on the H100 host: PyTorch stages a non-contiguous pinned
source through a pageable temporary; PERF.md, Findings.)  ``load_nbytes``
prices exactly the bytes that cross, which is what ``Task.nbytes``
records on KV_LOAD trace events.

The device slab a load returns is zero beyond the live rows and holds
``KV_LEN_BUCKET``-rounded room for the rows the decode step writes (its
own row, or a speculative verify pass's k+1): the caching allocator then
sees one slab size per 32 positions instead of a new size every step,
and the attention kernels read only rows ``<= pos``.  The reference
returns the full ``max_len`` slab; the rows between are zeros either
way, so the values attended are the same, and the link still carries
only the live rows.

``kv_mode="int4"``: sequence-extent rows are stored packed — each
``(slot, position)`` row group-quantized over its flattened ``F``
features (groups of ``gcd(F, 32)``, two nibbles per byte along adjacent
features, f32 group scales), bit for bit the reference's codec.  Rows
are cast to the leaf's compute dtype and quantized once, on the host,
when saved.  A load ships the live packed bytes and scales and returns
them PACKED (``PackedRows``): the decode step hands them to the
``decode_attention_int4`` kernel, which dequantizes in registers.  The
reference dequantizes here instead, on the transfer thread; the port has
no such pass on any device (the plain version dequantizes inside the
attention op on the CPU).  ``dequant_bytes_total`` therefore counts what
the reference counts — compute-precision bytes of the live extent per
load — but in the port those bytes are only ever unpacked in the
kernel's registers, never written to memory.

Thread affinity: construction runs on the main thread at engine build;
``load``/``save_*``/``spill``/``restore`` run on transfer-pool threads.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["TieredKVStore", "PhasedKVExtents", "PackedRows", "KV_GROUP",
           "KV_LEN_BUCKET", "kv_group", "kv_eligible", "quantize_kv_rows",
           "dequantize_kv_rows", "kv_roundtrip_rows", "assign_rows"]

KV_GROUP = 32
KV_LEN_BUCKET = 32


# ---------------------------------------------------------------------------
# INT4 row codec (the reference's, bit for bit)
# ---------------------------------------------------------------------------

def kv_group(n_features: int) -> int:
    """Group size for one cache row of ``n_features`` values."""
    return math.gcd(int(n_features), KV_GROUP)


def kv_eligible(kind: str, feat_shape: Sequence[int]) -> bool:
    """Whether a cache leaf quantizes under ``kv_mode='int4'``: only
    sequence-extent (kind ``'kv'``) rows with an even flattened feature
    count (nibble pairs)."""
    f = int(np.prod(feat_shape)) if len(feat_shape) else 1
    return kind == "kv" and f % 2 == 0 and f >= 2


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


_INV7 = float(np.float32(1.0 / 7.0))


def _quantize_rows(x: torch.Tensor, group: int):
    """x (..., F) f32 -> (packed (..., F//2) uint8, scale (..., F//g) f32).
    Symmetric groupwise over the trailing features, round half to even;
    feature 2i is the low nibble of byte i, feature 2i+1 the high one.
    The scale is max|x| times the f32 reciprocal of 7: the reference
    writes ``/ 7.0`` inside a jit, which XLA compiles to that product."""
    *lead, F = x.shape
    xg = x.reshape(*lead, F // group, group)
    scale = torch.clamp_min(xg.abs().amax(dim=-1) * _INV7, 1e-8)
    q = torch.round(xg / scale[..., None]).to(torch.int32)
    q = torch.clamp(q, -8, 7).reshape(*lead, F)
    qu = (q + 8).to(torch.uint8)
    return qu[..., 0::2] | (qu[..., 1::2] << 4), scale


def _dequant_impl(packed: torch.Tensor, scale: torch.Tensor, group: int):
    """Inverse of ``_quantize_rows`` -> (..., F) f32."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = ((packed >> 4) & 0xF).to(torch.int32) - 8
    *lead, F2 = packed.shape
    q = torch.stack([lo, hi], dim=-1).reshape(*lead, F2 * 2)
    w = (q.reshape(*lead, (F2 * 2) // group, group).to(torch.float32)
         * scale[..., None])
    return w.reshape(*lead, F2 * 2)


def quantize_kv_rows(x, group: Optional[int] = None):
    """Quantize cache rows (..., F) -> (packed, scale) tensors on ``x``'s
    device.  Takes a tensor or a numpy array."""
    x = torch.as_tensor(x).to(torch.float32)
    g = group or kv_group(x.shape[-1])
    return _quantize_rows(x, g)


def dequantize_kv_rows(packed, scale, group: int, dtype=torch.bfloat16):
    """Inverse of ``quantize_kv_rows`` -> (..., F) of ``dtype`` (the
    cache's compute precision)."""
    return _dequant_impl(torch.as_tensor(packed), torch.as_tensor(scale),
                         group).to(dtype)


def kv_roundtrip_rows(x, group: Optional[int] = None):
    """quantize -> dequantize rows, cast back to the input dtype."""
    x = torch.as_tensor(x)
    g = group or kv_group(x.shape[-1])
    packed, scale = quantize_kv_rows(x, g)
    return dequantize_kv_rows(packed, scale, g, x.dtype)


def assign_rows(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst[...] = src`` (cast to ``dst``'s dtype) under numpy's
    assignment rule, which the reference's stores follow: ``src``
    broadcasts to ``dst``'s shape or the assignment raises
    ``ValueError``.  So an SSM prefill of one token, whose halo has one
    row for the cache's ``d_conv - 1``, fills every halo row with it, and
    one of two tokens raises (ROADMAP Queue 3 item 17)."""
    try:
        fits = torch.broadcast_shapes(tuple(src.shape),
                                      tuple(dst.shape)) == dst.shape
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"could not broadcast input array from shape "
                         f"{tuple(src.shape)} into shape {tuple(dst.shape)}")
    dst.copy_(src)


class PackedRows(NamedTuple):
    """A packed KV leaf as a load returns it: ``(b, S, F//2)`` uint8 and
    ``(b, S, F//group)`` f32 scales on the device, the rows' compute
    dtype (what a dequantized value rounds to before use) and their
    feature shape."""
    packed: torch.Tensor
    scale: torch.Tensor
    group: int
    dtype: torch.dtype
    feat: Tuple[int, ...]

    def dequantize(self) -> torch.Tensor:
        """(b, S, *feat) at the compute dtype (the plain path)."""
        b, S = self.packed.shape[:2]
        return _dequant_impl(self.packed, self.scale, self.group).reshape(
            (b, S) + self.feat).to(self.dtype)


@dataclass
class _LeafMeta:
    """Per-leaf layout (``leaf_meta`` keeps it public for tests and byte
    accounting)."""
    kind: str                 # cache kind ("kv"/"rep"/...)
    feat: Tuple[int, ...]     # trailing feature shape after (b[, L])
    dtype: torch.dtype        # compute-precision dtype of the leaf
    quant: bool = False       # stored packed INT4
    group: int = 0            # quant group over the flattened features

    @property
    def itemsize(self) -> int:
        return torch.empty(0, dtype=self.dtype).element_size()


@dataclass
class _QuantLeaf:
    packed: torch.Tensor      # (b, L, F//2) uint8, host
    scale: torch.Tensor       # (b, L, F//g) f32, host
    group: int


class TieredKVStore:
    """Host-resident decode cache with live-row loads and optional INT4
    row packing (module docstring).

    ``unit_shapes``/``unit_kinds``: one dict per schedulable unit, name ->
    ((b_max, [max_len,] *feat) shape, numpy or torch dtype) / name ->
    cache kind (``"kv"`` for sequence-extent leaves).  ``link`` is a
    ``transfer.SimLink`` shared with the weight store.  ``device`` is
    where loads land (CUDA unless the caller passes "cpu"; raises without
    a card); ``pin`` page-locks the host tensors."""

    def __init__(self, unit_shapes: List[Dict[str, tuple]],
                 unit_kinds: List[Dict[str, str]], *, b_max: int,
                 max_len: int, kv_mode: str = "fp32", link=None,
                 device="cuda", pin: bool = False):
        if kv_mode not in ("fp32", "int4"):
            raise ValueError(f"kv_mode {kv_mode!r}")
        self.b_max = b_max
        self.max_len = max_len
        self.kv_mode = kv_mode
        self.link = link
        self.device = resolve_device(device)
        self.kinds: List[Dict[str, str]] = [dict(k) for k in unit_kinds]
        self.dequant_bytes_total = 0
        self._units: List[Dict[str, Any]] = []
        self._meta: List[Dict[str, _LeafMeta]] = []
        zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, pin_memory=pin)
        for shapes, kinds in zip(unit_shapes, unit_kinds):
            leaves, meta = {}, {}
            for name, (shape, dtype) in shapes.items():
                kind = kinds[name]
                feat = tuple(shape[2:]) if kind == "kv" else tuple(shape[1:])
                m = _LeafMeta(kind, feat, _torch_dtype(dtype))
                if kv_mode == "int4" and kv_eligible(kind, feat):
                    F = int(np.prod(feat))
                    m.quant, m.group = True, kv_group(F)
                    leaves[name] = _QuantLeaf(
                        zeros((shape[0], shape[1], F // 2), torch.uint8),
                        zeros((shape[0], shape[1], F // m.group),
                              torch.float32), m.group)
                else:
                    leaves[name] = zeros(shape, m.dtype)
                meta[name] = m
            self._units.append(leaves)
            self._meta.append(meta)

    # ---- layout introspection ----------------------------------------------
    def __len__(self):
        return len(self._units)

    def leaf_meta(self, j: int) -> Dict[str, _LeafMeta]:
        return self._meta[j]

    def has_kv(self, j: int) -> bool:
        return bool(self.kinds[j])

    def _arrays(self, j: int, name: str):
        leaf = self._units[j][name]
        if isinstance(leaf, _QuantLeaf):
            return (leaf.packed, leaf.scale)
        return (leaf,)

    # ---- byte accounting (any thread; non-blocking) ------------------------
    def _extent(self, live_b, live_len):
        lb = self.b_max if live_b is None else min(int(live_b), self.b_max)
        ll = self.max_len if live_len is None else min(int(live_len),
                                                      self.max_len)
        return lb, ll

    def load_nbytes(self, j: int, live_b: Optional[int] = None,
                    live_len: Optional[int] = None) -> int:
        """Bytes one ``load(j, live_b, live_len)`` moves over the link —
        exactly the sliced rows (packed bytes and scales for INT4
        leaves)."""
        lb, ll = self._extent(live_b, live_len)
        total = 0
        for name, m in self._meta[j].items():
            for a in self._arrays(j, name):
                shape = list(a.shape)
                shape[0] = lb
                if m.kind == "kv":
                    shape[1] = ll
                total += int(np.prod(shape)) * a.element_size()
        return total

    def slab_nbytes(self, j: int) -> int:
        """Bytes the full ``(b_max, max_len)`` slab would move."""
        return self.load_nbytes(j, self.b_max, self.max_len)

    def save_nbytes(self, j: int, live_b: Optional[int] = None,
                    rows: int = 1) -> int:
        """Bytes one decode ``save_decode`` payload moves device->host:
        ``rows`` fresh rows of ``live_b`` slots at compute precision
        (quantization happens at the host tier)."""
        lb, _ = self._extent(live_b, None)
        total = 0
        for m in self._meta[j].values():
            row = int(np.prod(m.feat)) * m.itemsize
            if m.kind == "kv":
                row *= max(1, int(rows))
            total += lb * row
        return total

    def prefill_save_nbytes(self, j: int, live_b: int = 1,
                            length: Optional[int] = None) -> int:
        """Bytes a prefill save moves, priced as the reference prices it:
        ``live_b`` slots' rows at compute precision, ``length`` positions
        each for kv kinds (default the full per-slot extent, the serving
        engine's admission payload)."""
        ll = self.max_len if length is None else min(int(length),
                                                     self.max_len)
        total = 0
        for m in self._meta[j].values():
            n = int(np.prod(m.feat)) * m.itemsize
            if m.kind == "kv":
                n *= ll
            total += n
        return total * max(1, int(live_b))

    def dequant_nbytes(self, j: int, live_b: Optional[int] = None,
                       live_len: Optional[int] = None) -> int:
        """Compute-precision bytes of the INT4 rows one load carries
        (0 in fp32 mode); see the module docstring for where the port
        unpacks them."""
        lb, ll = self._extent(live_b, live_len)
        return sum(lb * ll * int(np.prod(m.feat)) * m.itemsize
                   for m in self._meta[j].values() if m.quant)

    def max_live_load_nbytes(self, live_b: int, live_len: int) -> int:
        """Largest per-unit live KV_LOAD payload at the given extents."""
        return max((self.load_nbytes(j, live_b, live_len)
                    for j in range(len(self._units))), default=0)

    def host_nbytes(self) -> int:
        """Total host bytes the store holds (packed bytes under INT4)."""
        return sum(a.numel() * a.element_size()
                   for j in range(len(self._units))
                   for name in self._units[j] for a in self._arrays(j, name))

    # ---- loads (transfer-pool thread) --------------------------------------
    def _bucket_len(self, ll: int) -> int:
        """``ll`` rounded up to ``KV_LEN_BUCKET``, clamped to the slab."""
        return min(self.max_len,
                   -(-int(ll) // KV_LEN_BUCKET) * KV_LEN_BUCKET)

    def _ship(self, arr: torch.Tensor, lb: int, ll: int, seq: bool,
              rows: int = 1):
        """Live rows of one host array -> a zeroed device slab of
        ``(b_max, bucket(ll + rows), ...)`` (sequence leaves) or the full
        per-slot shape."""
        if seq:
            cap = self._bucket_len(ll + rows)
            dev = torch.zeros((arr.shape[0], cap) + tuple(arr.shape[2:]),
                              dtype=arr.dtype, device=self.device)
            for s in range(lb):
                dev[s, :ll].copy_(arr[s, :ll], non_blocking=True)
        else:
            dev = torch.zeros(arr.shape, dtype=arr.dtype, device=self.device)
            dev[:lb].copy_(arr[:lb], non_blocking=True)
        return dev

    def load(self, j: int, live_b: Optional[int] = None,
             live_len: Optional[int] = None, rows: int = 1
             ) -> Dict[str, Any]:
        """KV_LOAD body: live host rows -> device slabs with room for the
        ``rows`` per slot the step writes past ``live_len``; INT4 leaves
        come back as ``PackedRows``.  Pays the link floor on exactly the
        live bytes."""
        t0 = time.perf_counter()
        lb = self.b_max if live_b is None else \
            max(1, min(int(live_b), self.b_max))
        ll = self.max_len if live_len is None else \
            max(1, min(int(live_len), self.max_len))
        out: Dict[str, Any] = {}
        for name, m in self._meta[j].items():
            leaf = self._units[j][name]
            seq = m.kind == "kv"
            if isinstance(leaf, _QuantLeaf):
                out[name] = PackedRows(
                    self._ship(leaf.packed, lb, ll, True, rows),
                    self._ship(leaf.scale, lb, ll, True, rows),
                    leaf.group, m.dtype, m.feat)
                self.dequant_bytes_total += lb * ll \
                    * int(np.prod(m.feat)) * m.itemsize
            else:
                out[name] = self._ship(leaf, lb, ll, seq, rows)
        if self.link is not None:
            self.link.floor(self.load_nbytes(j, lb, ll), t0)
        return out

    # ---- saves (transfer-pool thread) --------------------------------------
    def _quant_into(self, leaf: _QuantLeaf, m: _LeafMeta, rows: torch.Tensor):
        """Cast rows (..., *feat) to the leaf's compute dtype FIRST (the
        reference quantizes the cast cache rows), then quantize them."""
        lead = rows.shape[:rows.ndim - len(m.feat)]
        flat = rows.to(m.dtype).reshape(*lead, -1)
        return _quantize_rows(flat.to(torch.float32), leaf.group)

    def save_prefill(self, j: int, slot: int,
                     rows: Dict[str, torch.Tensor]) -> None:
        """Scatter one slot's freshly-prefilled rows (name -> ``(n,
        *feat)`` for kv kinds, n <= max_len; per-slot state otherwise).
        Positions ``n..`` become zeros, as the reference's zero-padded
        full-extent payload leaves them; INT4 leaves quantize that whole
        extent once, so the packed bytes equal the reference's."""
        for name, m in self._meta[j].items():
            leaf = self._units[j][name]
            row = rows[name].to("cpu")
            if m.kind == "kv" and row.shape[0] < self.max_len:
                full = torch.zeros((self.max_len,) + tuple(row.shape[1:]),
                                   dtype=row.dtype)
                full[:row.shape[0]] = row
                row = full
            if isinstance(leaf, _QuantLeaf):
                leaf.packed[slot], leaf.scale[slot] = self._quant_into(
                    leaf, m, row)
            else:
                assign_rows(leaf[slot], row)

    def save_prefill_batch(self, j: int, rows: Dict[str, torch.Tensor],
                           length: Optional[int] = None) -> None:
        """Scatter ALL slots' freshly-prefilled rows at once (name ->
        ``(b, length, *feat)`` for kv kinds, ``(b, *feat)`` for per-slot
        state).  Positions beyond ``length`` reset to zeros."""
        for name, m in self._meta[j].items():
            leaf = self._units[j][name]
            row = rows[name].to("cpu")
            b = row.shape[0]
            if m.kind != "kv":
                leaf[:b] = row.to(m.dtype)
                continue
            ll = row.shape[1] if length is None else int(length)
            if isinstance(leaf, _QuantLeaf):
                packed, scale = self._quant_into(leaf, m, row[:, :ll])
                leaf.packed[:b, :ll], leaf.scale[:b, :ll] = packed, scale
                leaf.packed[:b, ll:] = 0
                leaf.scale[:b, ll:] = 0
            else:
                leaf[:b, :ll] = row[:, :ll].to(m.dtype)
                leaf[:b, ll:] = 0

    def save_decode(self, j: int, rows: Dict[str, torch.Tensor],
                    active: Sequence[int], pos: np.ndarray) -> None:
        """Scatter a decode step's new rows: for kv kinds ``rows[name]``
        is ``(live_b, n, *feat)`` (slot s's ``n`` rows at positions
        ``pos[s]..pos[s]+n-1``); other kinds carry the full per-slot
        state.  One device->host copy per leaf, then a host scatter;
        INT4 leaves quantize the new rows, the only time they ever are."""
        for name, m in self._meta[j].items():
            leaf = self._units[j][name]
            row = rows[name].to("cpu")
            if isinstance(leaf, _QuantLeaf):
                packed, scale = self._quant_into(leaf, m, row)
                n = row.shape[1]
                for s in active:
                    p = int(pos[s])
                    leaf.packed[s, p:p + n] = packed[s]
                    leaf.scale[s, p:p + n] = scale[s]
            elif m.kind == "kv":
                n = row.shape[1]
                for s in active:
                    p = int(pos[s])
                    leaf[s, p:p + n] = row[s].to(m.dtype)
            else:
                for s in active:
                    leaf[s] = row[s].to(m.dtype)

    def truncate(self, slot: int, new_len: int) -> None:
        """Zero one slot's positions ``new_len..`` in every kv leaf
        (packed-INT4-safe: zero bytes under zero scales dequantize to
        zeros).  Other kinds carry no position extent."""
        nl = max(0, min(int(new_len), self.max_len))
        for j in range(len(self._units)):
            for name, m in self._meta[j].items():
                if m.kind == "kv":
                    for a in self._arrays(j, name):
                        a[slot, nl:] = 0

    # ---- slot spill/restore ------------------------------------------------
    def _spill_keys(self, ns: str, j: int, name: str):
        if isinstance(self._units[j][name], _QuantLeaf):
            return (f"{ns}/{j}/{name}#q", f"{ns}/{j}/{name}#s")
        return (f"{ns}/{j}/{name}",)

    def spill(self, host, ns: str, slot: int) -> None:
        """Copy one slot's rows into ``host`` under ``{ns}/{unit}/{name}``
        keys; INT4 rows spill packed (``...#q``/``...#s``), losslessly."""
        for j in range(len(self._units)):
            for name in self._units[j]:
                for key, a in zip(self._spill_keys(ns, j, name),
                                  self._arrays(j, name)):
                    host.put(key, a[slot])

    def restore(self, host, ns: str, slot: int) -> None:
        """Inverse of ``spill``: bring a parked request's rows back into
        ``slot``, bit for bit."""
        for j in range(len(self._units)):
            for name in self._units[j]:
                for key, a in zip(self._spill_keys(ns, j, name),
                                  self._arrays(j, name)):
                    a[slot] = host.get(key)


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

    def _kv_slab_rows(self) -> int:
        """Rows per slot a decode step may write past its live extent,
        which the loaded slab must hold: 1, or ``k + 1`` while a draft
        proposing up to ``k`` tokens is attached (``_spec_k``).  The
        largest verify pass, not the current step's ``_spec_s``: a warm
        preload may ship before the step that consumes it sets that."""
        return 1 + getattr(self, "_spec_k", 0)

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
        return self.kvstore.load(j, lb, ll, rows=self._kv_slab_rows())
