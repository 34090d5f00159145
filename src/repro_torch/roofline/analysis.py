"""Static roofline of one step of the port, counted on meta tensors.

``analyze_step(fn, *args)`` runs the step once on meta tensors at one
device's local shapes (the dry run's ``AbstractDTensor`` blocks, or
plain meta tensors at ``Dist.local()``) under three counters, the eager
counterparts of the JAX package's HLO parser:

  * operations: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
    batched matmuls, convolutions and attention, backward included);
  * HBM bytes: a ``TorchDispatchMode`` that charges each aten op its
    inputs' and outputs' bytes once (a tensor read twice by one op
    counts once; an expanded input its storage), skipping pure views and
    allocations: the eager form of "a fusion reads its operands and
    writes its output once";
  * link bytes: the collectives an ``AbstractMesh`` records
    (``models.common.COLL_RECORD``), priced with the ring factors of
    ``_collective_bytes``; a group of more than ``HW.cards_per_node``
    ranks goes over the NICs.

A kernel op handed meta tensors reports its kernel's own operations and
bytes (``kernels.cost``) and traces nothing, so a packed INT4 projection
costs its packed bytes, not an f32 weight.  The same dispatch mode
tracks the live bytes the step allocates (a weak reference on every
fresh output), whose peak is ``temp_bytes``.

``HW`` holds NVIDIA's data-sheet figures for an "NVIDIA H100 80GB
HBM3, 700.00 W" (SXM5): 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, NVLink
450 GB/s a direction among the 8 cards of a node, and 50 GB/s across
nodes (one 400 Gb/s NIC a card).  They are not measurements.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import cost as kcost
from repro_torch.models import common
from repro_torch.tree import leaves


@dataclass
class HW:
    peak_flops: float = kcost.BF16_FLOPS   # bf16 dense, per card
    hbm_bw: float = kcost.HBM_BPS          # bytes/s
    nvlink_bw: float = 450e9          # bytes/s a direction, within a node
    ib_bw: float = 50e9               # bytes/s a card across nodes
    cards_per_node: int = 8


def _collective_bytes(op: str, out_bytes: int, p: int) -> float:
    """Link bytes a device sends for one collective of ``out_bytes``
    output over ``p`` ranks (ring algorithms)."""
    if p <= 1:
        return 0.0
    if op == "all-gather":
        return out_bytes * (p - 1) / p
    if op == "all-reduce":
        return 2.0 * out_bytes * (p - 1) / p
    if op == "reduce-scatter":
        return out_bytes * (p - 1)
    if op == "all-to-all":
        return out_bytes * (p - 1) / p
    if op == "collective-permute":
        return float(out_bytes)
    return 0.0


# aten ops that move no bytes: allocations, and a view whose schema does
# not mark its output as an alias
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view"}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes one read of ``t`` moves: its elements, at most its storage
    (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _tag() -> str:
    """The innermost ``repro_torch.models`` function on the stack."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.models"):
            return f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}"
        f = f.f_back
    return "(outside models)"


class _Counter(TorchDispatchMode):
    """HBM bytes per op, live bytes and their peak; with ``rows`` also a
    row per (op, tag, output shape)."""

    def __init__(self, rows: bool = False):
        super().__init__()
        self.hbm_bytes = 0.0
        self.live = 0
        self.peak = 0
        self.storages = set()
        self.rows = defaultdict(lambda: {"bytes": 0.0, "flops": 0.0,
                                         "count": 0}) if rows else None

    def _free(self, key, n):
        self.live -= n
        self.storages.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        rets = func._schema.returns
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        # fresh storages: outputs on a storage no input holds (an op
        # without alias annotations may still return a view)
        held = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key in held or key in self.storages:
                continue
            n = t.untyped_storage().nbytes()
            self.storages.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, key, n)
        view = bool(rets) and all(r.alias_info is not None
                                  and not r.alias_info.is_write
                                  for r in rets)
        if view or name in _NO_TRAFFIC:
            return out
        seen, moved = set(), 0
        for t in ins + outs:
            if id(t) not in seen:
                seen.add(id(t))
                moved += _nbytes(t)
        self.hbm_bytes += moved
        if self.rows is not None:
            shape = tuple(outs[0].shape) if outs else ()
            row = self.rows[(name, _tag(), str(shape)[:40])]
            row["bytes"] += moved
            row["count"] += 1
        return out


def block_bytes(tree) -> dict:
    """{id: bytes} of the tensors of ``tree`` at this device: each placed
    leaf's block, each tensor once."""
    out = {}
    for leaf in leaves(tree):
        t = leaf.to_local() if isinstance(leaf, common.AbstractDTensor) \
            else leaf
        if isinstance(t, torch.Tensor):
            out[id(t)] = t.numel() * t.element_size()
    return out


def analyze_step(fn, *args, hw: HW = HW(), rows: bool = False) -> dict:
    """Run ``fn(*args)`` once under the counters (its inputs on meta) and
    return the per-device totals: ``flops``, ``hbm_bytes``,
    ``nvlink_bytes``, ``ib_bytes``, ``coll_count`` and ``coll_<kind>``
    link bytes; ``arg_bytes``, ``out_bytes`` and ``alias_bytes`` (the
    outputs that are arguments, updated in place: donated);
    ``temp_bytes``, the peak of the live bytes the step allocated less
    the fresh outputs'; ``kernels`` ({name: operations, bytes and calls
    the kernels reported}); ``out``, what ``fn`` returned; with
    ``rows``, ``rows`` (the profile: one per (op, tag, shape))."""
    acc = {"flops": 0.0, "hbm_bytes": 0.0, "nvlink_bytes": 0.0,
           "ib_bytes": 0.0, "coll_count": 0.0}
    kernels = defaultdict(lambda: {"flops": 0.0, "bytes": 0.0, "count": 0})
    counter = _Counter(rows)

    def on_kernel(name, c, shapes):
        k = kernels[name]
        k["flops"] += c.flops
        k["bytes"] += c.nbytes
        k["count"] += 1
        if counter.rows is not None:
            row = counter.rows[(f"kernel:{name}", _tag(), str(shapes)[:40])]
            row["bytes"] += c.nbytes
            row["flops"] += c.flops
            row["count"] += 1

    del common.COLL_RECORD[:]
    flop_mode = FlopCounterMode(display=False)
    with kcost.listening(on_kernel), flop_mode, counter:
        out = fn(*args)
    record = list(common.COLL_RECORD)
    del common.COLL_RECORD[:]
    acc["flops"] = float(flop_mode.get_total_flops()) + sum(
        k["flops"] for k in kernels.values())
    acc["hbm_bytes"] = counter.hbm_bytes + sum(
        k["bytes"] for k in kernels.values())
    for kind, nbytes, p in record:
        link = _collective_bytes(kind, nbytes, p)
        key = "ib_bytes" if p > hw.cards_per_node else "nvlink_bytes"
        acc[key] += link
        acc["coll_" + kind] = acc.get("coll_" + kind, 0.0) + link
        acc["coll_count"] += 1
    arg, res = block_bytes(list(args)), block_bytes(out)
    acc["arg_bytes"] = sum(arg.values())
    acc["out_bytes"] = sum(res.values())
    acc["alias_bytes"] = sum(n for i, n in res.items() if i in arg)
    acc["temp_bytes"] = max(0, counter.peak - acc["out_bytes"]
                            + acc["alias_bytes"])
    acc["kernels"] = {k: dict(v) for k, v in kernels.items()}
    acc["out"] = out
    if rows:
        acc["rows"] = [{"op": k[0], "tag": k[1], "shape": k[2], **v}
                       for k, v in counter.rows.items()]
    return acc


def roofline_report(acc: dict, hw: HW = HW()) -> dict:
    t_comp = acc["flops"] / hw.peak_flops
    t_mem = acc["hbm_bytes"] / hw.hbm_bw
    t_coll = acc["nvlink_bytes"] / hw.nvlink_bw + acc["ib_bytes"] / hw.ib_bw
    bound = max(("compute", t_comp), ("memory", t_mem),
                ("collective", t_coll), key=lambda kv: kv[1])
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "bottleneck": bound[0],
        "t_bound_s": bound[1],
        **acc,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D (train), 2·N_active·D (prefill),
    2·N_active·b (decode step) — whole-job figures (all devices)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch
