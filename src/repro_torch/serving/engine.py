"""Resident-weight continuous-batching serving engine (the JAX package's
``serving/engine.py``, for ``ATTN``, ``ATTN_LOCAL``, ``MLA`` and ``SSM``
stacks and whisper's encoder-decoder, with dense or MoE feed-forwards;
``moe_quant="int4"`` keeps the routed expert stacks packed).

All parameters stay in device memory at f32; each engine step decodes
ALL slots with *ragged* per-slot positions in one whole-model decode
(``models.transformer.decode_step``), attention through the port's
kernels on the card: ``flash_attention`` for each prefill,
``decode_attention`` over the bf16 caches for each step.  Slot
admission, completion and preemption live in
``serving.base.SlotEngineBase``; the offloaded twin that streams weights
through the PIPO pipeline is ``serving.offload_engine``.

The caches keep the JAX layout: ``pat`` leaves stacked
``(periods, b_max, max_len, hkv, dh)``, ``rem`` leaves ``(b_max, ...)``.
A prefill's ``max_len`` slab (its prompt rows, zeros past them) is
scattered into the slot (``_slot_views``); decode writes each slot's row
in place (the JAX engine donates its caches to a jitted step instead).
A spill snapshots the slot's rows as device copies, so later steps'
in-place writes cannot reach the rows a transfer thread is copying.

This engine also carries the architectures the offloaded engine cannot
stream (``serving.spec.offload_capability``), so ``create_engine`` has a
resident fallback for every registry config: encoder-decoder stacks
(whisper: each prefill encodes the request's ``Request.enc_embeds``
frames, or a zero-frame stub of ``(encoder_seq_len, d_model)`` when it
has none, and the slot keeps the encoder rows ``ck``/``cv`` of every
CROSS layer beside its ``k``/``v``) and embeds-frontend configs
(qwen2-vl: token prompts embed through the shared table, the text-only
stub, and rotate by M-RoPE).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.kvstore import assign_rows
from repro_torch.core.offload import HostStore
from repro_torch.core.pipeline import ThreadPool
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.serving.base import Request, SlotEngineBase
from repro_torch.serving.spec import ResolvedPlan

__all__ = ["Request", "ServingEngine", "KVRoundtripServingEngine"]


class ServingEngine(SlotEngineBase):
    """See module docstring.  Built from a ``ResolvedPlan`` (``b_max``,
    ``max_len``, ``seed``, ``spill_cap``) on ``device`` (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, plan: ResolvedPlan, device="cuda",
                 kv_pool: Optional[ThreadPool] = None):
        if not isinstance(plan, ResolvedPlan):
            raise TypeError(f"ServingEngine takes a ResolvedPlan, got "
                            f"{type(plan).__name__}")
        cfg = plan.model_config()
        self.plan = plan
        self.dev = resolve_device(device)
        super().__init__(cfg, b_max=plan.b_max, max_len=plan.max_len,
                         kv_pool=kv_pool, spill_cap=plan.spill_cap,
                         host=HostStore(pin=self.dev.type == "cuda"))
        self.model = build_model(cfg)
        self.params = T.to_device(self.model.init(plan.seed), self.dev)
        if plan.moe_quant:
            # INT4-resident MoE: the routed expert stacks packed once, on
            # the card; each step's experts run through int4_matmul
            from repro_torch.serving.spec import quant_policy_for
            self.params = quant_policy_for(
                plan.quant, plan.kv_mode,
                plan.moe_quant).prepare_moe_params(self.params)
        self.enc_len = cfg.encoder_seq_len if cfg.enc_dec else None
        self.caches = self.model.init_cache(self.b_max, self.max_len,
                                            self.dev, self.enc_len)

    # ---- compute ------------------------------------------------------------
    def _prefill_batch(self, req: Request) -> dict:
        """b=1 prompt batch: token prompts always embed through the
        shared table (the text-only stub for embeds-frontend configs);
        enc-dec configs also carry encoder frames, the request's
        ``enc_embeds`` or a zero-frame stub."""
        tokens = torch.from_numpy(np.asarray(req.prompt, np.int32)[None])
        batch = {"tokens": tokens.to(self.dev)}
        if self.cfg.enc_dec:
            enc = req.enc_embeds
            if enc is None:
                enc = np.zeros((self.enc_len, self.cfg.d_model), np.float32)
            batch["enc_embeds"] = torch.from_numpy(
                np.asarray(enc, np.float32)[None]).to(self.dev)
        return batch

    def _prefill_into_slot(self, slot: int, req: Request) -> int:
        nt, cache1 = self.model.prefill(self.params, self._prefill_batch(req),
                                        self.max_len)
        # scatter the b=1 cache slab into the slot (KV "admission"),
        # broadcasting as the reference's scatter does
        for big, one in zip(self._slot_views(self.caches, slot),
                            self._slot_views(cache1, 0)):
            assign_rows(big, one)
        return int(nt[0])

    def _decode_active(self, active: List[int]) -> np.ndarray:
        tok = torch.from_numpy(self.tokens[:, None].copy()).to(self.dev)
        pos = torch.from_numpy(self.pos.copy()).to(self.dev)
        nt, self.caches = self.model.decode_step(
            self.params, {"token": tok, "pos": pos}, self.caches)
        return nt.cpu().numpy()

    # ---- slot cache plumbing ------------------------------------------------
    @staticmethod
    def _batch_axis(group: str) -> int:
        """Cache leaves under 'pat' are stacked (periods, b, ...); under
        'rem' they are (b, ...)."""
        return 1 if group == "pat" else 0

    def _leaves(self, tree):
        """(group, position, name, leaf) in the JAX tree's flatten
        order."""
        return [(grp, q, n, t[n]) for grp in ("pat", "rem")
                for q, t in enumerate(tree[grp]) for n in sorted(t)]

    def _slot_views(self, tree, slot: int) -> List[torch.Tensor]:
        """Every leaf's rows of ``slot`` as views, in flatten order."""
        return [leaf.select(self._batch_axis(grp), slot)
                for grp, _, _, leaf in self._leaves(tree)]

    # ---- PIPO KV offload at slot granularity --------------------------------
    def _offload_snapshot(self, slot: int):
        """Copy the slot's rows NOW (device-side): decode writes the
        caches in place, so a view would change under the transfer
        thread.  The device->host copy runs in ``_offload_write``."""
        return [v.clone() for v in self._slot_views(self.caches, slot)]

    def _offload_write(self, ns: str, rows):
        """Device->host spill of one slot's cache rows under ``{ns}/{i}``
        keys.  Runs on a transfer-pool thread when kv_pool is
        attached."""
        for i, row in enumerate(rows):
            self.host.put(f"{ns}/{i}", row.cpu())

    def restore_slot(self, slot: int, ns: str):
        """KV-load: bring an offloaded request's rows (namespace ``ns``)
        back into a slot.  Main thread; blocking."""
        for i, view in enumerate(self._slot_views(self.caches, slot)):
            view.copy_(self.host.get(f"{ns}/{i}"))


class KVRoundtripServingEngine(ServingEngine):
    """The ``kv_mode="int4"`` parity reference: a resident engine whose
    newly-written cache rows are roundtripped through the EXACT
    quantize->dequantize the tiered KV store applies to streamed rows
    (``core.kvstore.kv_roundtrip_rows``) — once per row, right after it
    is written.  An offloaded engine with ``kv_mode="int4"`` must decode
    token-identical to this reference.  Only sequence-extent (kind
    ``"kv"``) leaves with an even feature count roundtrip, the store's
    ``kv_eligible`` predicate."""

    def __init__(self, plan: ResolvedPlan, **kw):
        super().__init__(plan, **kw)
        _, self._kv_kinds = T.cache_struct(self.cfg, self.b_max,
                                           self.max_len, self.enc_len)

    def _roundtrip_slot_rows(self, slot: int, pos=None):
        """Roundtrip slot ``slot``'s eligible cache rows in place: every
        position (after a prefill scattered the whole slot row) or just
        position ``pos`` (after a decode step wrote one row)."""
        from repro_torch.core.kvstore import kv_eligible, kv_roundtrip_rows
        for grp, q, name, leaf in self._leaves(self.caches):
            ax = self._batch_axis(grp)
            feat = leaf.shape[ax + 2:]
            if not kv_eligible(self._kv_kinds[grp][q][name], feat):
                continue
            rows = leaf.select(ax, slot)
            if pos is not None:
                rows = rows.select(ax, pos)
            f = int(np.prod(feat))
            lead = rows.shape[:rows.ndim - len(feat)]
            rt = kv_roundtrip_rows(rows.reshape(lead + (f,)))
            rows.copy_(rt.reshape(rows.shape))

    def _prefill_into_slot(self, slot: int, req: Request) -> int:
        tok = super()._prefill_into_slot(slot, req)
        self._roundtrip_slot_rows(slot)
        return tok

    def _decode_active(self, active):
        nt = super()._decode_active(active)
        for s in active:
            # base increments pos AFTER this returns: pos[s] is the row
            # this step just wrote — roundtrip it exactly once
            self._roundtrip_slot_rows(s, int(self.pos[s]))
        return nt
