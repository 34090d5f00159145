"""Offloaded continuous-batching serving engine: the PIPO pipeline under a
serving workload, ported to PyTorch and CUDA.

Only the embedding, the LM head and the final norm stay on the device.
Each transformer layer's weights live as ONE merged buffer on the host or
disk tier (``TieredWeightStore``) and stream through the transfer pool
and ``PipelineScheduler`` per step; the per-layer KV cache lives in a
``TieredKVStore`` on the host and moves as KV_LOAD/KV_SAVE tasks, sliced
to the live ``(slots, positions)`` extent.  ``SlotEngineBase`` admits
requests into free slots (a b=1 prefill each), decodes every active slot
per step at its own ragged position, frees finished slots at once, and
preempts, spills and restores slots.

On the card a unit runs ``flash_attention`` for a prefill, and for a
decode step ``decode_attention`` over the bf16 cache (``kv_mode="fp32"``)
or ``decode_attention_int4`` over the packed rows the store ships
(``kv_mode="int4"``; the step's own row is attended unquantized, at
bf16, as the reference writes it into its dequantized bf16 cache).  With
``quant="int4"`` and ``fused_int4`` the packed projections stay packed on
the device and go to ``int4_matmul``.

The dense, single-stage, monolithic-prefill subset of the JAX package's
``serving/offload_engine.py``: MoE layers, chunked prefill, speculative
decoding and pipeline stages each raise ``NotImplementedError`` naming a
later slice.  ``depth_policy="adaptive"`` re-sizes the window between
decode steps from the live pressure and the measured link
(``_resize_window``, ``AdaptiveDepth``).  The port draws its own weights
one unit at a time (``models.transformer.draw_tables``: each unit is
drawn, packed under ``quant="int4"`` and merged before the next one's
f32 copy is needed); ``core.convert.from_reference_serving`` loads the
JAX engine's instead.

Pipeline modes: "performance" (preload the next ``depth`` units during a
unit's compute; ``warm`` adds the cross-step preload), "memory" and
"sequential", as in ``core.pipeline``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig
from repro_torch.core.kvstore import TieredKVStore
from repro_torch.core.offload import DeviceStore, DiskStore, HostStore
from repro_torch.core.pipeline import PipelineScheduler, ThreadPool, adopt
from repro_torch.core.tasks import Trace, _merged_busy
from repro_torch.core.transfer import DEFAULT_BLOCK, TieredWeightStore
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.base import Request, SlotEngineBase
from repro_torch.serving.spec import (AdaptiveDepth, Pressure, ResolvedPlan,
                                      StaticDepth, UnsupportedModelError,
                                      offload_capability, preload_policy_for,
                                      quant_policy_for, sched_policy_for)

__all__ = ["Request", "OffloadedServingEngine"]


@dataclass
class _Unit:
    """One schedulable layer: period ``p`` of pattern position ``q``
    ('pat'), or remainder layer q ('rem')."""
    group: str          # "pat" | "rem"
    p: int              # period index (0 for rem)
    q: int              # pattern / remainder position
    spec: LayerSpec
    key: str            # TieredWeightStore key


class OffloadedServingEngine(SlotEngineBase):
    """See module docstring.  Main-thread object: all public methods run
    on the caller's thread; weight/KV transfers run on the internal
    transfer pool."""

    def __init__(self, plan: ResolvedPlan, device="cuda"):
        if not isinstance(plan, ResolvedPlan):
            raise TypeError(f"OffloadedServingEngine takes a ResolvedPlan, "
                            f"got {type(plan).__name__}")
        cfg = plan.model_config()
        cap = offload_capability(cfg)
        if cap is not None or plan.engine != "offloaded":
            raise UnsupportedModelError(
                cap or "resident_plan",
                f"offloaded serving supports token-frontend rope decoder "
                f"stacks only (failing capability: {cap or plan.engine}; "
                f"arch {plan.arch})")
        if cfg.moe is not None or any(
                (s.mixer, s.ffn) != (ATTN, DENSE)
                for s in (*cfg.pattern, *cfg.remainder)):
            raise NotImplementedError(
                "the port serves dense ATTN+DENSE stacks; MoE and the other "
                "mixers come with later slices")
        if plan.draft_arch is not None:
            raise NotImplementedError(
                "speculative decoding comes with a later slice of the port")
        if plan.stages != 1:
            raise NotImplementedError(
                "pipeline-parallel stages come with a later slice of the port")
        self.dev = resolve_device(device)
        self.plan = plan
        self.preload_policy = preload_policy_for(plan, cfg)
        self.quant_policy = quant_policy_for(plan.quant, plan.kv_mode)
        self.sched_policy = sched_policy_for(plan)
        if self.quant_policy.kv_mode == "int4" and plan.cache_on == "device":
            raise NotImplementedError(
                "kv_mode='int4' streams the cache; cache_on='device' keeps "
                "it resident")
        self.trace = Trace()
        n_units = self._n_units(cfg)
        depth = PipelineScheduler.clamp_depth(plan.pipeline, n_units,
                                              max(1, plan.depth))
        max_depth = PipelineScheduler.clamp_depth(
            plan.pipeline, n_units, self.preload_policy.max_depth())
        pool = ThreadPool(PipelineScheduler.pool_size(max(depth, max_depth)),
                          self.trace, device=self.dev)
        pin = self.dev.type == "cuda"
        super().__init__(cfg, b_max=plan.b_max, max_len=plan.max_len,
                         kv_pool=pool, spill_cap=plan.spill_cap,
                         host=HostStore(pin=pin))
        self.pipeline_mode = plan.pipeline
        self.quant = plan.quant
        self.warm = plan.warm
        self.device = DeviceStore(self.dev)
        self.disk = (DiskStore(plan.disk_root) if plan.placement == "disk"
                     else None)
        self.weights = TieredWeightStore(
            placement=plan.placement, host=self.host, device=self.device,
            disk=self.disk, quant=self.quant_policy.weight_mode,
            fused_int4=plan.fused_int4,
            block_bytes=plan.block_bytes or DEFAULT_BLOCK,
            n_io_threads=plan.n_io_threads, cold_reads=plan.cold_reads,
            sim_bw=plan.sim_bw)
        self._phase = "prefill"           # until the first _decode_active
        self.stats["preload_depth"] = depth
        self.stats["depth_resizes"] = 0
        self.units: List[_Unit] = []
        self._split_params(plan.seed)
        self._kv_init()
        # live decode view, (scheduler iteration base, live_batch,
        # live_len): ONE tuple so transfer-thread reads are atomic under
        # the GIL.  Refreshed at the top of every decode step; a warm tail
        # preload for iteration base+1 prices itself at live_len+1.
        self._decode_view = (0, self.b_max, self.max_len)
        self._extent_memo: Dict[int, tuple] = {}
        # per-step Trace cursor + policy feedback (AdaptiveDepth only)
        self._trace_mark = 0
        if isinstance(self.preload_policy, AdaptiveDepth):
            self.preload_policy.set_link_profile(
                sum(self.weights.nbytes(u.key) for u in self.units)
                // max(1, len(self.units)))
        self.sched = PipelineScheduler(len(self.units), plan.pipeline,
                                       pool=pool, trace=self.trace,
                                       warm=self.warm, depth=depth,
                                       device=self.dev)
        self.trace.meta.update(
            arch=plan.arch, b_max=plan.b_max, max_len=plan.max_len,
            sim_bw=plan.sim_bw, quant=plan.quant,
            kv_mode=plan.kv_mode or "fp32")

    @staticmethod
    def _n_units(cfg: ModelConfig) -> int:
        return cfg.num_periods * len(cfg.pattern) + len(cfg.remainder)

    # ---- weight tiering -----------------------------------------------------
    def _split_params(self, seed: int):
        """The embedding, LM head and final norm go to the device; each
        layer's tensors (INT4-packed under ``quant="int4"``) merge into
        one tiered buffer.  Tables are drawn on threads a few units
        ahead, so at most that many units' f32 copies exist at once.
        Main thread, build time only."""
        cfg = self.cfg
        keys = [("embed", 0, 0), ("final_norm", 0, 0)] + T.table_keys(cfg)
        self.resident = {}
        for (part, q, p), tensors in T.draw_tables(cfg, seed, keys):
            if part in ("embed", "final_norm"):
                self.resident[part] = {
                    name: self.device.put(f"{part}/{name}", arr)
                    for name, arr in tensors.items()}
            elif part == "pat":
                self._put_unit("pat", p, q, cfg.pattern[q], f"u[{p}][{q}]",
                               tensors)
            else:
                self._put_unit("rem", 0, q, cfg.remainder[q], f"rem[{q}]",
                               tensors)

    def _put_unit(self, group, p, q, spec, key, tensors):
        self.weights.put(key, self.quant_policy.prepare_unit(tensors,
                                                             self.dev))
        self.units.append(_Unit(group, p, q, spec, key))

    # ---- tiered KV ----------------------------------------------------------
    def _kv_init(self):
        """The per-unit decode cache (bf16 rows, packed under
        ``kv_mode='int4'``) as a ``TieredKVStore`` on the host, sharing
        the weight store's link."""
        struct, kinds = T.cache_struct(self.cfg, self.b_max, self.max_len)
        shapes, kk = [], []
        for u in self.units:
            sds = struct[u.group][u.q]
            shapes.append({n: ((s[1:] if u.group == "pat" else s), dt)
                           for n, (s, dt) in sds.items()})
            kk.append(dict(kinds[u.group][u.q]))
        self.kv_kinds: List[Dict[str, str]] = kk
        self.kvstore = TieredKVStore(
            shapes, kk, b_max=self.b_max, max_len=self.max_len,
            kv_mode=self.quant_policy.kv_mode, link=self.weights.link,
            device=self.dev, pin=self.dev.type == "cuda")

    # ---- per-unit compute (main thread) -------------------------------------
    def _embed(self, tokens: np.ndarray) -> torch.Tensor:
        return L.embed_tokens(self.resident["embed"],
                              torch.from_numpy(np.asarray(tokens)).to(
                                  self.dev))

    def _head(self, x) -> np.ndarray:
        x = L.rms_norm(x, self.resident["final_norm"]["scale"],
                       self.cfg.norm_eps)
        tok = L.lm_head_argmax(self.resident["embed"], x[:, -1:], self.cfg)
        return tok.cpu().numpy()

    # ---- PipelineScheduler callbacks ----------------------------------------
    def is_mha(self, j: int) -> bool:
        """'Has streamed KV state' in scheduler terms (every ATTN unit)."""
        return bool(self.kv_kinds[j])

    def load_weights(self, j: int):
        """WEIGHT_LOAD body (transfer worker): the merged buffer only;
        the compute thread splits it (``compute``).  Unfused INT4
        dequantizes here, on the transfer thread, as the reference
        does."""
        key = self.units[j].key
        if self.quant == "int4" and not self.weights.fused_int4:
            return self.weights.load(key)
        return self.weights.fetch(key)

    def weight_nbytes(self, j: int) -> int:
        return self.weights.nbytes(self.units[j].key)

    def release_weights(self, j: int, handle):
        del handle

    def _live_extent(self, i: int):
        """(live_batch, live_len) iteration ``i``'s KV_LOAD ships, from the
        atomic ``_decode_view``; a warm tail preload (``i`` past the
        step's base) adds the positions the intervening saves wrote.
        Memoized per iteration (first query wins), so the bytes
        ``kv_nbytes`` priced on the main thread are the bytes ``load_kv``
        ships later on a worker, even after the view moved on."""
        ext = self._extent_memo.get(i)
        if ext is None:
            base, lb, ll = self._decode_view
            ext = self._extent_memo.setdefault(
                i, (lb, min(ll + max(0, i - base), self.max_len)))
        return ext

    def _kv_phase(self, i: int) -> str:
        return self._phase                # "prefill" | "decode"

    def _kv_live(self, i: int):
        return self._live_extent(i)

    def _kv_streams(self, j: int) -> bool:
        return bool(self.kv_kinds[j])

    def _kv_prefill_save_nbytes(self, j: int) -> int:
        return self.kvstore.prefill_save_nbytes(j)

    def save_kv(self, i: int, j: int, new_kv):
        """KV_SAVE body (transfer worker): scatter the fresh rows into the
        store, which quantizes them (once per row) under
        ``kv_mode='int4'``."""
        phase, payload, meta = new_kv
        if phase == "prefill":
            self.kvstore.save_prefill(j, meta, {n: l[0] for n, l in
                                                payload.items()})
        else:
            active, pos, live_b = meta
            self.kvstore.save_decode(j, {n: l[:live_b] for n, l in
                                         payload.items()}, active, pos)

    def compute(self, i: int, j: int, x, weights, kv):
        """COMPUTE body (main thread): one unit's forward."""
        u = self.units[j]
        adopt(self.dev, weights)
        if isinstance(weights, torch.Tensor):
            weights = self.weights.split(u.key, weights)
        if self._phase == "prefill":
            ctx = L.Ctx(cfg=self.cfg, mode="prefill", angles=self._angles)
            x, rows = L.apply_layer(weights, x, ctx, None, u.spec)
            return x, ("prefill", rows, self._slot)
        adopt(self.dev, kv)
        ctx = L.Ctx(cfg=self.cfg, mode="decode", angles=self._angles,
                    pos=self._pos_dev)
        x, rows = L.apply_layer(weights, x, ctx, kv, u.spec)
        # rows: the fresh {name: (b, 1, *feat)} the save ships
        return x, ("decode", rows,
                   (self._active, self._pos_snap, self._decode_view[1]))

    def finalize(self, i: int, x):
        return self._head(x)

    # ---- SlotEngineBase compute hooks ---------------------------------------
    def _prefill_into_slot(self, slot: int, req: Request) -> int:
        """b=1 prompt pass through the pipeline (main thread).  Any warm
        KV preload submitted at the tail of this call captured the prefill
        phase (value None) and is dropped; its weight preload stays
        valid."""
        self._phase = "prefill"
        self._slot = slot
        s = len(req.prompt)
        self._angles = T._angles(self.cfg, torch.arange(s, device=self.dev))
        x0 = self._embed(np.asarray(req.prompt)[None])
        toks = self.sched.generate(self, lambda i: x0, 1)
        self.sched.drop_kv_preloads()
        # skip the prefill's trace window for the bandwidth feedback: a
        # full-prompt forward costs far more per layer than a decode step
        self._trace_mark = len(self.trace.events())
        return int(toks[-1][0])

    def _observe_trace(self):
        """Feed the Trace delta since the last step into the adaptive
        policy's bandwidth/compute EWMAs (main thread, between steps):
        transfer bytes over merged transfer busy time is the measured
        link bandwidth."""
        evs = self.trace.events()
        new, self._trace_mark = evs[self._trace_mark:], len(evs)
        if not new:
            return
        xfer = [e for e in new if e.kind in ("weight_load", "kv_load")]
        comp = [e for e in new if e.kind == "compute"]
        self.preload_policy.observe(
            transfer_bytes=sum(e.nbytes for e in xfer),
            transfer_busy_s=_merged_busy((e.t_start, e.t_end)
                                         for e in xfer),
            compute_busy_s=_merged_busy((e.t_start, e.t_end)
                                        for e in comp),
            layers=len(comp))

    def _resize_window(self, active: List[int]):
        """Consult the preload policy with the live pressure snapshot and
        re-size the scheduler's window between steps (main thread).
        ``StaticDepth`` always answers the same; ``AdaptiveDepth`` prices
        the per-layer KV term at the store's exact live payload and the
        link at the measured-bandwidth EWMA."""
        if isinstance(self.preload_policy, StaticDepth):
            return
        self._observe_trace()
        lb = max(active) + 1
        max_pos = int(max(self.pos[s] for s in active))
        p = Pressure(active=len(active), max_pos=max_pos,
                     spills=len(self._spill_lru),
                     kv_layer_bytes=self.kvstore.max_live_load_nbytes(
                         lb, max(1, max_pos)))
        d = self.sched.set_depth(self.preload_policy.depth(p))
        if d != self.stats["preload_depth"]:
            self.stats["depth_resizes"] += 1
            self.stats["preload_depth"] = d

    def _step_setup(self, active: List[int]):
        """Per-step state refresh (main thread): preload-policy resize,
        phase, position snapshot and the atomic live view for this step's
        KV extents (occupied slots, written positions)."""
        self._resize_window(active)
        self._phase = "decode"
        self._active = list(active)
        self._pos_snap = self.pos.copy()
        base = self.sched._iter0
        self._decode_view = (base, max(active) + 1,
                             max(1, int(max(self.pos[s] for s in active))))
        for k in [k for k in self._extent_memo if k < base]:
            del self._extent_memo[k]

    def _decode_active(self, active: List[int]) -> np.ndarray:
        """One batched decode step over every slot at its own position
        (main thread)."""
        self._step_setup(active)
        self._pos_dev = torch.from_numpy(self.pos.copy()).to(self.dev)
        self._angles = T._angles(self.cfg, self._pos_dev[:, None])
        x0 = self._embed(self.tokens[:, None])
        toks = self.sched.generate(self, lambda i: x0, 1)
        return toks[-1]

    # ---- slot spill/restore (host<->host; rows already offloaded) -----------
    def _offload_snapshot(self, slot: int):
        """Drain in-flight pipeline saves so the spill's row reads cannot
        race them (main thread)."""
        self.sched.drain_saves()
        return slot

    def _offload_write(self, ns: str, slot: int):
        """Spill the slot's rows out of the store under ``{ns}/...``
        (packed rows spill packed)."""
        self.kvstore.spill(self.host, ns, slot)

    def restore_slot(self, slot: int, ns: str):
        """Bring a parked request's rows back into a slot (main thread):
        outstanding saves drain first and stale warm KV preloads are
        dropped."""
        self.sched.drain_saves()
        self.sched.drop_kv_preloads()
        self.kvstore.restore(self.host, ns, slot)

    # ---- lifecycle / introspection ------------------------------------------
    def pipeline_report(self):
        return self.trace.report()

    def shutdown(self):
        """Drain slot spills and pipeline saves, stop the pool."""
        super().shutdown()
        self.sched.shutdown()
        self._kv_pool.shutdown()
