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

Chunked prefill (``sched="online"|"offline"``, the plan's
``SchedPolicy``): at most one prompt is in flight, advanced one chunk per
engine step; the chunk rides the decode batch's ``generate`` call, so one
WEIGHT_LOAD per unit serves both.  A chunk attends the engine-held f32
prefix of its earlier chunks through ``flash_attention`` with
``q_offset`` (``models.layers.apply_layer_chunk``), and its rows append
to the KV store through the step's KV_SAVE.

Speculative decoding (a plan with ``draft_arch``, or ``attach_draft``):
a device-resident draft proposes ``k`` tokens per step while the verify
pass's first weights stream; the target scores all ``k+1`` positions in
one trip through the stack and greedy accept/reject emits up to ``k+1``
tokens per slot, equal to non-speculative decode.  Pipeline-parallel
stages (``stages > 1``): the stack splits into contiguous stages, each
with its own weight and KV stores (its own link), transfer pool and
window (``plan.stage_plan``), and activations hand stage to stage
(``_MeshStagedScheduler``; on one card every stage shares it).

MoE layers stream only the union of the experts the batch routed to
(paper Appendix C.4): the router stays on the device, each expert is a
store buffer of its own (``u[p][q]/exp[e]``), and after the gate runs
(the sync point: the routed ids cross to the host) only the routed
experts are submitted as WEIGHT_LOAD tasks, while the shared expert
computes.  The combine is compact (``models.moe.moe_ffn_union`` over the
union, ids remapped in order); packed experts go to ``int4_matmul``.

Sliding-window layers (Gemma 3's ``ATTN_LOCAL``) keep a rolling buffer of
``window`` rows per slot (cache kind ``"rep"``): each decode step loads
the live slots' whole buffers and saves them whole, as the reference's
``decode_fn`` does, and under ``kv_mode="int4"`` only the global layers'
rows are packed.  SSM layers (Mamba2, and jamba's SSM layers beside its
attention layer) keep a conv halo (kind ``"rep"``) and an f32 state (kind
``"state"``) per slot: each decode step loads the live slots' whole
leaves and ships the whole new ones back, as the reference's
``decode_fn`` does for every kind other than ``"kv"``, and neither is
ever packed.  The single-device subset of the JAX package's
``serving/offload_engine.py``: encoder-decoder and embeds-frontend
configs raise ``UnsupportedModelError`` here, as in the JAX package, and
serve on the resident ``ServingEngine`` (``create_engine``'s fallback).
``depth_policy="adaptive"`` re-sizes the window between
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

import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MLA, MOE, SSM,
                                      LayerSpec, ModelConfig)
from repro_torch.core.draft import accepted_tokens
from repro_torch.core.kvstore import TieredKVStore
from repro_torch.core.offload import DeviceStore, DiskStore, HostStore
from repro_torch.core.pipeline import (PipelineScheduler, StagedScheduler,
                                       ThreadPool, adopt)
from repro_torch.core.tasks import Task, TaskType, Trace, _merged_busy
from repro_torch.core.transfer import DEFAULT_BLOCK, TieredWeightStore
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import stage_devices
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.serving.base import Request, SlotEngineBase
from repro_torch.serving.spec import (AdaptiveDepth, EngineSpec, Pressure,
                                      ResolvedPlan, StaticDepth,
                                      UnsupportedModelError,
                                      draft_policy_for, offload_capability,
                                      preload_policy_for, quant_policy_for,
                                      sched_policy_for,
                                      spec_decode_capability,
                                      warn_deprecated_once)

__all__ = ["Request", "OffloadedServingEngine"]

# the pre-spec constructor's defaults: the deprecation shim overlays the
# given keywords on these, so a legacy call resolves to the plan the JAX
# package's shim resolves (kv_mode None = auto -> fp32)
_LEGACY_DEFAULTS = dict(
    b_max=4, max_len=256, seed=0, placement="host", pipeline="performance",
    quant=None, kv_mode=None, fused_int4=True, warm=None, depth=None,
    disk_root="", block_bytes=None, n_io_threads=3,
    cold_reads=False, sim_bw=None, spill_cap=32)


@dataclass
class _Unit:
    """One schedulable layer: period ``p`` of pattern position ``q``
    ('pat'), or remainder layer q ('rem').  MoE layers also carry a
    device-resident router and one store key per expert."""
    group: str          # "pat" | "rem"
    p: int              # period index (0 for rem)
    q: int              # pattern / remainder position
    spec: LayerSpec
    key: str            # TieredWeightStore key (mixer + norms + shared)
    moe: bool = False
    router: Any = None                     # device (d, E) gate weights
    expert_keys: List[str] = field(default_factory=list)

    def apply(self, weights, x, ctx: L.Ctx, cache):
        """The unit's own buffer on ``x`` -> (x', new_cache): the whole
        layer for a dense unit; the mixer only for an MoE unit, whose
        buffer holds no routed experts (its feed-forward runs in
        ``_compute_moe``)."""
        if self.moe:
            return L.apply_mixer(weights, x, ctx, cache, self.spec)
        return L.apply_layer(weights, x, ctx, cache, self.spec)[:2]


class _StagedWeightStore:
    """Key-routing facade over per-stage ``TieredWeightStore``s: each
    stage owns its own store (so its own link and device), and
    ``route(key) -> stage`` parses the unit key; the host and disk tiers
    are shared (keys are globally unique)."""

    def __init__(self, stores, route):
        self.stores = list(stores)
        self._route = route
        self.fused_int4 = self.stores[0].fused_int4

    def _of(self, key: str) -> TieredWeightStore:
        return self.stores[self._route(key)]

    def put(self, key: str, tensors):
        return self._of(key).put(key, tensors)

    def nbytes(self, key: str) -> int:
        return self._of(key).nbytes(key)

    def fetch(self, key: str):
        return self._of(key).fetch(key)

    def split(self, key: str, buf):
        return self._of(key).split(key, buf)

    def load(self, key: str):
        return self._of(key).load(key)


class _StagedKVStore:
    """Global-unit facade over per-stage ``TieredKVStore``s: unit-indexed
    calls route to the owning stage's store (stage-local index), slot
    operations fan out to every stage, and spill namespaces get a
    per-stage suffix (``{ns}/s{stage}/...``, still under the engine's
    ``{ns}/`` prefix cleanup)."""

    _UNIT_METHODS = ("load", "load_nbytes", "slab_nbytes", "save_nbytes",
                     "prefill_save_nbytes", "dequant_nbytes",
                     "save_prefill", "save_prefill_batch", "save_decode",
                     "has_kv", "leaf_meta")

    def __init__(self, stores, bounds):
        self.stores = list(stores)
        self.bounds = [tuple(b) for b in bounds]
        self.b_max = self.stores[0].b_max
        self.max_len = self.stores[0].max_len
        self.kv_mode = self.stores[0].kv_mode
        for name in self._UNIT_METHODS:
            setattr(self, name, self._unit_call(name))

    def _unit_call(self, name):
        def call(j, *args, **kwargs):
            for (lo, hi), st in zip(self.bounds, self.stores):
                if lo <= j < hi:
                    return getattr(st, name)(j - lo, *args, **kwargs)
            raise IndexError(f"unit {j} outside staged bounds {self.bounds}")
        return call

    def __len__(self):
        return sum(len(st) for st in self.stores)

    @property
    def dequant_bytes_total(self) -> int:
        return sum(st.dequant_bytes_total for st in self.stores)

    def max_live_load_nbytes(self, live_b: int, live_len: int) -> int:
        return max(st.max_live_load_nbytes(live_b, live_len)
                   for st in self.stores)

    def host_nbytes(self) -> int:
        return sum(st.host_nbytes() for st in self.stores)

    def truncate(self, slot: int, new_len: int) -> None:
        for st in self.stores:
            st.truncate(slot, new_len)

    def spill(self, host, ns: str, slot: int) -> None:
        for s, st in enumerate(self.stores):
            st.spill(host, f"{ns}/s{s}", slot)

    def restore(self, host, ns: str, slot: int) -> None:
        for s, st in enumerate(self.stores):
            st.restore(host, f"{ns}/s{s}", slot)


class _MeshStagedScheduler(StagedScheduler):
    """``StagedScheduler`` whose activation handoff moves the activation
    onto the receiving stage's device (``launch.mesh.stage_devices``):
    an asynchronous copy between cards, or nothing when the stages share
    one."""

    def __init__(self, *args, devices=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.devices = list(devices or [])

    def handoff(self, stage: int, it: int, x):
        if self.devices and isinstance(x, torch.Tensor):
            return x.to(self.devices[stage % len(self.devices)],
                        non_blocking=True)
        return x


class DrawCache:
    """Weights that offloaded engines of one model share across their
    builds: the drawn ``embed`` and ``final_norm`` tables and each
    layer's (and expert's) packed tensors, kept on the host by model
    config, seed, quant policy and table key.  An engine built with it
    takes what an earlier build of the same model and seed left and
    draws and packs only the rest: the same numbers, without the draw.
    It empties when its ``with`` block ends::

        with DrawCache() as draws:
            a = create_engine(plan, draws=draws)
            b = create_engine(other_plan_same_model, draws=draws)
    """

    def __init__(self):
        self._kept: Dict[tuple, Any] = {}

    def __enter__(self) -> "DrawCache":
        return self

    def __exit__(self, *exc):
        self._kept.clear()

    def tables(self, tag: tuple, keys, make):
        """``(key, value)`` for each of ``keys`` in order: the value kept
        under ``tag``, or else the next of ``make(missing keys)`` (a
        generator of ``(key, value)`` in the order of its keys), which
        is then kept."""
        keys = list(keys)
        fresh = make([k for k in keys if (tag, k) not in self._kept])
        for k in keys:
            if (tag, k) not in self._kept:
                k2, value = next(fresh)
                self._kept[tag, k2] = value
            yield k, self._kept[tag, k]


class OffloadedServingEngine(SlotEngineBase):
    """See module docstring.  Main-thread object: all public methods run
    on the caller's thread; weight/KV transfers run on the internal
    transfer pool."""

    def __init__(self, plan: "ResolvedPlan | ModelConfig", device="cuda",
                 draws: "DrawCache | None" = None, **legacy_kwargs):
        """Canonical construction takes a ``ResolvedPlan``
        (``EngineSpec.resolve()``; usually through
        ``serving.spec.create_engine``).  A ``ModelConfig`` plus the
        pre-spec keywords still works through a deprecation shim: the
        keywords become an ``EngineSpec``, which is resolved, so both
        paths act on the same plan."""
        if isinstance(plan, ModelConfig):
            warn_deprecated_once(
                "OffloadedServingEngine.legacy_kwargs",
                "OffloadedServingEngine(cfg, **kwargs) is deprecated; "
                "build an EngineSpec and pass its resolved plan "
                "(serving.spec.create_engine) instead")
            unknown = set(legacy_kwargs) - set(_LEGACY_DEFAULTS)
            if unknown:
                raise TypeError(f"unknown kwargs {sorted(unknown)}")
            plan = EngineSpec(arch=plan.name, cfg=plan, offload=True,
                              **{**_LEGACY_DEFAULTS, **legacy_kwargs}
                              ).resolve()
        elif not isinstance(plan, ResolvedPlan):
            raise TypeError(f"OffloadedServingEngine takes a ResolvedPlan "
                            f"or a ModelConfig, got {type(plan).__name__}")
        elif legacy_kwargs:
            raise TypeError("plan construction takes no kwargs; set the "
                            "fields on the EngineSpec instead")
        cfg = plan.model_config()
        cap = offload_capability(cfg)
        if cap is not None or plan.engine != "offloaded":
            raise UnsupportedModelError(
                cap or "resident_plan",
                f"offloaded serving supports token-frontend rope decoder "
                f"stacks only (failing capability: {cap or plan.engine}; "
                f"arch {plan.arch})")
        if any(s.mixer not in (ATTN, ATTN_LOCAL, MLA, SSM)
               for s in (*cfg.pattern, *cfg.remainder)):
            raise NotImplementedError(
                "the offloaded engine streams ATTN, ATTN_LOCAL, MLA and SSM "
                "stacks; a CROSS or ENC stack serves on the resident "
                "ServingEngine, which create_engine builds for its plan")
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
        self.n_stages = max(1, int(plan.stages or 1))
        self.stage_bounds = self._make_stage_bounds(cfg, plan)
        self.stage_devs = stage_devices(self.n_stages, self.dev)
        n_units = self._n_units(cfg)
        if self.n_stages > 1:
            # one transfer pool per stage, each sized to that stage's
            # window (the StagePlan depths come from the resolver's
            # per-stage budget split)
            sd = ([p.depth for p in plan.stage_plan]
                  if len(plan.stage_plan) == self.n_stages
                  else [max(1, plan.depth)] * self.n_stages)
            self._stage_depths = [
                PipelineScheduler.clamp_depth(plan.pipeline, hi - lo, d)
                for (lo, hi), d in zip(self.stage_bounds, sd)]
            self._stage_pools = [
                ThreadPool(PipelineScheduler.pool_size(d), self.trace,
                           device=dev)
                for d, dev in zip(self._stage_depths, self.stage_devs)]
            depth = max(self._stage_depths)
            pool = self._stage_pools[0]
        else:
            depth = PipelineScheduler.clamp_depth(plan.pipeline, n_units,
                                                  max(1, plan.depth))
            max_depth = PipelineScheduler.clamp_depth(
                plan.pipeline, n_units, self.preload_policy.max_depth())
            self._stage_depths = [depth]
            self._stage_pools = []
            pool = ThreadPool(
                PipelineScheduler.pool_size(max(depth, max_depth)),
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
        store = lambda device: TieredWeightStore(
            placement=plan.placement, host=self.host, device=device,
            disk=self.disk, quant=self.quant_policy.weight_mode,
            fused_int4=plan.fused_int4,
            block_bytes=plan.block_bytes or DEFAULT_BLOCK,
            n_io_threads=plan.n_io_threads, cold_reads=plan.cold_reads,
            sim_bw=plan.sim_bw)
        if self.n_stages > 1:
            # one tiered store per stage: each stage streams its slice
            # over its own link onto its own device
            self.weights = _StagedWeightStore(
                [store(self.device if dev == self.dev else DeviceStore(dev))
                 for dev in self.stage_devs],
                lambda key: self._stage_of_unit(self._unit_of_key(key)))
        else:
            self.weights = store(self.device)
        self._phase = "prefill"           # until the first _decode_active
        # chunked-prefill admission: at most ONE prefill in flight,
        # advanced one chunk per engine step
        self._chunk = None                # dict(slot, req, done, prefix)
        self._chunk_step = None           # (c0, c, final) during a step
        self._chunk_tok = 0               # first token, set at final chunk
        self.stats["preload_depth"] = depth
        self.stats["depth_resizes"] = 0
        # bytes of the expert tensors the compact MoE combines took:
        # loaded experts x per-expert bytes (packed under fused INT4),
        # never a bank
        self.stats["moe_stack_bytes"] = 0
        # every MoE gate's top-k: (unit key, logits (T, E) f32, k) ->
        # (weights, ids); a check swaps in one that records or holds
        # the routing
        self.route = lambda key, logits, k: moe_mod.router_topk(logits, k)
        self.units: List[_Unit] = []
        self._split_params(plan.seed, draws)
        # the bytes that never stream (embedding, untied head, final
        # norm, MoE routers), to report beside the plan's device budget
        resident = [t for tab in self.resident.values() for t in tab.values()]
        resident += [u.router for u in self.units if u.moe]
        self.resident_bytes = sum(t.numel() * t.element_size()
                                  for t in resident)
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
        if self.n_stages > 1:
            self.sched = _MeshStagedScheduler(
                self.stage_bounds, plan.pipeline, pools=self._stage_pools,
                trace=self.trace, warm=self.warm, depths=self._stage_depths,
                devices=self.stage_devs)
        else:
            self.sched = PipelineScheduler(len(self.units), plan.pipeline,
                                           pool=pool, trace=self.trace,
                                           warm=self.warm, depth=depth,
                                           device=self.dev)
        self.trace.meta.update(
            arch=plan.arch, b_max=plan.b_max, max_len=plan.max_len,
            sim_bw=plan.sim_bw, quant=plan.quant,
            kv_mode=plan.kv_mode or "fp32")
        # speculative decoding: a device-resident draft proposes spec_k
        # tokens per step; the streamed target verifies them in one
        # ragged k+1-position pass
        self.draft = None
        self._spec_k = 0
        self._spec_s = 1                  # rows the current step writes
        self._spec_emitted = None         # per-slot tokens of the last step
        for key in ("spec_steps", "spec_proposed", "spec_accepted"):
            self.stats[key] = 0
        dp = draft_policy_for(plan)
        if dp is not None:
            self.attach_draft(dp.build(b_max=plan.b_max,
                                       max_len=plan.max_len,
                                       device=self.dev), dp.k)

    @staticmethod
    def _n_units(cfg: ModelConfig) -> int:
        return cfg.num_periods * len(cfg.pattern) + len(cfg.remainder)

    # ---- pipeline-parallel staging ------------------------------------------
    def _make_stage_bounds(self, cfg: ModelConfig, plan) -> List[tuple]:
        """Contiguous per-stage unit ranges: the resolver's ``stage_plan``
        when it tiles this config, else a balanced split."""
        nu = self._n_units(cfg)
        if self.n_stages <= 1:
            return [(0, nu)]
        sp = plan.stage_plan
        if (len(sp) == self.n_stages and sp[0].layer_lo == 0
                and sp[-1].layer_hi == nu):
            return [(p.layer_lo, p.layer_hi) for p in sp]
        return [(round(s * nu / self.n_stages),
                 round((s + 1) * nu / self.n_stages))
                for s in range(self.n_stages)]

    def _unit_of_key(self, key: str) -> int:
        """Global unit index of a tiered-store key (``u[p][q]`` or
        ``rem[q]``)."""
        nums = [int(x) for x in re.findall(r"\[(\d+)\]", key)]
        if key.startswith("u["):
            return nums[0] * len(self.cfg.pattern) + nums[1]
        return self.cfg.num_periods * len(self.cfg.pattern) + nums[0]

    def _stage_of_unit(self, j: int) -> int:
        for s, (lo, hi) in enumerate(self.stage_bounds):
            if lo <= j < hi:
                return s
        raise IndexError(f"unit {j} outside stage bounds "
                         f"{self.stage_bounds}")

    # ---- weight tiering -----------------------------------------------------
    def _split_params(self, seed: int, draws: "DrawCache | None" = None):
        """The embedding, LM head and final norm go to the device; each
        layer's tensors (INT4-packed under ``quant="int4"``) merge into
        one tiered buffer.  An MoE layer splits further: its router goes
        to the device, and each expert is drawn and becomes a buffer of
        its own, so decode can load just the routed union.  Tables (and
        experts) are drawn on threads a few ahead, so at most that many
        f32 copies exist at once; ``draws`` keeps what is drawn and
        packed for later engines of the same model and seed, and gives
        what an earlier one kept.  Main thread, build time only."""
        cfg = self.cfg
        keys = [("embed", 0, 0), ("final_norm", 0, 0)]
        for part, q, p in T.table_keys(cfg):
            spec = (cfg.pattern if part == "pat" else cfg.remainder)[q]
            if spec.ffn == MOE:
                keys += [(part, q, p, e)
                         for e in (None, *range(cfg.moe.num_experts))]
            else:
                keys.append((part, q, p))

        def packed(keys):
            """(key, (tensors, router)): the resident tables as drawn, a
            layer's packed by the quant policy, an MoE layer's router
            ``wg`` kept apart and unpacked."""
            for key, tensors in T.draw_tables(cfg, seed, keys):
                if key[0] in ("embed", "final_norm"):
                    yield key, (tensors, None)
                    continue
                wg = tensors.pop("wg", None)
                yield key, (self.quant_policy.prepare_unit(tensors, self.dev),
                            wg)
        tables = packed(keys) if draws is None else draws.tables(
            (repr(cfg), seed, self.quant_policy.name, self.dev.type), keys,
            packed)
        self.resident = {}
        for key, (tensors, wg) in tables:
            part, q, p = key[:3]
            if part in ("embed", "final_norm"):
                self.resident[part] = {
                    name: self.device.put(f"{part}/{name}", arr)
                    for name, arr in tensors.items()}
            elif len(key) == 4 and key[3] is not None:
                u = self.units[-1]            # expert key[3] of this unit
                ek = f"{u.key}/exp[{key[3]}]"
                self.weights.put(ek, dict(tensors))
                u.expert_keys.append(ek)
            elif part == "pat":
                self._put_unit("pat", p, q, cfg.pattern[q], f"u[{p}][{q}]",
                               tensors, wg)
            else:
                self._put_unit("rem", 0, q, cfg.remainder[q], f"rem[{q}]",
                               tensors, wg)

    def _put_unit(self, group, p, q, spec, key, tensors, wg):
        u = _Unit(group, p, q, spec, key)
        if spec.ffn == MOE:
            u.moe = True
            u.router = self.device.put(f"{key}/wg", wg)
        self.weights.put(key, dict(tensors))
        self.units.append(u)

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
        store = lambda shapes, kinds, link, device: TieredKVStore(
            shapes, kinds, b_max=self.b_max, max_len=self.max_len,
            kv_mode=self.quant_policy.kv_mode, link=link, device=device,
            pin=self.dev.type == "cuda")
        if self.n_stages > 1:
            # one KV store per stage, on that stage's link and device
            self.kvstore = _StagedKVStore(
                [store(shapes[lo:hi], kk[lo:hi], self.weights.stores[s].link,
                       self.stage_devs[s])
                 for s, (lo, hi) in enumerate(self.stage_bounds)],
                self.stage_bounds)
        else:
            self.kvstore = store(shapes, kk, self.weights.link, self.dev)

    # ---- per-unit compute (main thread) -------------------------------------
    def _embed(self, tokens: np.ndarray) -> torch.Tensor:
        return L.embed_tokens(self.resident["embed"],
                              torch.from_numpy(np.asarray(tokens)).to(
                                  self.dev))

    def _head(self, x) -> np.ndarray:
        x = L.rms_norm(x.to(self.dev), self.resident["final_norm"]["scale"],
                       self.cfg.norm_eps)
        tok = L.lm_head_argmax(self.resident["embed"], x[:, -1:], self.cfg)
        return tok.cpu().numpy()

    def _spec_head(self, x) -> np.ndarray:
        """Per-position greedy tokens of a verify pass, (b, k+1)."""
        x = L.rms_norm(x.to(self.dev), self.resident["final_norm"]["scale"],
                       self.cfg.norm_eps)
        return L.lm_head_argmax_positions(self.resident["embed"], x,
                                          self.cfg).cpu().numpy()

    # ---- PipelineScheduler callbacks ----------------------------------------
    def is_mha(self, j: int) -> bool:
        """'Has streamed KV state' in scheduler terms (every unit with a
        cache: ATTN, ATTN_LOCAL, MLA and SSM)."""
        return bool(self.kv_kinds[j])

    def load_weights(self, j: int):
        """WEIGHT_LOAD body (transfer worker): the merged buffer only;
        the compute thread splits it (``compute``).  Unfused INT4
        dequantizes here, on the transfer thread, as the reference
        does."""
        return self._load_key(self.units[j].key)

    def _load_key(self, key: str):
        if self.quant == "int4" and not self.weights.fused_int4:
            return self.weights.load(key)
        return self.weights.fetch(key)

    def _loaded(self, key: str, handle, dev: torch.device):
        """A load's result as the unit's named tensors (main thread)."""
        adopt(dev, handle)
        if isinstance(handle, torch.Tensor):
            return self.weights.split(key, handle)
        return handle

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
        return self._phase                # "prefill" | "decode" | "chunk"

    def _kv_live(self, i: int):
        return self._live_extent(i)

    def _kv_streams(self, j: int) -> bool:
        return bool(self.kv_kinds[j])

    def _kv_prefill_save_nbytes(self, j: int) -> int:
        return self.kvstore.prefill_save_nbytes(j)

    def _kv_chunk_save_nbytes(self, j: int) -> int:
        """The in-flight prefill chunk's KV append: one slot's ``c`` fresh
        rows ride this step's KV_SAVE beside the decode rows."""
        if self._chunk_step is None:
            return 0
        _, c, _ = self._chunk_step
        return self.kvstore.save_nbytes(j, 1, rows=c)

    def save_kv(self, i: int, j: int, new_kv):
        """KV_SAVE body (transfer worker): scatter the fresh rows into the
        store, which quantizes them (once per row) under
        ``kv_mode='int4'``."""
        phase, payload, meta = new_kv
        if phase == "prefill":
            self.kvstore.save_prefill(j, meta, {n: l[0] for n, l in
                                                payload.items()})
        elif phase == "mixed":
            # a step carrying a prefill chunk: the decode batch's rows
            # (when a decode rode along), then the chunk's rows appended
            # at its offset through the same quantize-once row path, so
            # the stored bytes equal a monolithic prefill's
            if payload is not None:
                rows_d, (active, pos, live_b) = payload
                self.kvstore.save_decode(j, {n: l[:live_b] for n, l in
                                             rows_d.items()}, active, pos)
            k_ck, v_ck, slot, c0 = meta
            rows = {}
            for name, t in (("k", k_ck), ("v", v_ck)):
                a = t.to("cpu")                          # (1, c, *feat)
                buf = torch.zeros((slot + 1,) + tuple(a.shape[1:]),
                                  dtype=a.dtype)
                buf[slot] = a[0]
                rows[name] = buf
            self.kvstore.save_decode(j, rows, [slot],
                                     np.full(slot + 1, c0, np.int32))
        else:
            active, pos, live_b = meta
            self.kvstore.save_decode(j, {n: l[:live_b] for n, l in
                                         payload.items()}, active, pos)

    def _unit_dev(self, j: int) -> torch.device:
        return (self.stage_devs[self._stage_of_unit(j)]
                if self.n_stages > 1 else self.dev)

    def compute(self, i: int, j: int, x, weights, kv):
        """COMPUTE body (main thread): one unit's forward."""
        u = self.units[j]
        dev = self._unit_dev(j)
        weights = self._loaded(u.key, weights, dev)
        if self._phase == "prefill":
            ctx = L.Ctx(cfg=self.cfg, mode="prefill",
                        angles=_on(self._angles, dev))
            x, rows = u.apply(weights, x, ctx, None)
            payload = ("prefill", rows, self._slot)
        elif self._chunk_step is not None:
            return self._compute_mixed(j, u, x, weights, kv)
        else:
            x, (rows, meta) = self._decode_unit(u, x, weights, kv, dev)
            payload = ("decode", rows, meta)
        if u.moe:
            x = self._compute_moe(u, x, weights, dev)
        return x, payload

    def _compute_moe(self, u: _Unit, x, weights, dev):
        """Routed-union MoE (paper Appendix C.4): the gate runs and its
        ids cross to the host (the sync point: the experts are unknown
        until then); then ONLY the union of routed experts streams
        through the pool as WEIGHT_LOAD tasks while the shared expert
        computes, and the compact combine runs over the loaded experts
        with the ids remapped in order onto the sorted union, at the full
        bank's capacity (``moe_ffn``'s formula), so its slots and drops
        are the resident path's.  Main thread (loads on the workers)."""
        m = self.cfg.moe
        b, s, d = x.shape
        xn = L.rms_norm(x, weights["norm_ffn"], self.cfg.norm_eps)
        logits = (xn.reshape(b * s, d) @ u.router).to(torch.float32)
        gate_w, ids = self.route(u.key, logits, m.top_k)
        ids = ids.cpu().numpy()
        union = np.unique(ids)                 # sorted routed experts
        tasks = []
        for e in union:
            key = u.expert_keys[int(e)]
            t = Task(TaskType.WEIGHT_LOAD, f"w[{key}]",
                     lambda key=key: self._load_key(key))
            t.nbytes = self.weights.nbytes(key)
            self.sched.pool.submit(t)
            tasks.append((key, t))
        shared = L.shared_expert(weights, xn) if m.num_shared else None
        ids_u = torch.from_numpy(np.searchsorted(union, ids)).to(dev)
        experts = [self._loaded(key, t.wait(), dev) for key, t in tasks]
        self.stats["moe_stack_bytes"] += sum(
            a.numel() * a.element_size() for we in experts
            for a in we.values())
        capacity = int(m.capacity_factor * b * s * m.top_k
                       / m.num_experts) + 1
        out = moe_mod.moe_ffn_union(
            xn.reshape(b * s, d), gate_w, ids_u,
            {name: [we[name] for we in experts] for name in experts[0]},
            capacity)
        x = x + out.reshape(b, s, d)
        return x if shared is None else x + shared

    def _decode_unit(self, u: _Unit, x, weights, kv, dev=None):
        """The decode batch through one unit: its output, the fresh
        ``{name: (b, s, *feat)}`` rows the save ships (s = 1, or k+1 in a
        verify pass) and the save's ``(active, pos, live_b)``."""
        dev = dev or self.dev
        adopt(dev, kv)
        ctx = L.Ctx(cfg=self.cfg, mode="decode", angles=_on(self._angles, dev),
                    pos=_on(self._pos_dev, dev))
        x, rows = u.apply(weights, x, ctx, kv)
        return x, (rows, (self._active, self._pos_snap,
                          self._decode_view[1]))

    def _compute_mixed(self, j: int, u: _Unit, x, weights, kv):
        """One unit of a step carrying a prefill chunk (main thread): the
        decode batch (when present) and the chunk run back to back under
        the SAME weights handle — one WEIGHT_LOAD per unit serves both.
        The chunk attends the engine-held f32 prefix (earlier chunks'
        post-rope K/V, the values a monolithic prefill attends in-pass);
        its fresh rows append to the store through the step's KV_SAVE."""
        x_dec, x_ck = x
        dec = None
        if x_dec is not None:
            x_dec, dec = self._decode_unit(u, x_dec, weights, kv)
        pk, pv = self._chunk["prefix"].get(j, (None, None))
        c0, _, _ = self._chunk_step
        ctx = L.Ctx(cfg=self.cfg, mode="prefill", angles=self._chunk_angles)
        x_ck, k_ck, v_ck = L.apply_layer_chunk(weights, x_ck, ctx, pk, pv,
                                               c0)
        self._chunk["prefix"][j] = (
            k_ck if pk is None else torch.cat([pk, k_ck], dim=1),
            v_ck if pv is None else torch.cat([pv, v_ck], dim=1))
        return (x_dec, x_ck), ("mixed", dec,
                               (k_ck, v_ck, self._chunk["slot"], c0))

    def finalize(self, i: int, x):
        if self._chunk_step is not None:
            x_dec, x_ck = x
            if self._chunk_step[2]:
                # the chunked request's first token: the argmax at the
                # last prompt position, as the monolithic prefill's head
                self._chunk_tok = int(self._head(x_ck)[0])
            if x_dec is None:
                return np.zeros(self.b_max, np.int32)
            x = x_dec
        if self._phase == "decode" and x.shape[1] > 1:
            return self._spec_head(x)       # verify pass: (b, k+1)
        return self._head(x)

    # ---- SlotEngineBase compute hooks ---------------------------------------
    def _begin_chunked_prefill(self, slot: int, req: Request) -> int:
        """Admission-time hook: under a chunked policy, claim the slot
        and stage the prompt for chunk-at-a-time prefill interleaved with
        decode steps.  At most ONE chunked prefill is in flight; a second
        arrival waits (BUSY)."""
        if not self.sched_policy.chunked:
            return self.CHUNK_OFF
        if self._chunk is not None:
            return self.CHUNK_BUSY
        self._chunk = dict(slot=slot, req=req, done=0, prefix={})
        return self.CHUNK_STARTED

    def _chunk_slot(self):
        return self._chunk["slot"] if self._chunk is not None else None

    def _mixed_step(self, active: List[int]) -> np.ndarray:
        """One pipeline step carrying the next chunk of the in-flight
        chunked prefill, beside the decode batch when one exists (main
        thread).  Both ride the SAME ``sched.generate`` call.  The decode
        view widens to cover the chunk slot and extent, so warm tail
        preloads priced during this step stay valid once the chunk's
        rows land (rows past a slot's position are masked)."""
        ck = self._chunk
        req, slot = ck["req"], ck["slot"]
        cap = max(1, self.sched_policy.chunk_cap())
        c0 = ck["done"]
        c1 = min(len(req.prompt), c0 + cap)
        final = c1 == len(req.prompt)
        self._chunk_step = (c0, c1 - c0, final)
        if active:
            self._step_setup(active)
            base, lb, ll = self._decode_view
            self._decode_view = (base, max(lb, slot + 1), max(ll, c1))
            self._pos_dev = torch.from_numpy(self.pos.copy()).to(self.dev)
            self._angles = T._angles(self.cfg, self._pos_dev[:, None])
            x_dec = self._embed(self.tokens[:, None])
        else:
            # chunk-only step: nothing to load — the chunk attends only
            # the engine-held prefix of its own earlier chunks
            self._phase = "chunk"
            x_dec = None
        self._chunk_angles = T._angles(
            self.cfg, torch.arange(c0, c1, device=self.dev))
        x_ck = self._embed(np.asarray(req.prompt[c0:c1])[None])
        toks = self.sched.generate(self, lambda i: (x_dec, x_ck), 1)
        self.stats["prefill_chunks"] += 1
        ck["done"] = c1
        self._chunk_step = None
        if x_dec is None:
            # warm tail preloads captured phase "chunk" (value None)
            self.sched.drop_kv_preloads()
        if final:
            self._chunk = None            # frees the device-held prefix
            if self.draft is not None:
                self.draft.prefill_slot(slot, req.prompt)
            self._finish_prefill(slot, req, self._chunk_tok)
        return toks[-1]

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
        if self.draft is not None:
            # the draft is slaved to the same slot/pos state
            self.draft.prefill_slot(slot, req.prompt)
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

    def attach_draft(self, draft, k: int):
        """Enable speculative decoding with ``draft``: anything with
        ``prefill_slot(slot, prompt)`` and ``propose(tokens, pos, k) ->
        (b_max, k)`` (``core.draft.ResidentDraft``, or a test fake).
        Greedy accept/reject keeps the emitted stream equal to
        non-speculative decode for any proposal stream, so a draft whose
        cache went stale (a preempted request resumes without a draft
        prefill) costs acceptance, never tokens.  Main thread, between
        steps."""
        cap = spec_decode_capability(self.cfg)
        if cap is not None:
            raise UnsupportedModelError(
                cap, f"speculative decoding needs a global-attention "
                     f"dense decoder target (failing capability: {cap})")
        self.draft = draft
        self._spec_k = max(1, int(k))
        self.trace.meta.update(spec_k=self._spec_k)

    def _emitted_tokens(self, active, nt):
        if self._spec_emitted is not None:
            return self._spec_emitted
        return super()._emitted_tokens(active, nt)

    def _decode_active(self, active: List[int]) -> np.ndarray:
        """One batched decode step over every slot at its own position
        (main thread); with a chunked prefill in flight, the mixed step
        (the decode batch plus one prompt chunk under shared weight
        loads; speculation resumes after it); with a draft attached, a
        draft-then-verify step emitting up to ``spec_k + 1`` tokens per
        slot (``_emitted_tokens``)."""
        self._spec_emitted = None
        self._spec_s = 1
        if self._chunk is not None:
            return self._mixed_step(active)
        k = 0
        if self.draft is not None:
            # headroom: the verify writes rows pos..pos+k, and the last
            # emitted token must still fit under the max_len-1 release
            # bound the base class enforces per token
            head = self.max_len - 1 - int(max(self.pos[s] for s in active))
            k = max(0, min(self._spec_k, head))
        if k >= 1:
            return self._decode_spec(active, k)
        self._step_setup(active)
        self._pos_dev = torch.from_numpy(self.pos.copy()).to(self.dev)
        self._angles = T._angles(self.cfg, self._pos_dev[:, None])
        x0 = self._embed(self.tokens[:, None])
        toks = self.sched.generate(self, lambda i: x0, 1)
        return toks[-1]

    def _decode_spec(self, active: List[int], k: int) -> np.ndarray:
        """Draft-then-verify decode step (main thread): the draft proposes
        ``k`` tokens while ``prime_weights`` streams the verify pass's
        first weight loads over the otherwise idle link; the target scores
        all ``k+1`` positions in one trip through the streamed stack, and
        the greedy accept rule (``core.draft.accepted_tokens``) emits the
        longest prefix that matches non-speculative decode plus the
        target's bonus token."""
        self._step_setup(active)
        self._spec_s = k + 1
        t0 = time.perf_counter()
        primed = self.sched.prime_weights(self)
        props = np.asarray(self.draft.propose(self.tokens, self.pos, k),
                           np.int32)                       # (b_max, k)
        draft_s = time.perf_counter() - t0
        # verify input: [current token, d1..dk] at positions pos..pos+k
        seq = np.concatenate(
            [np.asarray(self.tokens, np.int32)[:, None], props], axis=1)
        self._pos_dev = torch.from_numpy(self.pos.copy()).to(self.dev)
        pos_mat = (self._pos_dev[:, None]
                   + torch.arange(k + 1, device=self.dev)[None, :])
        self._angles = T._angles(self.cfg, pos_mat)
        x0 = self._embed(seq)
        tgt = np.asarray(self.sched.generate(self, lambda i: x0, 1)[-1])
        # saves in flight would re-write rejected rows after the truncate:
        # drain first.  The KV preloads in flight are stale either way (a
        # verify pass advances the extent by up to k+1, past the +1 the
        # warm tail priced), and so are their memoized extents: a stale
        # memo would under-ship rows the next step's mask admits
        self.sched.drain_saves()
        self.sched.drop_kv_preloads()
        self._extent_memo.clear()
        emitted: Dict[int, List[int]] = {}
        accepts = []
        for i in active:
            acc = accepted_tokens(props[i], tgt[i])
            emitted[i] = acc
            accepts.append(len(acc) - 1)
            # valid rows: inputs [cur, d1..da] at pos..pos+a
            self.kvstore.truncate(i, int(self._pos_snap[i]) + len(acc))
        self._spec_emitted = emitted
        self.stats["spec_steps"] += 1
        self.stats["spec_proposed"] += k * len(active)
        self.stats["spec_accepted"] += int(sum(accepts))
        self.trace.meta.setdefault("spec_steps", []).append(dict(
            k=int(k), primed=int(primed), draft_s=float(draft_s),
            accepts=[int(a) for a in accepts]))
        nt = np.zeros(self.b_max, np.int32)
        for i in active:
            nt[i] = emitted[i][-1]
        return nt

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
        """Drain slot spills and pipeline saves, stop the pool(s).  A
        staged engine owns one pool per stage; pool 0 doubles as the slot
        spill pool and stops last."""
        super().shutdown()
        self.sched.shutdown()
        for p in self._stage_pools[1:]:
            p.shutdown()
        self._kv_pool.shutdown()


def _on(t, dev: torch.device):
    """``t`` on ``dev`` (the unit's stage device); None stays None."""
    return t if t is None or t.device == dev else t.to(dev)
