"""PipelinedLM: generation whose weights and KV live in memory tiers and
move through the PIPO pipeline (the paper's system, end to end), ported
to PyTorch and CUDA.

Layer granularity follows the paper: the schedulable unit list is
[mha_0, mlp_0, mha_1, mlp_1, ...].  Per unit, weights are merged into one
contiguous buffer on the placement tier (device/host/disk); the KV cache
lives in ``core.kvstore.TieredKVStore`` (``cache_on="host"``, live rows
per load) or stays on the device (``cache_on="device"``).

Compute runs on the main thread on PyTorch's current stream; weight
loads, KV loads and KV saves run on the transfer pool, each worker on its
own stream (``core.pipeline``).  On the card the units go through the
port's hand-written kernels: ``flash_attention`` (prefill),
``decode_attention`` (decode over an fp32 cache) or, with
``kv_mode="int4"``, ``decode_attention_int4`` over the packed rows the
store ships (the step's own row attended unquantized), and, with
``quant="int4"`` and ``fused_int4``, ``int4_matmul`` for every packed
projection, whose ``#q``/``#s`` pairs stay packed on the device.

MoE stacks (paper Appendix C.4): the unit list is [mha_0, moe_0, ...];
each layer's router stays on the device and each expert is a store
buffer of its own (``exp[l][e]``).  The gate runs on the unit's input
and its ids cross to the host (the sync point); then only the routed
experts load, through the pool, while the shared expert (``shx[l]``, the
unit's own buffer) computes, and each routed expert runs on the full
batch weighted by its router weight (``_compute_moe``).

Speculative decoding (a plan with ``draft_arch``, or ``attach_draft``):
a device-resident draft proposes ``k`` tokens per step and the streamed
target scores all ``k+1`` positions in one trip through the stack
(``_decode_spec``); the batch advances by the shortest accepted run over
its rows, so the tokens equal non-speculative greedy decode.  Dense
stacks only.  A plan's ``stages`` is not read here: batch generation
runs one stage, as the JAX engine does.

Like the JAX engine, the units read neither ``window`` nor ``qk_norm``:
a Gemma 3 stack runs every layer as global attention over the
``max_len`` cache, and a Qwen3 stack draws no ``q_norm``/``k_norm``
(reference behaviour, ROADMAP Queue 3 item 9).  Nor do they read
``cfg.mla``: a DeepSeek stack runs as ``num_heads``-head MHA at
``head_dim`` (rope over the whole head) with MoE units, its shared expert
at ``d_ff`` (reference behaviour, ROADMAP Queue 3 item 11).  Nor
``cfg.ssm``: a Mamba2 or jamba stack runs as ``mha`` units at
``num_heads`` x ``head_dim`` with MLP or MoE units at ``d_ff``; at
mamba2-1.3b's full width (``num_heads`` 0, ``d_ff`` 0) the first MLP
unit's draw divides by ``d_ff`` and raises ``ZeroDivisionError``, as in
the JAX engine (reference behaviour, ROADMAP Queue 3 item 15).  Nor
the encoder, the cross attention or M-RoPE: whisper runs as its decoder's
self-attention ``mha`` and ``mlp`` units with 1-D rope at its
``rope_theta`` of 0, whose angles are NaN past position 0 (0 times the
infinite frequencies), so its greedy tokens are all 0; qwen2-vl runs with
1-D rope (reference behaviour, ROADMAP Queue 3 item 19).
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import convert
from repro_torch.core.draft import accept_length
from repro_torch.core.kvstore import (PackedRows, PhasedKVExtents,
                                      TieredKVStore)
from repro_torch.core.offload import DeviceStore, DiskStore, HostStore
from repro_torch.core.pipeline import PipelineScheduler, adopt
from repro_torch.core.tasks import Task, TaskType, Trace
from repro_torch.core.transfer import DEFAULT_BLOCK, Manifest, TieredWeightStore
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.attention import (decode_attention,
                                         decode_attention_packed,
                                         spec_decode_attention,
                                         spec_decode_attention_packed)
from repro_torch.models.common import rms_norm, silu
from repro_torch.models.layers import _mm as _proj
from repro_torch.models.moe import router_topk
from repro_torch.models.rope import apply_rope, rope_angles
from repro_torch.quant.int4 import quantize_int4
from repro_torch.serving.spec import (EngineSpec, ResolvedPlan,
                                      draft_policy_for,
                                      warn_deprecated_once)

# the pre-spec constructor's defaults: the deprecation shim overlays the
# given keywords on these, so a legacy call resolves to the plan the JAX
# package's shim resolves (depth defaulted to 1 here, not auto)
_LEGACY_DEFAULTS = dict(
    batch=4, max_len=256, placement="host", cache_on="host",
    pipeline="performance", quant=None, kv_mode=None, fused_int4=True,
    disk_root="/tmp/pipo_disk", block_bytes=None, n_io_threads=3,
    cold_reads=False, seed=0, depth=1)

# ---------------------------------------------------------------------------
# Per-unit compute
# ---------------------------------------------------------------------------


def _qkv(x, w, pos, cfg: ModelConfig):
    """pos: int, or a (b,) tensor of ragged start positions."""
    b, s, d = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, w["norm"], cfg.norm_eps)
    q = _proj(xn, w, "wq").reshape(b, s, h, dh)
    k = _proj(xn, w, "wk").reshape(b, s, hkv, dh)
    v = _proj(xn, w, "wv").reshape(b, s, hkv, dh)
    steps = torch.arange(s, device=x.device)
    if isinstance(pos, torch.Tensor):
        positions = pos.to(x.device)[:, None] + steps[None, :]   # (b, s)
    else:
        positions = int(pos) + steps                               # (s,)
    angles = rope_angles(positions, dh, cfg.rope_theta)
    return apply_rope(q, angles), apply_rope(k, angles), v


def _attn_prefill_unit(x, w, *, cfg: ModelConfig):
    """Prefill attends within the prompt only (through the
    ``flash_attention`` kernel).  Returns (x', k_new, v_new)."""
    b, s, d = x.shape
    q, k, v = _qkv(x, w, 0, cfg)
    out = flash_attention_op(q, k, v, causal=True)
    return x + _proj(out.reshape(b, s, -1), w, "wo"), k, v


def _attn_decode_unit(x, w, kc, vc, pos, *, cfg: ModelConfig):
    """x (b, s, d): s == 1 for plain decode, k+1 for a speculative verify
    pass (the current token and the draft's proposals from ``pos``, int
    or ragged (b,) tensor).  kc/vc (b, L, hkv, dh) device caches, updated
    in place at ``pos..pos+s-1`` and attended through the
    ``decode_attention`` kernel (one launch per query position), or
    ``PackedRows`` attended with each query's fresh row through
    ``decode_attention_int4`` (a verify pass writes its earlier rows into
    them packed).  Returns (x', k_new, v_new, kc, vc)."""
    b, s, d = x.shape
    q, k, v = _qkv(x, w, pos, cfg)
    if isinstance(kc, PackedRows):
        fn = spec_decode_attention_packed if s > 1 else decode_attention_packed
        out = fn(q, kc, vc, k, v, pos)
    else:
        fn = spec_decode_attention if s > 1 else decode_attention
        out, kc, vc = fn(q, kc, vc, k, v, pos)
    return x + _proj(out.reshape(b, s, -1), w, "wo"), k, v, kc, vc


def _mlp_unit(x, w, *, cfg: ModelConfig):
    xn = rms_norm(x, w["norm"], cfg.norm_eps)
    hdn = silu(_proj(xn, w, "w_gate")) * _proj(xn, w, "w_up")
    return x + _proj(hdn, w, "w_down")


def _gate_unit(x, wg, *, top_k: int):
    """Router: (weights (b*s, k), ids (b*s, k)) for the flat batch."""
    b, s, d = x.shape
    return router_topk(x.reshape(b * s, d) @ wg, top_k)


def _expert_unit(x, w, *, cfg: ModelConfig):
    """One expert's FFN on the full batch (its own norm; combined with
    the router weights outside)."""
    xn = rms_norm(x, w["norm"], cfg.norm_eps)
    hdn = silu(_proj(xn, w, "w_gate")) * _proj(xn, w, "w_up")
    return _proj(hdn, w, "w_down")


def _embed_unit(tokens, emb):
    return emb[tokens.long()]


def _head_unit(x, emb):
    return torch.argmax(x[:, -1].to(torch.float32) @ emb.T, dim=-1)


def _spec_head_unit(x, emb):
    """Per-position greedy argmax for the verify pass: each of the b*s
    rows goes through ``_head_unit``'s row arithmetic.  x (b, s, d) ->
    (b, s)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d).to(torch.float32) @ emb.T
    return torch.argmax(flat, dim=-1).reshape(b, s)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclass
class UnitSpec:
    kind: str           # "mha" | "mlp" | "moe"
    layer: int
    key: str            # store key (a "moe" unit's: its shared expert)


class PipelinedLM(PhasedKVExtents):
    """Offloaded generation per PIPO.

    placement: "device" | "host" | "disk" — where the merged unit weights
    live.  cache_on: "host" | "device".  pipeline: "performance" |
    "memory" | "sequential".  quant: None | "int4".  depth: performance-
    pipeline preload window.  ``device``: where compute runs (CUDA unless
    the caller passes "cpu").  ``weights``: another engine's weights
    (``core.convert.lm_weights``) to load instead of drawing them from
    ``plan.seed``."""

    def __init__(self, plan: "ResolvedPlan | ModelConfig", device="cuda",
                 weights=None, **legacy_kwargs):
        """Canonical construction takes a ``ResolvedPlan``
        (``serving.spec.build_lm(plan)``; its ``b_max`` is the batch).
        A ``ModelConfig`` plus the pre-spec keywords still works through
        a deprecation shim: the keywords become an ``EngineSpec``, which
        is resolved, so both paths act on the same plan."""
        if isinstance(plan, ModelConfig):
            warn_deprecated_once(
                "PipelinedLM.legacy_kwargs",
                "PipelinedLM(cfg, **kwargs) is deprecated; build an "
                "EngineSpec and pass its resolved plan "
                "(serving.spec.build_lm) instead")
            unknown = set(legacy_kwargs) - set(_LEGACY_DEFAULTS)
            if unknown:
                raise TypeError(f"unknown kwargs {sorted(unknown)}")
            kw = {**_LEGACY_DEFAULTS, **legacy_kwargs}
            kw["b_max"] = kw.pop("batch")
            plan = EngineSpec(arch=plan.name, cfg=plan, offload=True,
                              **kw).resolve()
        elif not isinstance(plan, ResolvedPlan):
            raise TypeError(f"PipelinedLM takes a ResolvedPlan or a "
                            f"ModelConfig, got {type(plan).__name__}")
        elif legacy_kwargs:
            raise TypeError("plan construction takes no kwargs; set the "
                            "fields on the EngineSpec instead")
        cfg = plan.model_config()
        self.dev = resolve_device(device)
        self.plan = plan
        self.cfg = cfg
        self.batch = plan.b_max
        self.max_len = plan.max_len
        self.placement = plan.placement
        self.cache_on = plan.cache_on
        self.quant = plan.quant
        self.kv_mode = plan.kv_mode or "fp32"
        self.depth = max(1, plan.depth)
        self.pipeline_mode = plan.pipeline
        self.trace = Trace()
        self.host = HostStore(pin=self.dev.type == "cuda")
        self.device = DeviceStore(self.dev)
        self.disk = (DiskStore(plan.disk_root or os.path.join(
            tempfile.gettempdir(), "pipo_torch_disk"))
            if plan.placement == "disk" else None)
        self.weights = TieredWeightStore(
            placement=plan.placement, host=self.host, device=self.device,
            disk=self.disk, quant=plan.quant, fused_int4=plan.fused_int4,
            block_bytes=plan.block_bytes or DEFAULT_BLOCK,
            n_io_threads=plan.n_io_threads, cold_reads=plan.cold_reads,
            sim_bw=plan.sim_bw)
        self.units: list[UnitSpec] = []
        self._layout()
        if weights is None:
            self._build(plan.seed)
        else:
            emb, units, routers = weights
            convert.from_reference(emb, units, self, routers)
        self._pool = None                # the scheduler's, set by generate
        self._kv_init()
        # speculative decoding: the draft proposes, the streamed target
        # verifies k+1 positions per trip
        self.draft = None
        self._spec_k = 0
        self._spec_s = 1                 # rows the current step writes
        self._spec_mode = False
        self._iter_pos: Dict[int, int] = {}   # global iter -> start pos
        dp = draft_policy_for(plan)
        if dp is not None:
            self.attach_draft(dp.build(b_max=plan.b_max,
                                       max_len=plan.max_len,
                                       device=self.dev), dp.k)

    def attach_draft(self, draft, k: int):
        """Enable speculative decoding with ``draft``: anything with
        ``prefill_batch(tokens)`` and ``propose(tokens, pos, k) -> (batch,
        k)`` (``core.draft.ResidentDraft``, or a test fake).  The uniform
        batch advances all rows in lockstep, so a step accepts the
        shortest accepted run over its rows; rows that accepted more
        re-derive their surplus next step.  Main thread, before
        ``generate``."""
        if self.cfg.moe is not None:
            raise ValueError(
                "speculative decoding needs a dense stack: routing k+1 "
                "tokens jointly would change MoE capacity assignment "
                "versus sequential decode, breaking token parity")
        self.draft = draft
        self._spec_k = max(1, int(k))

    # -- weights -------------------------------------------------------------
    def _unit_tensors(self, kind: str, rng: np.random.Generator):
        """The JAX engine's draws, in its order, from the shared ``rng``.
        With ``quant="int4"`` every 2-D tensor whose first dim is a
        multiple of 128 is quantized at group 128 (quantized on the
        engine's device; bit-identical to the CPU result)."""
        cfg = self.cfg
        d, h, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        s = 1.0 / math.sqrt(d)
        mk = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
        if kind == "mha":
            t = {"wq": mk(d, h * dh), "wk": mk(d, hkv * dh),
                 "wv": mk(d, hkv * dh), "wo": mk(h * dh, d),
                 "norm": np.zeros((d,), np.float32)}
        else:
            t = {"w_gate": mk(d, cfg.d_ff), "w_up": mk(d, cfg.d_ff),
                 "w_down": mk(cfg.d_ff, d) * (1.0 / math.sqrt(cfg.d_ff / d)),
                 "norm": np.zeros((d,), np.float32)}
        if self.quant == "int4":
            qt = {}
            for name, arr in t.items():
                if arr.ndim == 2 and arr.shape[0] % 128 == 0:
                    packed, scale = quantize_int4(
                        torch.from_numpy(arr).to(self.dev))
                    qt[name + "#q"] = packed.cpu().numpy()
                    qt[name + "#s"] = scale.cpu().numpy()
                else:
                    qt[name] = arr
            t = qt
        return t

    @property
    def manifests(self) -> Dict[str, Manifest]:
        return self.weights.manifests

    def _layout(self):
        """The unit list: [mha_0, mlp_0 | moe_0, mha_1, ...]."""
        for l in range(self.cfg.num_layers):
            self.units.append(UnitSpec("mha", l, f"mha[{l}]"))
            self.units.append(UnitSpec("mlp", l, f"mlp[{l}]")
                              if self.cfg.moe is None
                              else UnitSpec("moe", l, f"shx[{l}]"))

    def store_keys(self):
        """Every store buffer's key, in build order: the units', and for
        an MoE layer its experts' then its shared expert's (when it has
        one)."""
        moe = self.cfg.moe
        keys = []
        for u in self.units:
            if u.kind == "moe":
                keys += [f"exp[{u.layer}][{e}]"
                         for e in range(moe.num_experts)]
                if not moe.num_shared:
                    continue
            keys.append(u.key)
        return keys

    def _build(self, seed: int):
        """The JAX engine's draws, in its order, from one generator: the
        embedding, then per layer the attention unit and, for an MoE
        layer, its router, experts 0..E-1 and shared expert."""
        cfg = self.cfg
        moe = cfg.moe
        rng = np.random.default_rng(seed)
        emb = (rng.standard_normal((cfg.vocab_size, cfg.d_model))
               * (1.0 / math.sqrt(cfg.d_model))).astype(np.float32)
        self.device.put("emb", emb)      # embeddings stay on device (small)
        for l in range(cfg.num_layers):
            self.weights.put(f"mha[{l}]", self._unit_tensors("mha", rng))
            if moe is None:
                self.weights.put(f"mlp[{l}]", self._unit_tensors("mlp", rng))
                continue
            d = cfg.d_model
            self.device.put(f"wg[{l}]",
                            (rng.standard_normal((d, moe.num_experts))
                             / math.sqrt(d)).astype(np.float32))
            for e in range(moe.num_experts):
                self.weights.put(f"exp[{l}][{e}]",
                                 self._unit_tensors("mlp", rng))
            if moe.num_shared:
                self.weights.put(f"shx[{l}]", self._unit_tensors("mlp", rng))

    # -- KV cache --------------------------------------------------------------
    def _kv_init(self):
        cfg = self.cfg
        shape = (self.batch, self.max_len, cfg.num_kv_heads, cfg.head_dim)
        if self.cache_on == "host":
            shapes = [({"k": (shape, np.float32), "v": (shape, np.float32)}
                       if u.kind == "mha" else {}) for u in self.units]
            kinds = [({"k": "kv", "v": "kv"} if u.kind == "mha" else {})
                     for u in self.units]
            self.kvstore = TieredKVStore(
                shapes, kinds, b_max=self.batch, max_len=self.max_len,
                kv_mode=self.kv_mode, link=self.weights.link,
                device=self.dev, pin=self.dev.type == "cuda")
        else:
            self.kvstore = None
            for l in range(cfg.num_layers):
                self.device.put(f"kc[{l}]", torch.zeros(shape))
                self.device.put(f"vc[{l}]", torch.zeros(shape))

    # -- scheduler callbacks ------------------------------------------------------
    def is_mha(self, j: int) -> bool:
        return self.units[j].kind == "mha"

    def load_weights(self, j: int):
        """WEIGHT_LOAD body (transfer worker): the merged buffer only; the
        compute thread splits it (``compute``), so the worker makes one
        PyTorch call.  Unfused INT4 dequantizes here, on the transfer
        thread, as the JAX engine does."""
        u = self.units[j]
        if u.kind == "moe" and not self.cfg.moe.num_shared:
            return {}
        return self._load_key(u.key)

    def _load_key(self, key: str):
        if self.quant == "int4" and not self.weights.fused_int4:
            return self.weights.load(key)
        return self.weights.fetch(key)

    def _loaded(self, key: str, handle):
        """A load's result as named tensors (main thread)."""
        adopt(self.dev, handle)
        if isinstance(handle, torch.Tensor):
            return self.weights.split(key, handle)
        return handle

    def weight_nbytes(self, j: int) -> int:
        """Bytes unit j's WEIGHT_LOAD moves (trace byte accounting)."""
        u = self.units[j]
        if u.kind == "moe" and not self.cfg.moe.num_shared:
            return 0
        return self.weights.nbytes(u.key)

    def release_weights(self, j: int, handle):
        del handle  # device tensors freed when the last reference goes

    def _live_len(self, i: int) -> int:
        """Rows iteration ``i``'s decode attention reads: the prompt plus
        the decode rows already saved.  Iteration 0 is the prefill.  A
        speculative step advances by 1..k+1 rows, so its start positions
        are planned on the main thread before submission (``_iter_pos``;
        the next iteration at full acceptance, a superset when rows are
        rejected, whose extra rows are zeros the mask ignores)."""
        if self._spec_mode:
            return min(self._iter_pos.get(i, self.max_len), self.max_len)
        return min(self._prompt_len + i - 1, self.max_len)

    def _kv_phase(self, i: int) -> str:
        return "prefill" if i == 0 else "decode"

    def _kv_live(self, i: int):
        return (self.batch, self._live_len(i))

    def _kv_streams(self, j: int) -> bool:
        return self.cache_on == "host" and self.is_mha(j)

    def _kv_prefill_save_nbytes(self, j: int) -> int:
        return self.kvstore.prefill_save_nbytes(j, self.batch,
                                                self._prompt_len)

    def load_kv(self, i: int, j: int):
        if self.cache_on == "device":
            l = self.units[j].layer
            return {"k": self.device.get(f"kc[{l}]"),
                    "v": self.device.get(f"vc[{l}]")}
        return super().load_kv(i, j)

    def save_kv(self, i: int, j: int, new_kv):
        phase, k_new, v_new, pos, length = new_kv
        if self.cache_on == "device":
            # the decode step already wrote its row into the device cache
            # in place; the prefill scatters the prompt's rows here
            if phase == "prefill":
                l = self.units[j].layer
                self.device.get(f"kc[{l}]")[:, :length] = k_new
                self.device.get(f"vc[{l}]")[:, :length] = v_new
            return
        rows = {"k": k_new, "v": v_new}
        if phase == "prefill":
            self.kvstore.save_prefill_batch(j, rows, length)
        else:
            self.kvstore.save_decode(j, rows, active=range(self.batch),
                                     pos=np.full(self.batch, pos, np.int32))

    def compute(self, i: int, j: int, x, weights, kv):
        u = self.units[j]
        weights = self._loaded(u.key, weights)
        if u.kind == "mlp":
            return _mlp_unit(x, weights, cfg=self.cfg), None
        if u.kind == "moe":
            return self._compute_moe(u, x, weights), None
        if self._phase == "prefill":
            x, k, v = _attn_prefill_unit(x, weights, cfg=self.cfg)
            return x, ("prefill", k, v, 0, x.shape[1])
        adopt(self.dev, kv)
        pos = self._pos
        x, k, v, kc, vc = _attn_decode_unit(x, weights, kv["k"], kv["v"],
                                            pos, cfg=self.cfg)
        return x, ("decode", k, v, pos, x.shape[1])

    def _compute_moe(self, u: UnitSpec, x, shared_w):
        """Paper Appendix C.4: the gate forces a sync (the experts are
        unknown until it runs); then the union of routed experts loads
        through the pool while the shared expert (and earlier-arrived
        experts) compute — one expert's compute overlaps the next one's
        weight load.  Each expert runs on the full batch."""
        moe = self.cfg.moe
        b, s, d = x.shape
        wts, ids = _gate_unit(x, self.device.get(f"wg[{u.layer}]"),
                              top_k=moe.top_k)
        union = sorted(set(ids.cpu().numpy().reshape(-1).tolist()))
        tasks = []
        for e in union:
            key = f"exp[{u.layer}][{e}]"
            t = Task(TaskType.WEIGHT_LOAD, key,
                     lambda key=key: self._load_key(key))
            t.nbytes = self.weights.nbytes(key)
            self._pool.submit(t)
            tasks.append((e, key, t))
        out = torch.zeros_like(x)
        if moe.num_shared and shared_w:
            out = out + _expert_unit(x, shared_w, cfg=self.cfg)
        for e, key, t in tasks:
            ye = _expert_unit(x, self._loaded(key, t.wait()), cfg=self.cfg)
            w_e = torch.where(ids == e, wts, 0.0).sum(-1).reshape(b, s, 1)
            out = out + ye * w_e.to(ye.dtype)
        return x + out

    def finalize(self, i: int, x):
        if self._phase == "decode" and x.shape[1] > 1:
            # speculative verify: per-position argmax, (b, k+1)
            tok = _spec_head_unit(x, self.device.get("emb"))
        else:
            tok = _head_unit(x, self.device.get("emb"))
        self._last_tokens = tok.cpu().numpy().astype(np.int32)
        return self._last_tokens

    # -- public API -----------------------------------------------------------
    @torch.no_grad()
    def generate(self, prompt: np.ndarray, gen_len: int, pool=None):
        """prompt (b, s) int32.  Greedy-generates gen_len tokens.  Returns
        (tokens (b, gen_len), stats dict).  ``pool`` injects a transfer
        pool (e.g. ``VirtualPool`` for virtual-clock byte tests); its
        trace becomes the engine's.  Runs with grad mode off."""
        b, s = prompt.shape
        if b != self.batch or s + gen_len > self.max_len:
            raise ValueError(f"prompt {prompt.shape} + gen_len {gen_len} "
                             f"does not fit batch {self.batch}, max_len "
                             f"{self.max_len}")
        cfg = self.cfg
        self._prompt_len = s
        if pool is not None and getattr(pool, "trace", None) is not None:
            self.trace = pool.trace
        sched = PipelineScheduler(len(self.units), self.pipeline_mode,
                                  pool=pool, trace=self.trace,
                                  warm=self.pipeline_mode == "performance",
                                  depth=self.depth, device=self.dev)
        self._pool = sched.pool
        self.trace.meta.update(
            arch=cfg.name, b_max=self.batch, max_len=self.max_len,
            sim_bw=self.plan.sim_bw, quant=self.quant,
            kv_mode=self.kv_mode)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        outs = []
        emb = self.device.get("emb")

        # ---- prefill (iteration 0 processes the whole prompt) ----
        self._phase, self._pos = "prefill", 0
        x_prompt = _embed_unit(torch.from_numpy(prompt).to(self.dev), emb)
        outs.append(sched.generate(self, lambda i: x_prompt, 1)[-1])
        t_first = time.perf_counter() - t0

        # ---- decode ----
        self._phase = "decode"
        spec = {"spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0}
        if self.draft is None:
            for t in range(1, gen_len):
                self._pos = s + t - 1
                x_tok = _embed_unit(
                    torch.from_numpy(outs[-1][:, None]).to(self.dev), emb)
                outs.append(sched.generate(self, lambda i: x_tok, 1)[-1])
        else:
            self._decode_spec(sched, prompt, gen_len, outs, emb, spec)
        sched.shutdown()
        dt = time.perf_counter() - t0
        toks = np.stack(outs, axis=1)
        stats = {
            "ttft_s": t_first,
            "total_s": dt,
            "decode_tok_s": b * (gen_len - 1) / max(1e-9, dt - t_first),
            "throughput_tok_s": b * gen_len / dt,
            "compute_busy": self.trace.busy_fraction("compute"),
            "host_peak_gb": self.host.peak_bytes / 2**30,
            "device_peak_gb": self.device.peak_bytes / 2**30,
            "pipeline": self.trace.report(),
            **spec,
        }
        if self.dev.type == "cuda":
            stats["device_max_allocated_gb"] = \
                torch.cuda.max_memory_allocated(self.dev) / 2**30
        return toks, stats

    def _decode_spec(self, sched, prompt, gen_len, outs, emb, spec):
        """Draft-then-verify decode loop (main thread).  Each step: the
        draft proposes ``k`` tokens while ``prime_weights`` streams the
        verify pass's first weight loads; the target scores all ``k+1``
        positions in one trip through the stack; the batch advances by
        the shortest accepted run over its rows.  Rejection drains the
        saves, drops the warm KV preloads (priced at full acceptance) and
        truncates the store's rejected rows; full acceptance keeps
        them."""
        s = prompt.shape[1]
        self._iter_pos.clear()
        # plan the first decode iteration BEFORE flipping the mode flag:
        # the prefill's warm tail preload may be in flight and must ship
        # the extent it was priced at
        self._iter_pos[sched._iter0] = s
        self._spec_mode = True
        self.draft.prefill_batch(prompt)
        try:
            while len(outs) < gen_len:
                pos = s + len(outs) - 1
                self._pos = pos
                remaining = gen_len - len(outs)
                k = min(self._spec_k, remaining - 1, self.max_len - 1 - pos)
                gi = sched._iter0
                if k < 1:
                    self._spec_s = 1
                    self._iter_pos[gi] = pos
                    self._iter_pos[gi + 1] = pos + 1
                    x_tok = _embed_unit(
                        torch.from_numpy(outs[-1][:, None]).to(self.dev), emb)
                    outs.append(sched.generate(self, lambda i: x_tok, 1)[-1])
                    continue
                self._spec_s = k + 1
                self._iter_pos[gi] = pos
                self._iter_pos[gi + 1] = pos + k + 1   # full-accept plan
                t0 = time.perf_counter()
                primed = sched.prime_weights(self)
                props = np.asarray(self.draft.propose(
                    outs[-1], np.full(self.batch, pos, np.int32), k),
                    np.int32)                          # (b, k)
                draft_s = time.perf_counter() - t0
                seq = np.concatenate(
                    [np.asarray(outs[-1], np.int32)[:, None], props], axis=1)
                x_tok = _embed_unit(torch.from_numpy(seq).to(self.dev), emb)
                tgt = sched.generate(self, lambda i: x_tok, 1)[-1]  # (b, k+1)
                a_min = min(accept_length(props[r], tgt[r])
                            for r in range(self.batch))
                emitted = min(a_min + 1, remaining)
                for t in range(emitted):
                    outs.append(tgt[:, t])
                if emitted < k + 1:
                    # rejected (or generation-capped) rows: saves in
                    # flight would re-write them after the truncate, and
                    # the warm KV preloads priced the full-accept extent
                    sched.drain_saves()
                    sched.drop_kv_preloads()
                    if self.kvstore is not None:
                        for r in range(self.batch):
                            self.kvstore.truncate(r, pos + emitted)
                spec["spec_steps"] += 1
                spec["spec_proposed"] += k * self.batch
                spec["spec_accepted"] += int(a_min) * self.batch
                self.trace.meta.setdefault("spec_steps", []).append(dict(
                    k=int(k), primed=int(primed), draft_s=float(draft_s),
                    accepts=[int(a_min)] * self.batch))
        finally:
            self._spec_mode = False
