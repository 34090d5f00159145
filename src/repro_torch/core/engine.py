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
port's three hand-written kernels: ``flash_attention`` (prefill),
``decode_attention`` (decode) and, with ``quant="int4"`` and
``fused_int4``, ``int4_matmul`` for every packed projection, whose
``#q``/``#s`` pairs stay packed on the device.  Dense stacks only: MoE,
speculative decoding and pipeline stages come with later slices.
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

from repro_torch.configs.base import ATTN, DENSE, ModelConfig
from repro_torch.core.kvstore import PhasedKVExtents, TieredKVStore
from repro_torch.core.offload import DeviceStore, DiskStore, HostStore
from repro_torch.core.pipeline import PipelineScheduler
from repro_torch.core.tasks import Trace
from repro_torch.core.transfer import DEFAULT_BLOCK, Manifest, TieredWeightStore
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attention_op, int4_matmul_op
from repro_torch.models.attention import decode_attention
from repro_torch.models.common import rms_norm, silu
from repro_torch.models.rope import apply_rope, rope_angles
from repro_torch.quant.int4 import quantize_int4
from repro_torch.serving.spec import ResolvedPlan

# ---------------------------------------------------------------------------
# Per-unit compute
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str):
    """x (..., K) @ w[name]; a packed ``name#q``/``name#s`` pair goes
    through the fused ``int4_matmul`` (the group is K // scale rows)."""
    if name in w:
        return x @ w[name]
    packed, scale = w[name + "#q"], w[name + "#s"]
    K = packed.shape[0]
    y = int4_matmul_op(x.reshape(-1, K), packed, scale,
                       group=K // scale.shape[0])
    return y.reshape(*x.shape[:-1], y.shape[-1])


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
    """x (b, 1, d); kc/vc (b, L, hkv, dh) device caches, updated in place
    at ``pos`` (int or ragged (b,) tensor) and attended through the
    ``decode_attention`` kernel.  Returns (x', k_new, v_new, kc, vc)."""
    b, s, d = x.shape
    q, k, v = _qkv(x, w, pos, cfg)
    out, kc, vc = decode_attention(q, kc, vc, k, v, pos)
    return x + _proj(out.reshape(b, s, -1), w, "wo"), k, v, kc, vc


def _mlp_unit(x, w, *, cfg: ModelConfig):
    xn = rms_norm(x, w["norm"], cfg.norm_eps)
    hdn = silu(_proj(xn, w, "w_gate")) * _proj(xn, w, "w_up")
    return x + _proj(hdn, w, "w_down")


def _embed_unit(tokens, emb):
    return emb[tokens.long()]


def _head_unit(x, emb):
    return torch.argmax(x[:, -1].to(torch.float32) @ emb.T, dim=-1)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclass
class UnitSpec:
    kind: str           # "mha" | "mlp"
    layer: int
    key: str            # store key


class PipelinedLM(PhasedKVExtents):
    """Offloaded generation per PIPO.

    placement: "device" | "host" | "disk" — where the merged unit weights
    live.  cache_on: "host" | "device".  pipeline: "performance" |
    "memory" | "sequential".  quant: None | "int4".  depth: performance-
    pipeline preload window.  ``device``: where compute runs (CUDA unless
    the caller passes "cpu")."""

    def __init__(self, plan: ResolvedPlan, device="cuda"):
        if not isinstance(plan, ResolvedPlan):
            raise TypeError(f"PipelinedLM takes a ResolvedPlan, got "
                            f"{type(plan).__name__}")
        cfg = plan.model_config()
        if cfg.moe is not None or any(
                (s.mixer, s.ffn) != (ATTN, DENSE)
                for s in (*cfg.pattern, *cfg.remainder)):
            raise NotImplementedError(
                "the port runs dense ATTN+DENSE stacks; MoE and the other "
                "model families come with later slices")
        if plan.draft_arch is not None:
            raise NotImplementedError(
                "speculative decoding comes with a later slice of the port")
        if plan.stages != 1:
            raise NotImplementedError(
                "pipeline-parallel stages come with a later slice of the port")
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
        self._build(plan.seed)
        self._kv_init()

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

    def _build(self, seed: int):
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        emb = (rng.standard_normal((cfg.vocab_size, cfg.d_model))
               * (1.0 / math.sqrt(cfg.d_model))).astype(np.float32)
        self.device.put("emb", emb)      # embeddings stay on device (small)
        for l in range(cfg.num_layers):
            for kind in ("mha", "mlp"):
                key = f"{kind}[{l}]"
                self.weights.put(key, self._unit_tensors(kind, rng))
                self.units.append(UnitSpec(kind, l, key))

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
        key = self.units[j].key
        if self.quant == "int4" and not self.weights.fused_int4:
            return self.weights.load(key)
        return self.weights.fetch(key)

    def weight_nbytes(self, j: int) -> int:
        """Bytes unit j's WEIGHT_LOAD moves (trace byte accounting)."""
        return self.weights.nbytes(self.units[j].key)

    def release_weights(self, j: int, handle):
        del handle  # device tensors freed when the last reference goes

    def _live_len(self, i: int) -> int:
        """Rows iteration ``i``'s decode attention reads: the prompt plus
        the decode rows already saved.  Iteration 0 is the prefill."""
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

    def _adopt(self, loaded):
        """Tell the caching allocator that the compute stream uses
        tensors (a tensor or a dict of them) that a transfer worker
        allocated on its own stream; the worker waited for its copy
        before the task completed, so no stream wait is needed."""
        if self.dev.type != "cuda" or loaded is None:
            return
        cur = torch.cuda.current_stream(self.dev)
        for t in (loaded.values() if isinstance(loaded, dict) else (loaded,)):
            t.record_stream(cur)

    def compute(self, i: int, j: int, x, weights, kv):
        self._adopt(weights)
        if isinstance(weights, torch.Tensor):
            weights = self.weights.split(self.units[j].key, weights)
        if self.units[j].kind == "mlp":
            return _mlp_unit(x, weights, cfg=self.cfg), None
        if self._phase == "prefill":
            x, k, v = _attn_prefill_unit(x, weights, cfg=self.cfg)
            return x, ("prefill", k, v, 0, x.shape[1])
        self._adopt(kv)
        pos = self._pos
        x, k, v, kc, vc = _attn_decode_unit(x, weights, kv["k"], kv["v"],
                                            pos, cfg=self.cfg)
        return x, ("decode", k, v, pos, x.shape[1])

    def finalize(self, i: int, x):
        tok = _head_unit(x, self.device.get("emb"))
        self._last_tokens = tok.cpu().numpy().astype(np.int32)
        return self._last_tokens

    # -- public API -----------------------------------------------------------
    def generate(self, prompt: np.ndarray, gen_len: int, pool=None):
        """prompt (b, s) int32.  Greedy-generates gen_len tokens.  Returns
        (tokens (b, gen_len), stats dict).  ``pool`` injects a transfer
        pool (e.g. ``VirtualPool`` for virtual-clock byte tests); its
        trace becomes the engine's."""
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
        for t in range(1, gen_len):
            self._pos = s + t - 1
            x_tok = _embed_unit(
                torch.from_numpy(outs[-1][:, None]).to(self.dev), emb)
            outs.append(sched.generate(self, lambda i: x_tok, 1)[-1])
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
        }
        if self.dev.type == "cuda":
            stats["device_max_allocated_gb"] = \
                torch.cuda.max_memory_allocated(self.dev) / 2**30
        return toks, stats
