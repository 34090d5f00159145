"""PIPO automatic configuration (paper §3.5, Eq. 1 + Algorithm 2).

Inputs: model, batch, lengths, precision, tier capacities/bandwidths.
Outputs: weight placement (device/host/disk), pipeline mode
(performance-optimized vs memory-efficient), preload depth (how many
layers the performance pipeline keeps in flight — sized from the device
headroom left after the KV cache, per ``memory_model.depth_capacity``),
block size, and whether the INT4 fused kernel is enabled (batch < 16,
per §3.5).  ``serving_preload_depth`` is the serving-engine entry point:
same sizing, plus a host-side sanity check that the weight tier, KV
cache, and retained slot spills (``spill_cap``) actually coexist in host
RAM — when they can't, deep windows only amplify thrash, so it falls
back to depth 1.  docs/TUNING.md walks a worked example.

The port of the JAX package's ``core/autoconfig.py``: the same
arithmetic and the same why strings, so a plan resolves to the same
JSON in both packages.  ``replay_depth_decision`` waits for the
``core/replay.py`` slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.memory_model import (MemoryEstimate, depth_capacity,
                                           estimate, host_pinned_bytes,
                                           quant_kv_ratio, quant_weight_ratio)
from repro_torch.core.offload import MemoryBudget


@dataclass(frozen=True)
class AutoConfig:
    weight_placement: str       # "device" | "host" | "disk"
    pipeline: str               # "performance" | "memory"
    block_bytes: int
    use_int4_kernel: bool
    est: MemoryEstimate
    reason: str
    preload_depth: int = 1      # performance-pipeline resident window - 1


def choose_placement(cfg: ModelConfig, *, batch: int, seq: int,
                     precision_bytes: int = 2,
                     budget: Optional[MemoryBudget] = None,
                     quant: Optional[str] = None) -> tuple:
    """Eq. (1) weight placement as a (placement, why) decision — the
    single implementation shared by ``configure()`` and
    ``serving.spec.EngineSpec.resolve()`` (the plan records the why
    string as the field's provenance)."""
    budget = budget or MemoryBudget()
    est_pre = estimate(cfg, batch=batch, seq=seq, p=precision_bytes,
                       preload=True)
    ratio = quant_weight_ratio(precision_bytes, quant)
    W = int(est_pre.weights * ratio)
    C = est_pre.kv_cache
    # quantization shrinks only the *weight* component of peak M; the
    # activation part stays at compute precision (paper: W4 + fp16 act)
    resident_w = est_pre.w_mha + est_pre.w_mlp
    M = int(max(est_pre.peak_prefill, est_pre.peak_decode)
            - resident_w * (1.0 - ratio))
    if W + M < budget.device:
        return "device", f"W+M={(W+M)/2**30:.1f}GiB fits device"
    if W + C < budget.host and budget.disk_bw < budget.device_bw:
        return "host", f"W+C={(W+C)/2**30:.1f}GiB fits host"
    return "disk", "exceeds host; stream from disk"


def configure(cfg: ModelConfig, *, batch: int, prompt_len: int,
              gen_len: int, precision_bytes: int = 2,
              budget: Optional[MemoryBudget] = None,
              quant: Optional[str] = None,
              block_bytes: int = 32 << 20) -> AutoConfig:
    budget = budget or MemoryBudget()
    s = prompt_len + gen_len

    est_pre = estimate(cfg, batch=batch, seq=s, p=precision_bytes,
                       preload=True)
    ratio = quant_weight_ratio(precision_bytes, quant)
    # quantization shrinks only the *weight* component of peak M; the
    # activation part stays at compute precision (paper: W4 + fp16 act)
    resident_w = est_pre.w_mha + est_pre.w_mlp
    M = int(max(est_pre.peak_prefill, est_pre.peak_decode)
            - resident_w * (1.0 - ratio))

    # ---- Eq. (1): weight placement ----
    placement, why = choose_placement(cfg, batch=batch, seq=s,
                                      precision_bytes=precision_bytes,
                                      budget=budget, quant=quant)

    # ---- Eq. (1): pipeline mode ----
    if M < budget.device:
        pipeline = "performance"
    else:
        pipeline = "memory"
        est_min = estimate(cfg, batch=batch, seq=s, p=precision_bytes,
                           preload=False)
        M = int(max(est_min.peak_prefill, est_min.peak_decode)
                - (est_min.w_mha + est_min.w_mlp) * (1.0 - ratio))

    use_int4 = (quant == "int4") and batch < 16   # §3.5
    if pipeline == "performance":
        depth = depth_capacity(cfg, batch=batch, seq=s, p=precision_bytes,
                               budget_bytes=budget.device, quant=quant)
    else:
        depth = 1           # memory mode: single-layer residency, no window
    return AutoConfig(placement, pipeline, block_bytes, use_int4, est_pre,
                      why, depth)


def serving_depth_decision(cfg: ModelConfig, *, b_max: int, max_len: int,
                           precision_bytes: int = 4,
                           quant: Optional[str] = None,
                           kv_mode: Optional[str] = None,
                           spill_cap: int = 0,
                           placement: str = "host",
                           budget: Optional[MemoryBudget] = None,
                           depth_cap: int = 8) -> tuple:
    """``serving_preload_depth`` as a (depth, why) decision, the why
    string carrying the memory-model numbers — ``EngineSpec.resolve()``
    records it as the ``depth`` field's provenance.  ``kv_mode='int4'``
    prices every KV term (host pin, spills, in-flight slabs) at packed
    bytes, so the affordable window deepens just as it does for packed
    weights."""
    budget = budget or MemoryBudget()
    fixed, per_spill = host_pinned_bytes(
        cfg, b_max=b_max, max_len=max_len, p=precision_bytes, quant=quant,
        kv_mode=kv_mode, placement=placement)
    host_need = fixed + spill_cap * per_spill
    if host_need > budget.host:
        return 1, (f"host tier over budget "
                   f"(weights+KV+{spill_cap} spills = "
                   f"{host_need / 2**30:.2f}GiB > "
                   f"{budget.host / 2**30:.0f}GiB): depth 1, deeper "
                   f"windows only thrash a saturated host")
    d = depth_capacity(cfg, batch=b_max, seq=max_len, p=precision_bytes,
                       budget_bytes=budget.device, quant=quant,
                       kv_mode=kv_mode, depth_cap=depth_cap)
    est0 = estimate(cfg, batch=b_max, seq=max_len, p=precision_bytes,
                    preload=0)
    base = max(est0.peak_prefill, est0.peak_decode)
    per = (int(max(est0.w_mha, est0.w_mlp)
               * quant_weight_ratio(precision_bytes, quant))
           + int(est0.kv_cache // max(1, cfg.num_layers)
                 * quant_kv_ratio(precision_bytes, kv_mode)))
    return d, (f"device headroom after depth-0 peak "
               f"({base / 2**20:.0f}MiB) affords {d} in-flight "
               f"layer(s) at {per / 2**20:.1f}MiB each "
               f"(quant={quant or 'fp32'}, kv={kv_mode or 'fp32'}, "
               f"cap {depth_cap})")


def replay_depth_decision(trace, *, depth_cap: int = 8,
                          quant: Optional[str] = None,
                          kv_mode: Optional[str] = None,
                          sim_bw: Optional[float] = None,
                          start_iter: Optional[int] = None,
                          stop_iter: Optional[int] = None) -> tuple:
    """Preload depth as a (depth, why) decision from a recorded trace:
    ``core.replay.best_depth`` sweeps the window 1..depth_cap through
    the simulator and the argmin wins — measured argmin instead of the
    closed-form heuristic.  ``depth_cap`` stays the memory model's job
    (the simulator knows time, not residency), so callers pass the
    capacity-fit cap in.  The why string records the per-depth
    predictions and names ``replay`` as the source —
    ``EngineSpec.resolve(budget, trace=...)`` stores it as the depth
    field's provenance."""
    raise NotImplementedError(
        "replay_depth_decision needs the trace-replay simulator "
        "(core/replay.py), which comes with a later slice of the port")


def serving_preload_depth(cfg: ModelConfig, *, b_max: int, max_len: int,
                          precision_bytes: int = 4,
                          quant: Optional[str] = None,
                          kv_mode: Optional[str] = None, spill_cap: int = 0,
                          placement: str = "host",
                          budget: Optional[MemoryBudget] = None,
                          depth_cap: int = 8) -> int:
    """Preload depth for an offloaded serving engine (the ``depth=None``
    default of ``OffloadedServingEngine``): ``depth_capacity`` against the
    device budget, with one serving-specific guard — the host tier must
    hold the full decode KV cache, up to ``spill_cap`` retained slot
    spills (each one request's KV rows), and — for host placement — the
    weights themselves (packed under quant; disk placement keeps only
    in-flight buffers in host RAM, so weights don't count there).  When
    the host can't, it is already the bottleneck and a deeper window
    just queues more transfers behind a thrashing tier: fall back to
    depth 1."""
    return serving_depth_decision(
        cfg, b_max=b_max, max_len=max_len, precision_bytes=precision_bytes,
        quant=quant, kv_mode=kv_mode, spill_cap=spill_cap,
        placement=placement, budget=budget, depth_cap=depth_cap)[0]
