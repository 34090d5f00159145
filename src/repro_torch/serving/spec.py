"""Engine plans for the port: the JAX package's ``serving/spec.py``
``ResolvedPlan`` (same fields, same JSON), the serving policy seams the
offloaded engine consults (``PreloadPolicy``/``StaticDepth``,
``QuantPolicy``/``WeightsInt4``, ``SchedPolicy``), the capability gate,
and the two constructors ``create_engine`` (serving) and ``build_lm``
(batch generation).

``EngineSpec.resolve`` waits for a later slice: a plan resolved by the
JAX package ships here through ``to_json`` / ``ResolvedPlan.from_json``,
or is written out field by field.  So do ``AdaptiveDepth`` and the
chunked-prefill policies; asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, scaled_down
from repro_torch.configs.registry import get_config
from repro_torch.core.offload import MemoryBudget


QUANT_MODES = (None, "int4")
KV_MODES = ("fp32", "int4")


class SpecError(ValueError):
    """A plan field (or field combination) is invalid."""


class UnsupportedModelError(RuntimeError):
    """The offloaded engine cannot serve this architecture; carries the
    failing capability."""

    def __init__(self, capability: str, message: str):
        super().__init__(message)
        self.capability = capability


def offload_capability(cfg: ModelConfig) -> Optional[str]:
    """The capability that rules out offloaded serving for ``cfg``, or
    None (token-frontend rope decoder stacks only)."""
    if cfg.enc_dec:
        return "enc_dec"
    if cfg.frontend == "embeds":
        return "embeds_frontend"
    if cfg.rope_theta == 0:
        return "no_rope"
    return None


def _registry_config(arch: str, scaled: bool,
                     cfg: Optional[ModelConfig]) -> ModelConfig:
    if cfg is not None:
        return cfg
    try:
        base = get_config(arch)
    except KeyError as e:
        raise SpecError(str(e)) from e
    return scaled_down(base) if scaled else base


@dataclass(frozen=True)
class StagePlan:
    """One pipeline-parallel stage's slice of a resolved plan (kept so a
    staged plan's JSON round-trips; the port runs one stage)."""

    stage: int
    layer_lo: int
    layer_hi: int
    depth: int
    device_budget: int
    why: str = ""


@dataclass(frozen=True)
class ResolvedPlan:
    """A fully-materialized engine plan.  ``cfg`` (an ad-hoc config
    override) is excluded from JSON and equality."""

    arch: str
    scaled: bool
    engine: str                  # "resident" | "offloaded"
    b_max: int
    max_len: int
    seed: int
    placement: str               # device|host|disk
    pipeline: str
    quant: Optional[str]
    kv_mode: Optional[str]       # fp32|int4 streamed KV; None on resident
    fused_int4: bool
    moe_quant: Optional[str]
    warm: bool
    depth: int
    depth_policy: str
    spill_cap: int
    cache_on: str
    disk_root: str
    block_bytes: int
    n_io_threads: int
    cold_reads: bool
    sim_bw: Optional[float]
    draft_arch: Optional[str]
    spec_k: Optional[int]
    sched: str = "monolithic"
    prefill_chunk: int = 0
    stages: int = 1
    stage_axis: str = "layer"
    stage_plan: Tuple = ()
    device_budget: int = MemoryBudget.device
    host_budget: int = MemoryBudget.host
    provenance: Dict[str, str] = field(default_factory=dict)
    cfg: Optional[ModelConfig] = field(default=None, compare=False,
                                       repr=False)

    def __post_init__(self):
        sp = tuple(StagePlan(**p) if isinstance(p, dict) else p
                   for p in self.stage_plan)
        object.__setattr__(self, "stage_plan", sp)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("cfg")
        return d

    @classmethod
    def from_json(cls, d: "Dict[str, Any] | str") -> "ResolvedPlan":
        if isinstance(d, str):
            d = json.loads(d)
        known = {f.name for f in dataclasses.fields(cls)} - {"cfg"}
        unknown = set(d) - known
        if unknown:
            raise SpecError(f"unknown ResolvedPlan field(s) {sorted(unknown)}")
        missing = known - set(d)
        if missing:
            raise SpecError(f"ResolvedPlan JSON missing {sorted(missing)}")
        return cls(**d)

    def model_config(self) -> ModelConfig:
        return _registry_config(self.arch, self.scaled, self.cfg)


def build_lm(plan: ResolvedPlan, device="cuda"):
    """A ``PipelinedLM`` configured from the plan (``b_max`` is its
    batch) on ``device`` (CUDA unless the caller asks for the CPU)."""
    if plan.kv_mode == "int4" and plan.cache_on == "device":
        raise SpecError(
            "kv_mode='int4' streams the cache over the link; with "
            "cache_on='device' nothing crosses — drop kv_mode or use "
            "cache_on='host'")
    from repro_torch.core.engine import PipelinedLM
    return PipelinedLM(plan, device=device)


# ---------------------------------------------------------------------------
# PreloadPolicy seam
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Pressure:
    """Live load snapshot the engine hands the preload policy between
    decode steps."""
    active: int
    max_pos: int
    spills: int = 0
    kv_layer_bytes: Optional[int] = None


class PreloadPolicy:
    """Decides the preload window: ``max_depth()`` sizes the transfer pool
    at build time, ``depth(pressure)`` is consulted before every decode
    step."""

    def max_depth(self) -> int:
        raise NotImplementedError

    def depth(self, pressure: Pressure) -> int:
        raise NotImplementedError


class StaticDepth(PreloadPolicy):
    """A fixed window, whatever the load."""

    def __init__(self, depth: int):
        self._depth = max(1, int(depth))

    def max_depth(self) -> int:
        return self._depth

    def depth(self, pressure: Pressure) -> int:
        return self._depth

    def __repr__(self):
        return f"StaticDepth({self._depth})"


def preload_policy_for(plan: ResolvedPlan, cfg: Optional[ModelConfig] = None
                       ) -> PreloadPolicy:
    if plan.depth_policy == "adaptive":
        raise NotImplementedError(
            "depth_policy='adaptive' (AdaptiveDepth) comes with a later "
            "slice of the port; use depth_policy='static'")
    return StaticDepth(max(1, plan.depth))


# ---------------------------------------------------------------------------
# QuantPolicy seam
# ---------------------------------------------------------------------------


class QuantPolicy:
    """What lives or crosses the link quantized: ``weight_mode`` feeds
    ``TieredWeightStore``, ``prepare_unit`` packs a unit's tensors at
    build time, ``kv_mode`` feeds ``TieredKVStore``."""

    name = "none"
    weight_mode: Optional[str] = None

    def __init__(self, kv_mode: Optional[str] = "fp32"):
        self.kv_mode = kv_mode or "fp32"
        if self.kv_mode not in KV_MODES:
            raise SpecError(f"kv_mode {kv_mode!r} not in {KV_MODES}")

    def prepare_unit(self, tensors: Dict[str, Any], device="cpu"
                     ) -> Dict[str, Any]:
        return tensors


class WeightsInt4(QuantPolicy):
    """Paper §3.4: eligible 2-D projections stored as packed nibbles and
    groupwise scales (``transfer.quantize_unit``); only packed bytes
    cross the link."""

    name = "int4"
    weight_mode = "int4"

    def prepare_unit(self, tensors: Dict[str, Any], device="cpu"
                     ) -> Dict[str, Any]:
        from repro_torch.core.transfer import quantize_unit
        return quantize_unit(tensors, device=device)


def quant_policy_for(quant: Optional[str],
                     kv_mode: Optional[str] = "fp32") -> QuantPolicy:
    if quant == "int4":
        return WeightsInt4(kv_mode)
    if quant is None:
        return QuantPolicy(kv_mode)
    raise SpecError(f"quant {quant!r} not in {QUANT_MODES}")


# ---------------------------------------------------------------------------
# SchedPolicy seam
# ---------------------------------------------------------------------------


class SchedPolicy:
    """How a new request's prefill meets the streamed weight window: the
    monolithic b=1 prefill pass at admission."""

    name = "monolithic"
    chunked = False

    def chunk_cap(self) -> int:
        return 0

    def __repr__(self):
        return f"{type(self).__name__}()"


def sched_policy_for(plan: ResolvedPlan) -> SchedPolicy:
    if plan.sched != "monolithic":
        raise NotImplementedError(
            f"sched={plan.sched!r} (chunked prefill) comes with a later "
            f"slice of the port; use sched='monolithic'")
    return SchedPolicy()


# ---------------------------------------------------------------------------
# Engine construction
# ---------------------------------------------------------------------------


def create_engine(plan: ResolvedPlan, device="cuda"):
    """The serving-engine constructor: an ``OffloadedServingEngine`` for
    an offloaded plan on ``device`` (CUDA unless the caller asks for the
    CPU).  The resident ``ServingEngine`` comes with a later slice."""
    if not isinstance(plan, ResolvedPlan):
        raise TypeError(f"create_engine takes a ResolvedPlan, got "
                        f"{type(plan).__name__}")
    if plan.engine != "offloaded":
        raise NotImplementedError(
            "the resident ServingEngine comes with a later slice of the "
            "port; resolve an offloaded plan")
    from repro_torch.serving.offload_engine import OffloadedServingEngine
    return OffloadedServingEngine(plan, device=device)
