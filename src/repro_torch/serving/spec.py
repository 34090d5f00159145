"""Engine plans for the port: the JAX package's ``serving/spec.py``
``ResolvedPlan`` (same fields, same JSON) and ``build_lm``.

``EngineSpec.resolve`` and the policies come with the serving slice; a
plan resolved by the JAX package ships here through ``to_json`` /
``ResolvedPlan.from_json``, or is written out field by field.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, scaled_down
from repro_torch.configs.registry import get_config
from repro_torch.core.offload import MemoryBudget


class SpecError(ValueError):
    """A plan field (or field combination) is invalid."""


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
