"""``arch`` registry of the port: the JAX package's registry, name for
name (the ten assigned architectures and the paper's models).  Every
name resolves to a plan and builds the engine its plan names.  The dry
run's cells are every assigned arch against the four production shapes
(``all_cells``: 40, ``shape_applicable`` marking the runnable ones)."""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3
from repro_torch.configs.gemma3_4b import CONFIG as GEMMA3_4B
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2_1_3B
from repro_torch.configs.paper_models import PAPER_MODELS
from repro_torch.configs.qwen2_vl_72b import CONFIG as QWEN2_VL_72B
from repro_torch.configs.qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE

ASSIGNED: dict[str, ModelConfig] = {c.name: c for c in (
    GRANITE_8B, TINYLLAMA, GEMMA3_4B, QWEN3_8B, QWEN2_VL_72B,
    JAMBA_1_5, LLAMA4_SCOUT, DEEPSEEK_V3, MAMBA2_1_3B, WHISPER_BASE)}

REGISTRY: dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def list_archs() -> list[str]:
    return sorted(ASSIGNED)


def all_cells():
    """Every (arch, shape, runnable, skip_reason) cell — 40 total."""
    out = []
    for a in list_archs():
        cfg = ASSIGNED[a]
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            ok, why = shape_applicable(cfg, SHAPES[s])
            out.append((a, s, ok, why))
    return out
