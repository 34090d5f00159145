"""``arch`` registry of the port: only the architectures it has copied."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in (TINYLLAMA,)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]
