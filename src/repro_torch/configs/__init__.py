from repro_torch.configs.base import (ATTN, DENSE, MOE, SHAPES, LayerSpec,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      scaled_down, shape_applicable)
from repro_torch.configs.registry import REGISTRY, get_config

__all__ = ["ATTN", "DENSE", "MOE", "LayerSpec", "ModelConfig", "MoEConfig",
           "SHAPES", "ShapeConfig", "scaled_down", "shape_applicable",
           "REGISTRY", "get_config"]
