from repro_torch.configs.base import (ATTN, DENSE, MOE, SHAPES, LayerSpec,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      scaled_down, shape_applicable)
from repro_torch.configs.registry import (ASSIGNED, REGISTRY, all_cells,
                                          get_config, get_shape, list_archs)

__all__ = ["ATTN", "DENSE", "MOE", "LayerSpec", "ModelConfig", "MoEConfig",
           "SHAPES", "ShapeConfig", "scaled_down", "shape_applicable",
           "ASSIGNED", "REGISTRY", "all_cells", "get_config", "get_shape",
           "list_archs"]
