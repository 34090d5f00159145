from repro_torch.configs.base import (ATTN, DENSE, MOE, LayerSpec,
                                      ModelConfig, MoEConfig, scaled_down)
from repro_torch.configs.registry import REGISTRY, get_config

__all__ = ["ATTN", "DENSE", "MOE", "LayerSpec", "ModelConfig", "MoEConfig",
           "scaled_down", "REGISTRY", "get_config"]
