"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt].
Pattern: 5 periods of [5x local(window=1024), 1x global] + remainder
[3x local, 1x global] = 34 layers, 6 global total.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, DENSE, LayerSpec, ModelConfig

_L = LayerSpec(ATTN_LOCAL, DENSE)
_G = LayerSpec(ATTN, DENSE)

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=(_L, _L, _L, _L, _L, _G),
    num_periods=5,
    remainder=(_L, _L, _L, _G),
    window=1024,
    rope_theta=1000000.0,
    tie_embeddings=True,
)
