"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2.  Mamba+attn 1:7 interleave [arXiv:2403.19887].

Period of 8 layers: attention at position 4, SSM elsewhere; MoE on odd
positions (1:1 MoE:dense alternation).  9 periods = 72 layers.
"""
from repro_torch.configs.base import (ATTN, DENSE, MOE, SSM, LayerSpec, ModelConfig,
                                MoEConfig, SSMConfig)

_SD = LayerSpec(SSM, DENSE)
_SM = LayerSpec(SSM, MOE)
_AD = LayerSpec(ATTN, DENSE)
_AM = LayerSpec(ATTN, MOE)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=(_SD, _SM, _SD, _SM, _AD, _SM, _SD, _SM),
    num_periods=9,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, chunk_size=256),
    rope_theta=10000.0,
)
