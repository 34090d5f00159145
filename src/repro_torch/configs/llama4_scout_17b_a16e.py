"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E].  Every layer MoE with one shared
expert (early-fusion multimodality handled at token level; text backbone).
"""
from repro_torch.configs.base import ATTN, MOE, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(LayerSpec(ATTN, MOE),),
    moe=MoEConfig(num_experts=16, top_k=1, expert_d_ff=8192,
                  num_shared=1, shared_d_ff=8192),
    rope_theta=500000.0,
)
