"""deepseek-v3-671b [moe]: 61L d=7168 128H (MLA) d_ff=2048/expert
vocab=129280, MoE 256e top-8 + 1 shared [arXiv:2412.19437].

MLA: q_lora 1536, kv_lora 512, nope 128, rope 64, v 128.  Per the assigned
config all 61 layers are MoE with uniform expert d_ff=2048 (the real model's
first-3 dense layers are omitted — noted in DESIGN.md).  MTP head is not part
of the assigned config.  Active params ~= 37B.
"""
from repro_torch.configs.base import MLA, MOE, LayerSpec, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    pattern=(LayerSpec(MLA, MOE),),
    moe=MoEConfig(num_experts=256, top_k=8, expert_d_ff=2048,
                  num_shared=1, shared_d_ff=2048),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=10000.0,
)
