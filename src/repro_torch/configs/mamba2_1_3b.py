"""mamba2-1.3b [ssm]: 48L d=2048 attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060].  No FFN (d_ff=0): each layer
is a single Mamba2 block.  d_inner = 2*2048 = 4096, head_dim 64 -> 64 heads.
"""
from repro_torch.configs.base import DENSE, SSM, LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(SSM, DENSE),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    tie_embeddings=True,
)
