"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE + dynamic resolution [arXiv:2409.12191].  The vision frontend is a
STUB per assignment: ``input_specs()`` provides precomputed patch embeddings
of shape (batch, seq, d_model) plus 3-component (t, h, w) M-RoPE position
ids; only the transformer backbone is built.
"""
from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    pattern=(LayerSpec(ATTN, DENSE),),
    mrope_sections=(16, 24, 24),  # halves of head_dim (64) split t/h/w
    rope_theta=1000000.0,
    frontend="embeds",
)
