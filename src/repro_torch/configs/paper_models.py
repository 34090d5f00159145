"""Models evaluated in the PIPO paper itself (Figures 5-12, Tables 1-6).

The full configs feed the memory model (Appendix B) and the offloaded
engines; the tests run their ``scaled_down`` variants.
"""
from repro_torch.configs.base import (ATTN, DENSE, MOE, LayerSpec, ModelConfig,
                                MoEConfig)

LLAMA31_8B = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=(LayerSpec(ATTN, DENSE),),
    rope_theta=500000.0,
)

LLAMA31_70B = ModelConfig(
    name="llama3.1-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    pattern=(LayerSpec(ATTN, DENSE),),
    rope_theta=500000.0,
)

LLAMA32_1B = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    pattern=(LayerSpec(ATTN, DENSE),),
    rope_theta=500000.0,
    tie_embeddings=True,
)


def _opt(name, layers, d, heads, vocab=50272):
    # OPT uses MHA + a 2-matrix 4d ReLU MLP (8d^2 params).  Our DENSE block is
    # 3-matrix SwiGLU, so size d_ff = 8d/3 (rounded to 128) to keep the layer
    # parameter count — and therefore the offloading memory model — faithful.
    d_ff = max(128, int(8 * d / 3) // 128 * 128)
    return ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=d,
        num_heads=heads, num_kv_heads=heads, head_dim=d // heads,
        d_ff=d_ff, vocab_size=vocab, pattern=(LayerSpec(ATTN, DENSE),),
    )


OPT_1_3B = _opt("opt-1.3b", 24, 2048, 32)
OPT_6_7B = _opt("opt-6.7b", 32, 4096, 32)
OPT_13B = _opt("opt-13b", 40, 5120, 40)
OPT_30B = _opt("opt-30b", 48, 7168, 56)
OPT_66B = _opt("opt-66b", 64, 9216, 72)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    pattern=(LayerSpec(ATTN, MOE),),
    moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336),
    rope_theta=1000000.0,
)

PAPER_MODELS = {m.name: m for m in (
    LLAMA31_8B, LLAMA31_70B, LLAMA32_1B, OPT_1_3B, OPT_6_7B, OPT_13B,
    OPT_30B, OPT_66B, MIXTRAL_8X7B)}
