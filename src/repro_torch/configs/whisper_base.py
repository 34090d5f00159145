"""whisper-base [audio]: enc-dec, 6L d=512 8H d_ff=2048 vocab=51865.

[arXiv:2212.04356].  The conv audio frontend is a STUB per assignment:
``input_specs()`` provides precomputed frame embeddings (batch, 1500, 512)
for the encoder.  Decoder layers = self-attn + cross-attn + MLP.
"""
from repro_torch.configs.base import CROSS, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    pattern=(LayerSpec(CROSS, DENSE),),
    enc_dec=True,
    num_encoder_layers=6,
    encoder_seq_len=1500,
    frontend="embeds",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions; we use sinusoidal
)
