"""Config dataclasses for the PyTorch port.

A copy of the JAX package's ``configs/base.py`` fields, so a plan
resolved there describes the same model here.  The port carries only
what its slice runs: the dataclasses, the layer kinds and
``scaled_down``.  Standard library only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Layer kinds composing a pattern period.
# ---------------------------------------------------------------------------
ATTN = "attn"            # full (causal) attention
ATTN_LOCAL = "attn_local"  # sliding-window attention
MLA = "mla"              # DeepSeek multi-head latent attention
SSM = "ssm"              # Mamba2 / SSD layer
CROSS = "cross"          # encoder-decoder cross attention (decoder side)
ENC = "enc"              # bidirectional encoder self attention

MIXER_KINDS = (ATTN, ATTN_LOCAL, MLA, SSM, CROSS, ENC)

DENSE = "dense"          # plain (Swi)GLU MLP
MOE = "moe"              # routed mixture of experts


@dataclass(frozen=True)
class LayerSpec:
    """One layer = a (mixer, ffn) pair."""

    mixer: str = ATTN
    ffn: str = DENSE

    def __post_init__(self):
        if self.mixer not in MIXER_KINDS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in (DENSE, MOE):
            raise ValueError(f"unknown ffn {self.ffn!r}")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    expert_d_ff: int = 0          # per-expert hidden size
    num_shared: int = 0           # shared (always-on) experts
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense|moe|ssm|hybrid|vlm|audio
    # -- core dims ---------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 131072
    # -- layer pattern -----------------------------------------------------
    # ``pattern`` repeats ``num_periods`` times, then ``remainder`` unrolls.
    pattern: Sequence[LayerSpec] = (LayerSpec(),)
    num_periods: int = 0          # 0 -> num_layers // len(pattern)
    remainder: Sequence[LayerSpec] = ()
    # -- attention ---------------------------------------------------------
    rope_theta: float = 10000.0
    window: int = 0               # sliding window for ATTN_LOCAL
    qk_norm: bool = False         # qwen3-style per-head q/k RMSNorm
    mrope_sections: Sequence[int] = ()  # qwen2-vl M-RoPE (t,h,w) split
    logit_softcap: float = 0.0
    # -- sub-configs -------------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # -- enc-dec -----------------------------------------------------------
    enc_dec: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500
    # -- modality frontend stub --------------------------------------------
    frontend: str = "tokens"      # tokens|embeds
    # -- norm/activation ---------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    quant_weights: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_periods == 0 and len(self.pattern):
            per = (self.num_layers - len(self.remainder)) // len(self.pattern)
            object.__setattr__(self, "num_periods", per)
        total = len(self.pattern) * self.num_periods + len(self.remainder)
        if total != self.num_layers:
            raise ValueError(
                f"{self.name}: pattern*periods+remainder={total} != "
                f"num_layers={self.num_layers}")


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the JAX package's
    ``scaled_down``, field for field)."""
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
        top_k=min(cfg.moe.top_k, 2), expert_d_ff=64,
        shared_d_ff=64 if cfg.moe.num_shared else 0,
        capacity_factor=float(min(cfg.moe.num_experts, 4)))
    mla = cfg.mla and dataclasses.replace(
        cfg.mla, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
        qk_rope_head_dim=8, v_head_dim=8)
    ssm = cfg.ssm and dataclasses.replace(
        cfg.ssm, d_state=16, head_dim=8, chunk_size=32)
    num_layers = len(cfg.pattern) * 2 + len(cfg.remainder)
    num_kv = (min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads
              else 4)
    base = dataclasses.replace(
        cfg, num_layers=num_layers, num_periods=2, d_model=64,
        num_heads=4, num_kv_heads=num_kv, head_dim=16, d_ff=128,
        vocab_size=256, max_seq_len=512,
        window=min(cfg.window, 64) if cfg.window else 0,
        moe=moe, mla=mla, ssm=ssm,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 24),
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else (),
    )
    if overrides:
        base = dataclasses.replace(base, **overrides)
    return base
