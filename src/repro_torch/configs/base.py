"""Config dataclasses for the PyTorch port.

A copy of the JAX package's ``configs/base.py`` fields, so a plan
resolved there describes the same model here: the dataclasses, the
layer kinds, the parameter counts the memory model reads
(``mixer_params``, ``ffn_params``, ``param_count``,
``kv_bytes_per_token_layer``, ``attn_layer_indices``), the input shapes
the sharding rules read (``ShapeConfig``, ``SHAPES``,
``shape_applicable``) and ``scaled_down``.  Standard library only.
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

    # ---- parameter counting (read by core.memory_model) -------------------
    def mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.head_dim
        if spec.mixer in (ATTN, ATTN_LOCAL, ENC):
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o
        if spec.mixer == CROSS:  # self-attn + cross-attn
            self_p = self.mixer_params(LayerSpec(ATTN, spec.ffn))
            cross = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
            return self_p + cross
        if spec.mixer == MLA:
            m = self.mla
            q = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim)
            kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * \
                self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            o = self.num_heads * m.v_head_dim * d
            return q + kv + o
        if spec.mixer == SSM:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            in_proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
            conv = (d_in + 2 * s.n_groups * s.d_state) * s.d_conv
            out = d_in * d
            return in_proj + conv + out + 2 * nheads  # A_log, D
        raise ValueError(spec.mixer)

    def ffn_params(self, spec: LayerSpec, active_only: bool = False) -> int:
        d = self.d_model
        if spec.ffn == DENSE:
            return 3 * d * self.d_ff
        m = self.moe
        n_routed = m.top_k if active_only else m.num_experts
        routed = n_routed * 3 * d * m.expert_d_ff
        shared = m.num_shared * 3 * d * m.shared_d_ff
        router = d * m.num_experts
        return routed + shared + router

    def _all_specs(self):
        return list(self.pattern) * self.num_periods + list(self.remainder)

    def param_count(self, active_only: bool = False) -> int:
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for spec in self._all_specs():
            n += self.mixer_params(spec) + self.ffn_params(spec, active_only)
            n += 2 * self.d_model  # norms
        if self.enc_dec:
            enc_spec = LayerSpec(ENC, DENSE)
            n += self.num_encoder_layers * (
                self.mixer_params(enc_spec) + self.ffn_params(enc_spec)
                + 2 * self.d_model)
        return n

    def kv_bytes_per_token_layer(self, p: int = 2) -> int:
        """Bytes of KV cache one token adds in one attention layer."""
        if self.mla is not None:
            return p * (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim)
        return p * 2 * self.num_kv_heads * self.head_dim

    def attn_layer_indices(self):
        return [i for i, s in enumerate(self._all_specs())
                if s.mixer in (ATTN, ATTN_LOCAL, MLA, CROSS)]


# ---------------------------------------------------------------------------
# Input shapes: every arch is exercised on its own shape set (the sharding
# rules read them; the dry run's cell helpers come with its port).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# archs for which long_500k runs (sub-quadratic mixers); the others skip it
LONG_CONTEXT_OK = ("mamba2-1.3b", "jamba-1.5-large-398b", "gemma3-4b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(runnable, reason if skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic mixer")
    return True, ""


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
