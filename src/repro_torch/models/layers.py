"""Layer parameter tables and apply functions for the dense stack.

The single-device ``ATTN`` + ``DENSE`` subset of the JAX package's
``models/layers.py``: the tables (``name -> ParamDef(shape, axes,
scale)``) that drive ``models.transformer.init_params``, and the layer
math the serving engines run (the offloaded one per unit, the resident
one over the whole stack).  Sharding (``Dist``), the other
mixers and MoE come with later slices.

On the card every attention goes through the port's kernels: prefill
through ``flash_attention``, decode through ``decode_attention`` over the
loaded cache (bf16 in serving) or ``decode_attention_int4`` over packed
rows, and a packed ``name#q``/``name#s`` projection through
``int4_matmul``.  The ``quant=None`` projections and the LM head stay
``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig
from repro_torch.core.kvstore import PackedRows
from repro_torch.kernels.ops import flash_attention_op, int4_matmul_op
from repro_torch.models.attention import (chunk_prefill_attention,
                                          decode_attention,
                                          decode_attention_packed)
from repro_torch.models.common import NEG_INF, rms_norm, silu
from repro_torch.models.rope import apply_rope


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis names, len == len(shape)
    scale: float = -1.0  # -1 -> fan-in default; 0 -> zeros


def _dense_only(cfg: ModelConfig, spec: LayerSpec):
    if (spec.mixer, spec.ffn) != (ATTN, DENSE) or cfg.qk_norm \
            or cfg.quant_weights:
        raise NotImplementedError(
            f"the port's serving slice runs ATTN+DENSE layers without "
            f"qk_norm or resident INT4 tables, got {spec} ({cfg.name}); "
            f"the other mixers, MoE and quant_weights come with later "
            f"slices")


# ===========================================================================
# Parameter tables
# ===========================================================================


def attn_table(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, h * dh), ("embed", "heads_ff")),
        "wk": ParamDef((d, hkv * dh), ("embed", "kv_ff")),
        "wv": ParamDef((d, hkv * dh), ("embed", "kv_ff")),
        "wo": ParamDef((h * dh, d), ("heads_ff", "embed")),
    }


def ffn_table(cfg: ModelConfig, spec: LayerSpec) -> dict:
    _dense_only(cfg, spec)
    d = cfg.d_model
    if cfg.d_ff == 0:
        return {}
    return {
        "w_gate": ParamDef((d, cfg.d_ff), ("embed", "ff")),
        "w_up": ParamDef((d, cfg.d_ff), ("embed", "ff")),
        "w_down": ParamDef((cfg.d_ff, d), ("ff", "embed")),
    }


def layer_table(cfg: ModelConfig, spec: LayerSpec) -> dict:
    _dense_only(cfg, spec)
    t = {"norm_mixer": ParamDef((cfg.d_model,), (None,), 0.0)}
    t.update(attn_table(cfg))
    ft = ffn_table(cfg, spec)
    if ft:
        t["norm_ffn"] = ParamDef((cfg.d_model,), (None,), 0.0)
        t.update(ft)
    return t


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """Vocab padded to a multiple (the padding is masked in the head)."""
    return -(-cfg.vocab_size // multiple) * multiple


def embed_table(cfg: ModelConfig) -> dict:
    vp = padded_vocab(cfg)
    t = {"emb": ParamDef((vp, cfg.d_model), ("vocab", "embed"),
                         1.0 / math.sqrt(cfg.d_model))}
    if not cfg.tie_embeddings:
        t["w_out"] = ParamDef((cfg.d_model, vp), ("embed", "vocab"))
    return t


# ===========================================================================
# Layer context
# ===========================================================================


@dataclass
class Ctx:
    cfg: ModelConfig
    mode: str                               # prefill | decode
    angles: Optional[torch.Tensor] = None   # (s, half) or (b, s, half)
    pos: Any = None                         # decode position: int or (b,)


# ===========================================================================
# Attention
# ===========================================================================


def _mm(x: torch.Tensor, p, name: str) -> torch.Tensor:
    """x (..., K) @ p[name]; a packed ``name#q``/``name#s`` pair goes
    through ``int4_matmul`` (the group is K // scale rows)."""
    if name in p:
        return x @ p[name]
    packed, scale = p[name + "#q"], p[name + "#s"]
    K = packed.shape[0]
    y = int4_matmul_op(x.reshape(-1, K), packed, scale,
                       group=K // scale.shape[0])
    return y.reshape(*x.shape[:-1], y.shape[-1])


def _qkv(p, xn, cfg: ModelConfig):
    b, s, _ = xn.shape
    q = _mm(xn, p, "wq").reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = _mm(xn, p, "wk").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _mm(xn, p, "wv").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def apply_attention(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """Returns (x', new_cache).  Prefill: ``new_cache`` is the prompt's
    rows (``_build_cache``).  Decode: ``new_cache`` is the step's fresh
    rows at the cache's compute dtype, the rows the reference gathers
    back out of its updated cache for the save."""
    cfg = ctx.cfg
    b, s, d = x.shape
    xn = rms_norm(x, p["norm_mixer"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg)
    if ctx.angles is not None:
        q = apply_rope(q, ctx.angles)
        k = apply_rope(k, ctx.angles)
    if ctx.mode == "decode":
        out, new_cache = _decode_attn(q, k, v, ctx, cache)
    else:
        out = flash_attention_op(q, k, v, causal=True)
        new_cache = _build_cache(k, v, ctx) if ctx.mode == "prefill" else None
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return x + _mm(out, p, "wo"), new_cache


def apply_layer_chunk(p, x, ctx: Ctx, prefix_k, prefix_v, q_offset: int):
    """One ATTN+DENSE layer applied to a prefill CHUNK.

    ``x`` holds the chunk's rows (global positions ``q_offset ..``);
    ``prefix_k``/``prefix_v`` are the engine-held K/V of the earlier
    chunks (post-rope, f32: the values a monolithic prefill has in-pass,
    not the cache tier's copies), or None for the first chunk.  The
    row-wise twin of ``apply_attention``'s prefill.  Returns ``(x, k,
    v)`` with the chunk's fresh rope'd K/V, for the caller to extend the
    prefix and append to the KV store."""
    cfg = ctx.cfg
    _dense_only(cfg, LayerSpec(ATTN, DENSE))
    b, s, d = x.shape
    xn = rms_norm(x, p["norm_mixer"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg)
    if ctx.angles is not None:
        q = apply_rope(q, ctx.angles)
        k = apply_rope(k, ctx.angles)
    kk = k if prefix_k is None else torch.cat([prefix_k, k], dim=1)
    vv = v if prefix_v is None else torch.cat([prefix_v, v], dim=1)
    out = chunk_prefill_attention(q, kk, vv, q_offset=q_offset)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    x = x + _mm(out, p, "wo")
    return apply_dense_ffn(p, x, ctx), k, v


def _build_cache(k, v, ctx: Ctx):
    """Prefill: the prompt's fresh K/V rows (b, s, hkv, dh) at compute
    precision.  The reference lays them into a zeroed ``max_len`` slab;
    the port ships only the prompt's rows and the KV store zero-fills the
    rest of the slot on the host (``TieredKVStore.save_prefill``)."""
    return {"k": k, "v": v}


def _decode_attn(q, k_new, v_new, ctx: Ctx, cache):
    """One decode step at ``ctx.pos`` (int or ragged (b,)) over the
    loaded cache: a plain slab (the step's row written in at the slab's
    dtype) or packed rows (the row attended beside them).  Returns
    (out, the fresh rows at the cache's compute dtype)."""
    kc, vc = cache["k"], cache["v"]
    if isinstance(kc, PackedRows):
        out = decode_attention_packed(q, kc, vc, k_new, v_new, ctx.pos)
    else:
        out, _, _ = decode_attention(q, kc, vc, k_new, v_new, ctx.pos)
    return out, {"k": k_new.to(kc.dtype), "v": v_new.to(kc.dtype)}


# ===========================================================================
# FFN, whole layer, embedding, head
# ===========================================================================


def apply_dense_ffn(p, x, ctx: Ctx):
    cfg = ctx.cfg
    if cfg.d_ff == 0 or ("w_gate" not in p and "w_gate#q" not in p):
        return x
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    h = silu(_mm(xn, p, "w_gate")) * _mm(xn, p, "w_up")
    return x + _mm(h, p, "w_down")


def apply_layer(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """One ATTN+DENSE layer -> (x', new_cache)."""
    _dense_only(ctx.cfg, spec)
    x, new_cache = apply_attention(p, x, ctx, cache, spec)
    return apply_dense_ffn(p, x, ctx), new_cache


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (b, s) -> (b, s, d)."""
    return p["emb"][tokens.long()]


def lm_head_argmax(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Greedy next token from the last position, the vocabulary padding
    masked.  x (b, s, d) -> (b,) int32."""
    w = p["emb"].T if cfg.tie_embeddings else p["w_out"]
    logits = (x[:, -1] @ w).to(torch.float32)
    pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.vocab_size
    logits = logits.masked_fill(pad, NEG_INF)
    return torch.argmax(logits, dim=-1).to(torch.int32)
