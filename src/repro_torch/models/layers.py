"""Layer parameter tables and apply functions for ``ATTN``,
``ATTN_LOCAL`` and ``MLA`` layers with a ``DENSE`` or ``MOE``
feed-forward.

The single-device subset of the JAX package's ``models/layers.py``: the
tables (``name -> ParamDef(shape, axes, scale)``) that drive
``models.transformer.init_params``, and the layer math the serving
engines run (the offloaded one per unit, the resident one over the whole
stack).  Sharding (``Dist``) and the other mixers come with later
slices.  ``cfg.qk_norm`` (Qwen3) normalizes q and k per head before
rope; an ``ATTN_LOCAL`` layer (Gemma 3) attends a sliding window of
``cfg.window`` positions and keeps a rolling ``(b, W, hkv, dh)`` buffer
as its decode cache.  An ``MLA`` layer (DeepSeek) projects through low-rank
``wq_a``/``wq_b`` and ``wkv_a`` and caches a latent per token (``c``,
``kv_lora_rank`` wide, and the single-head rope key ``kr``); its prefill
expands the latent through ``w_uk``/``w_uv`` and runs ``flash_attention``,
its decode absorbs ``w_uk`` into the query and attends the latent cache
(``mla_decode_attention``, plain PyTorch as the reference's jnp).  An MoE
layer's routed experts run in
``models.moe``; with
``moe_quant="int4"`` their stacks arrive packed (``w_gate#q``/``#s``)
and go to ``int4_matmul`` expert by expert.

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

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, DENSE, MLA, MOE,
                                      LayerSpec, ModelConfig)
from repro_torch.core.kvstore import PackedRows
from repro_torch.kernels.ops import flash_attention_op, int4_matmul_op
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (chunk_prefill_attention,
                                          decode_attention,
                                          decode_attention_packed,
                                          local_decode_attention,
                                          mla_decode_attention,
                                          mla_prefill_attention,
                                          spec_decode_attention,
                                          spec_decode_attention_packed)
from repro_torch.models.common import NEG_INF, rms_norm, silu
from repro_torch.models.rope import apply_rope


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis names, len == len(shape)
    scale: float = -1.0  # -1 -> fan-in default; 0 -> zeros


def _dense_only(cfg: ModelConfig, spec: LayerSpec):
    if spec.mixer not in (ATTN, ATTN_LOCAL, MLA) \
            or spec.ffn not in (DENSE, MOE) or cfg.quant_weights:
        raise NotImplementedError(
            f"the port runs ATTN, ATTN_LOCAL and MLA layers with a DENSE or "
            f"MOE feed-forward, got {spec} ({cfg.name}, quant_weights="
            f"{cfg.quant_weights}); the SSM, CROSS and ENC mixers and "
            f"resident INT4 tables (quant_weights) come with later slices")


# ===========================================================================
# Parameter tables
# ===========================================================================


def attn_table(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        "wq": ParamDef((d, h * dh), ("embed", "heads_ff")),
        "wk": ParamDef((d, hkv * dh), ("embed", "kv_ff")),
        "wv": ParamDef((d, hkv * dh), ("embed", "kv_ff")),
        "wo": ParamDef((h * dh, d), ("heads_ff", "embed")),
    }
    if cfg.qk_norm:
        t["q_norm"] = ParamDef((dh,), (None,), 0.0)
        t["k_norm"] = ParamDef((dh,), (None,), 0.0)
    return t


def mla_table(cfg: ModelConfig) -> dict:
    """The reference's MLA table: ``w_uk``/``w_uv`` are (r, h, n), drawn
    at the fan-in of their leading dim (the latent rank)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ParamDef((d, m.q_lora_rank), ("embed", "lora")),
        "q_a_norm": ParamDef((m.q_lora_rank,), (None,), 0.0),
        "wq_b": ParamDef((m.q_lora_rank, h * dq), ("lora", "heads_ff")),
        "wkv_a": ParamDef((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", "lora")),
        "kv_a_norm": ParamDef((m.kv_lora_rank,), (None,), 0.0),
        "w_uk": ParamDef((m.kv_lora_rank, h, m.qk_nope_head_dim),
                         ("lora", "heads", None)),
        "w_uv": ParamDef((m.kv_lora_rank, h, m.v_head_dim),
                         ("lora", "heads", None)),
        "wo": ParamDef((h * m.v_head_dim, d), ("heads_ff", "embed")),
    }


def mixer_table(cfg: ModelConfig, spec: LayerSpec) -> dict:
    _dense_only(cfg, spec)
    if spec.mixer == MLA:
        return mla_table(cfg)
    return attn_table(cfg)


def ffn_table(cfg: ModelConfig, spec: LayerSpec) -> dict:
    _dense_only(cfg, spec)
    d = cfg.d_model
    if spec.ffn == DENSE:
        if cfg.d_ff == 0:
            return {}
        return {
            "w_gate": ParamDef((d, cfg.d_ff), ("embed", "ff")),
            "w_up": ParamDef((d, cfg.d_ff), ("embed", "ff")),
            "w_down": ParamDef((cfg.d_ff, d), ("ff", "embed")),
        }
    m = cfg.moe
    t = {
        "wg": ParamDef((d, m.num_experts), ("embed", None)),
        "w_gate": ParamDef((m.num_experts, d, m.expert_d_ff),
                           ("experts", "embed", "expert_ff")),
        "w_up": ParamDef((m.num_experts, d, m.expert_d_ff),
                         ("experts", "embed", "expert_ff")),
        "w_down": ParamDef((m.num_experts, m.expert_d_ff, d),
                           ("experts", "expert_ff", "embed")),
    }
    if m.num_shared:
        sf = m.shared_d_ff * m.num_shared
        t.update({
            "ws_gate": ParamDef((d, sf), ("embed", "ff")),
            "ws_up": ParamDef((d, sf), ("embed", "ff")),
            "ws_down": ParamDef((sf, d), ("ff", "embed")),
        })
    return t


def is_expert_stack(pd: ParamDef) -> bool:
    """Whether a table entry is a routed-expert stack ``(E, ...)``."""
    return pd.axes[:1] == ("experts",)


def layer_table(cfg: ModelConfig, spec: LayerSpec) -> dict:
    _dense_only(cfg, spec)
    t = {"norm_mixer": ParamDef((cfg.d_model,), (None,), 0.0)}
    t.update(mixer_table(cfg, spec))
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


def _qkv(p, xn, ctx: Ctx):
    """The projections, per-head RMSNorm of q and k under ``qk_norm``,
    then rope (the reference's order)."""
    cfg = ctx.cfg
    b, s, _ = xn.shape
    q = _mm(xn, p, "wq").reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = _mm(xn, p, "wk").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _mm(xn, p, "wv").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if ctx.angles is not None:
        q = apply_rope(q, ctx.angles)
        k = apply_rope(k, ctx.angles)
    return q, k, v


def apply_attention(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """Returns (x', new_cache).  Prefill: ``new_cache`` is the prompt's
    rows (``_build_cache``).  Decode: ``new_cache`` is the step's fresh
    rows at the cache's compute dtype, the rows the reference gathers
    back out of its updated cache for the save; for an ``ATTN_LOCAL``
    layer the whole updated rolling buffer, which the reference saves
    whole."""
    cfg = ctx.cfg
    b, s, d = x.shape
    window = cfg.window if spec.mixer == ATTN_LOCAL else 0
    xn = rms_norm(x, p["norm_mixer"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, ctx)
    if ctx.mode == "decode":
        out, new_cache = _decode_attn(q, k, v, ctx, cache, window)
    else:
        out = flash_attention_op(q, k, v, causal=True, window=window)
        new_cache = (_build_cache(k, v, ctx, window)
                     if ctx.mode == "prefill" else None)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    return x + _mm(out, p, "wo"), new_cache


def apply_layer_chunk(p, x, ctx: Ctx, prefix_k, prefix_v, q_offset: int):
    """One ATTN+DENSE layer applied to a prefill CHUNK (``qk_norm`` as in
    ``apply_attention``).

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
    q, k, v = _qkv(p, xn, ctx)
    kk = k if prefix_k is None else torch.cat([prefix_k, k], dim=1)
    vv = v if prefix_v is None else torch.cat([prefix_v, v], dim=1)
    out = chunk_prefill_attention(q, kk, vv, q_offset=q_offset)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim)
    x = x + _mm(out, p, "wo")
    return apply_dense_ffn(p, x, ctx), k, v


def _build_cache(k, v, ctx: Ctx, window: int = 0):
    """Prefill: the prompt's fresh K/V rows (b, s, hkv, dh) at compute
    precision.  The reference lays them into a zeroed ``max_len`` slab;
    the port ships only the prompt's rows and the KV store zero-fills the
    rest of the slot on the host (``TieredKVStore.save_prefill``).

    With a ``window`` W the rows become the rolling buffer (b, W, hkv,
    dh), as the reference builds it: a prompt shorter than W is
    zero-padded to W rows; a longer one keeps, in slot j, the latest
    position p < s with p % W == j, i.e. ``p_j = s - W + ((j - s % W) %
    W)``."""
    if not window:
        return {"k": k, "v": v}
    s, W = k.shape[1], window
    if s < W:
        pad = (0, 0, 0, 0, 0, W - s)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad)}
    p_idx = s - W + (torch.arange(W, device=k.device) - s % W) % W
    return {"k": k[:, p_idx], "v": v[:, p_idx]}


def _decode_attn(q, k_new, v_new, ctx: Ctx, cache, window: int = 0):
    """One decode step at ``ctx.pos`` (int or ragged (b,)) over the
    loaded cache: a plain slab (the step's row written in at the slab's
    dtype) or packed rows (the row attended beside them).  ``s > 1``
    rows per sequence are a speculative verify pass from ``ctx.pos``.
    With a ``window`` the cache is the layer's rolling buffer
    (``local_decode_attention``), returned whole.  Returns (out, the
    fresh rows at the cache's compute dtype)."""
    kc, vc = cache["k"], cache["v"]
    if window:
        out, kc, vc = local_decode_attention(q, kc, vc, k_new, v_new,
                                             ctx.pos, window)
        return out, {"k": kc, "v": vc}
    spec = q.shape[1] > 1
    if isinstance(kc, PackedRows):
        fn = spec_decode_attention_packed if spec else decode_attention_packed
        out = fn(q, kc, vc, k_new, v_new, ctx.pos)
    else:
        fn = spec_decode_attention if spec else decode_attention
        out, _, _ = fn(q, kc, vc, k_new, v_new, ctx.pos)
    return out, {"k": k_new.to(kc.dtype), "v": v_new.to(kc.dtype)}


# ===========================================================================
# MLA (DeepSeek)
# ===========================================================================


def apply_mla(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """The JAX package's ``apply_mla`` on one device -> (x', new_cache).
    Decode runs the absorbed path over the latent cache (``cache["c"]``,
    ``cache["kr"]``: slabs, or ``PackedRows`` that dequantize to the
    rows' compute dtype first) and returns the step's fresh rows at the
    cache's dtype; prefill runs the expanded path and returns the
    prompt's latent rows (b, s, r) and (b, s, dr) at compute precision.
    The projections go through ``_mm`` (packed ones to ``int4_matmul``);
    ``w_uk``/``w_uv`` (3-D, never packed) stay f32 einsums."""
    del spec
    cfg = ctx.cfg
    m = cfg.mla
    b, s, d = x.shape
    h = cfg.num_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    xn = rms_norm(x, p["norm_mixer"], cfg.norm_eps)
    qa = rms_norm(_mm(xn, p, "wq_a"), p["q_a_norm"], cfg.norm_eps)
    qb = _mm(qa, p, "wq_b").reshape(b, s, h, dn + dr)
    q_nope, q_rope = qb[..., :dn], qb[..., dn:]
    kv_a = _mm(xn, p, "wkv_a")                            # (b, s, r + dr)
    c = rms_norm(kv_a[..., :r], p["kv_a_norm"], cfg.norm_eps)
    k_rope = kv_a[..., r:]
    if ctx.angles is not None:
        q_rope = apply_rope(q_rope, ctx.angles)
        k_rope = apply_rope(k_rope[:, :, None, :], ctx.angles)[:, :, 0]
    if ctx.mode == "decode":
        if s != 1:
            raise ValueError(f"apply_mla: decode takes one row per "
                             f"sequence, got {s}")
        cc, krc = cache["c"], cache["kr"]
        if isinstance(cc, PackedRows):
            cc, krc = cc.dequantize(), krc.dequantize()
        q_eff = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"])
        ctxl, _, _ = mla_decode_attention(
            q_eff, q_rope, cc, krc, c, k_rope, ctx.pos,
            scale=1.0 / math.sqrt(dn + dr))
        out = torch.einsum("bshr,rhv->bshv", ctxl.to(x.dtype), p["w_uv"])
        new_cache = {"c": c.to(cc.dtype), "kr": k_rope.to(krc.dtype)}
    else:
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = mla_prefill_attention(q, c, k_rope, p["w_uk"], p["w_uv"])
        new_cache = ({"c": c, "kr": k_rope} if ctx.mode == "prefill"
                     else None)
    return x + _mm(out.reshape(b, s, h * dv), p, "wo"), new_cache


def apply_mixer(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """The layer's mixer half -> (x', new_cache)."""
    if spec.mixer == MLA:
        return apply_mla(p, x, ctx, cache, spec)
    return apply_attention(p, x, ctx, cache, spec)


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


def shared_expert(p, xn):
    """The MoE layer's always-on shared expert on the normed ``xn``."""
    h = silu(_mm(xn, p, "ws_gate")) * _mm(xn, p, "ws_up")
    return _mm(h, p, "ws_down")


def apply_moe_ffn(p, x, ctx: Ctx):
    """The MoE feed-forward over the whole bank (single device): route
    and combine the routed experts, then add the shared expert.  Returns
    (x', the load-balance loss)."""
    cfg = ctx.cfg
    b, s, d = x.shape
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    out, aux = moe_mod.moe_ffn(xn.reshape(b * s, d), p, cfg.moe)
    x = x + out.reshape(b, s, d)
    if cfg.moe.num_shared:
        x = x + shared_expert(p, xn)
    return x, aux


def apply_layer(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """One ATTN, ATTN_LOCAL or MLA layer with its DENSE or MOE
    feed-forward -> (x', new_cache)."""
    _dense_only(ctx.cfg, spec)
    x, new_cache = apply_mixer(p, x, ctx, cache, spec)
    if spec.ffn == MOE:
        return apply_moe_ffn(p, x, ctx)[0], new_cache
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


def lm_head_argmax_positions(p, x: torch.Tensor,
                             cfg: ModelConfig) -> torch.Tensor:
    """Per-position greedy tokens for the verify pass: every one of the
    ``b * s`` positions goes through ``lm_head_argmax``'s row arithmetic
    as a sequence of its own.  x (b, s, d) -> (b, s) int32."""
    b, s, d = x.shape
    return lm_head_argmax(p, x.reshape(b * s, 1, d), cfg).reshape(b, s)
