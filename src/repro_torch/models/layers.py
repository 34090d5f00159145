"""Layer parameter tables and apply functions for ``ATTN``,
``ATTN_LOCAL``, ``MLA``, ``SSM``, ``ENC`` and ``CROSS`` layers with a
``DENSE`` or ``MOE`` feed-forward.

The single-device subset of the JAX package's ``models/layers.py``: the
tables (``name -> ParamDef(shape, axes, scale)``) that drive
``models.transformer.init_params``, and the layer math the serving
engines run (the offloaded one per unit, the resident one over the whole
stack).  Resident INT4 tables (``cfg.quant_weights``, which the dry
run's ``w4`` variant sets) replace each eligible 2-D projection of the
attention and dense-FFN tables by a packed ``name#q``/``name#s`` pair
(``_maybe_quant``), which ``_mm`` sends through ``int4_matmul``; the
cross attention reads its ``c``-prefixed tables unpacked, as the
reference does, so a ``quant_weights`` whisper raises ``KeyError`` there
in both packages.  An ``ENC`` layer
(whisper's encoder) is bidirectional attention
without rope; a ``CROSS`` layer (whisper's decoder) is a causal
self-attention, then attention over every encoder row through the
``c``-prefixed projections (``apply_cross_layer``), its decode cache the
self-attention's ``k``/``v`` slabs beside the encoder's ``ck``/``cv``
rows.  ``cfg.qk_norm`` (Qwen3) normalizes q and k per head before
rope; an ``ATTN_LOCAL`` layer (Gemma 3) attends a sliding window of
``cfg.window`` positions and keeps a rolling ``(b, W, hkv, dh)`` buffer
as its decode cache.  An ``MLA`` layer (DeepSeek) projects through low-rank
``wq_a``/``wq_b`` and ``wkv_a`` and caches a latent per token (``c``,
``kv_lora_rank`` wide, and the single-head rope key ``kr``); its prefill
expands the latent through ``w_uk``/``w_uv`` and runs ``flash_attention``,
its decode absorbs ``w_uk`` into the query and attends the latent cache
(``mla_decode_attention``, plain PyTorch as the reference's jnp).  An
``SSM`` layer (Mamba2) projects through ``_mm``, runs a depthwise causal
conv and the SSD scan (``models.ssm``, plain PyTorch as the reference's
jnp) and keeps a conv halo and an f32 state per sequence as its decode
cache.  An MoE layer's routed experts run in
``models.moe``; with
``moe_quant="int4"`` their stacks arrive packed (``w_gate#q``/``#s``)
and go to ``int4_matmul`` expert by expert.

Train mode (``Ctx.mode == "train"``, the JAX package's training path)
launches no kernel: every sequence attention is plain, differentiable
PyTorch (``ring_attention``; MLA's ``mla_ring_attention``; a cross
attention the reference's ``ref_attention``), the SSM runs
``ssd_chunked`` and MoE ``moe_ffn`` as at prefill, no layer builds a
cache, and ``apply_layer`` returns each layer's load-balance loss for
``lm_head_loss``'s caller to add.

Under a mesh (``Ctx.dist`` a ``Dist`` with one, the JAX package's
``shard_map`` islands): each rank holds its shard of the activations,
the batch over the data axes and, outside decode, the sequence over
``model`` (``Ctx.act_spec``); every per-token op runs on the shard as it
is, with each layer's weights all-gathered where they are used
(``use_params``; the routed-expert stacks stay split over ``model``, and
their ff dim over ``data`` where ``_moe_ff_axis`` says so), and the ops
that mix rows run their collective bodies inside ``in_mesh``: the ring
over ``model`` (``ring_attention``, ``mla_ring_attention``), the
flash-decode over a sequence-sharded cache (``decode_attention``,
``mla_decode_attention`` with ``axes``), the SSM's conv halo
(``ppermute``) and ``ssd_sharded``, the MoE's three expert-parallel
branches (train and prefill ``moe_ffn`` over ``all_to_all`` with the
capacity taken on the local tokens; decode ``moe_ffn_decode`` when the
ff dim is split, else ``moe_ffn_replicated``), and the vocabulary-sharded
``embed_tokens``, ``lm_head_loss`` and ``lm_head_argmax``.  The sharded
path's sequence attention is the plain ring and partials, as the
reference's islands are jnp; what stays on one shard (a rolling buffer,
the encoder rows) runs as on one device.  A sharded branch that cannot run
raises; nothing falls back to the local branch.  Without a mesh
(``Dist.local()``, the default, as the serving engines build ``Ctx``)
every function runs exactly as on one device.

Outside train mode every attention goes through the port's kernels: prefill
(and the encoder, and a cross attention's prefill, at ``causal=False``)
through ``flash_attention``, decode through ``decode_attention`` over the
loaded cache (bf16 in serving; a cross attention's decode over its
encoder rows at the last row's position) or ``decode_attention_int4``
over packed rows, and a packed ``name#q``/``name#s`` projection through
``int4_matmul``.  The ``quant=None`` projections, the cross attention's
``cwq``/``cwk``/``cwv``/``cwo`` and the LM head stay ``torch.matmul``,
as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, CROSS, DENSE, ENC,
                                      MLA, MOE, SSM, LayerSpec, ModelConfig)
from repro_torch.core.kvstore import PackedRows
from repro_torch.kernels.ops import flash_attention_op, int4_matmul_op
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (chunk_prefill_attention,
                                          cross_decode_attention,
                                          decode_attention,
                                          decode_attention_packed,
                                          local_decode_attention,
                                          mla_decode_attention,
                                          mla_prefill_attention,
                                          mla_ring_attention, ref_attention,
                                          ring_attention,
                                          spec_decode_attention,
                                          spec_decode_attention_packed)
from repro_torch.models.common import (NEG_INF, Dist, all_gather,
                                       axis_index, axis_size, chunk,
                                       in_mesh, pmax, pmean, ppermute, psum,
                                       psum_scatter, relayout, rms_norm,
                                       silu)
from repro_torch.models.rope import apply_rope


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple          # logical axis names, len == len(shape)
    scale: float = -1.0  # -1 -> fan-in default; 0 -> zeros


def _dense_only(cfg: ModelConfig, spec: LayerSpec):
    if spec.mixer not in (ATTN, ATTN_LOCAL, MLA, SSM, ENC, CROSS) \
            or spec.ffn not in (DENSE, MOE):
        raise NotImplementedError(
            f"the port runs ATTN, ATTN_LOCAL, MLA, SSM, ENC and CROSS "
            f"layers with a DENSE or MOE feed-forward, got {spec} "
            f"({cfg.name})")


# ===========================================================================
# Parameter tables
# ===========================================================================


QUANT_GROUP = 128


def _maybe_quant(cfg: ModelConfig, table: dict) -> dict:
    """Under ``cfg.quant_weights`` each eligible 2-D entry (K % 128 == 0,
    an even N, K * N >= 2**16) becomes a packed ``name#q`` (K, N/2) and
    its scales ``name#s`` (K/128, N), the reference's rule; the scales
    -2 and -3 mark them for ``init_params``."""
    if not cfg.quant_weights:
        return table
    out = {}
    for name, pd in table.items():
        K = pd.shape[0] if pd.shape else 0
        if (len(pd.shape) == 2 and K % QUANT_GROUP == 0
                and pd.shape[1] % 2 == 0 and K * pd.shape[1] >= 1 << 16):
            out[name + "#q"] = ParamDef((K, pd.shape[1] // 2),
                                        (pd.axes[0], pd.axes[1]), -2.0)
            out[name + "#s"] = ParamDef((K // QUANT_GROUP, pd.shape[1]),
                                        (None, pd.axes[1]), -3.0)
        else:
            out[name] = pd
    return out


def attn_table(cfg: ModelConfig, cross: bool = False) -> dict:
    """The attention projections; ``cross``: the cross attention's
    ``c``-prefixed ones, without ``qk_norm``'s norms."""
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pre = "c" if cross else ""
    t = {
        pre + "wq": ParamDef((d, h * dh), ("embed", "heads_ff")),
        pre + "wk": ParamDef((d, hkv * dh), ("embed", "kv_ff")),
        pre + "wv": ParamDef((d, hkv * dh), ("embed", "kv_ff")),
        pre + "wo": ParamDef((h * dh, d), ("heads_ff", "embed")),
    }
    t = _maybe_quant(cfg, t)
    if cfg.qk_norm and not cross:
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


def ssm_table(cfg: ModelConfig) -> dict:
    """The reference's Mamba2 table: five projections at their fan-in,
    the depthwise ``conv_w`` (d_conv, conv_ch), ``conv_b`` and
    ``ssm_norm`` at 0, and ``A_log``, ``D`` and ``dt_bias`` (H,) drawn at
    scale 1."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    conv_ch = d_in + 2 * gn
    return {
        "z_proj": ParamDef((d, d_in), ("embed", "ff")),
        "x_proj": ParamDef((d, d_in), ("embed", "ff")),
        "bc_proj": ParamDef((d, 2 * gn), ("embed", None)),
        "dt_proj": ParamDef((d, H), ("embed", "heads")),
        "conv_w": ParamDef((s.d_conv, conv_ch), (None, "ff")),
        "conv_b": ParamDef((conv_ch,), ("ff",), 0.0),
        "A_log": ParamDef((H,), ("heads",), 1.0),
        "D": ParamDef((H,), ("heads",), 1.0),
        "dt_bias": ParamDef((H,), ("heads",), 1.0),
        "ssm_norm": ParamDef((d_in,), ("ff",), 0.0),
        "out_proj": ParamDef((d_in, d), ("ff", "embed")),
    }


def mixer_table(cfg: ModelConfig, spec: LayerSpec) -> dict:
    _dense_only(cfg, spec)
    if spec.mixer == MLA:
        return mla_table(cfg)
    if spec.mixer == SSM:
        return ssm_table(cfg)
    if spec.mixer == CROSS:
        return {**attn_table(cfg), **attn_table(cfg, cross=True),
                "norm_cross": ParamDef((cfg.d_model,), (None,), 0.0)}
    return attn_table(cfg)


def ffn_table(cfg: ModelConfig, spec: LayerSpec) -> dict:
    _dense_only(cfg, spec)
    d = cfg.d_model
    if spec.ffn == DENSE:
        if cfg.d_ff == 0:
            return {}
        return _maybe_quant(cfg, {
            "w_gate": ParamDef((d, cfg.d_ff), ("embed", "ff")),
            "w_up": ParamDef((d, cfg.d_ff), ("embed", "ff")),
            "w_down": ParamDef((cfg.d_ff, d), ("ff", "embed")),
        })
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
    mode: str                               # train | prefill | decode
    angles: Optional[torch.Tensor] = None   # (s, half) or (b, s, half)
    pos: Any = None                         # decode position: int or (b,)
    memory: Optional[torch.Tensor] = None   # (b, s_enc, d) encoder output
    is_encoder: bool = False
    dist: Dist = Dist()                     # the mesh, or local
    batch_size: int = 0                     # global batch (0: shardable)

    @property
    def sharded(self) -> bool:
        return self.dist.is_dist

    @property
    def dp(self):
        """The batch dim's axes; None when the batch cannot shard (b=1)."""
        ax = self.dist.data_axes
        if not ax:
            return None
        if self.batch_size and self.dist.is_dist:
            n = self.dist.size(ax)
            if self.batch_size % n != 0 or self.batch_size < n:
                return None
        return ax if len(ax) > 1 else ax[0]

    def act_spec(self):
        """The spec of (b, s, ...) activations."""
        if self.mode == "decode":
            return (self.dp, None)
        return (self.dp, self.dist.model_axis)

    def seq_axis(self):
        return self.dist.model_axis if self.mode != "decode" else None


def _moe_ff_axis(ctx: Ctx):
    """The mesh axis the expert ff dim is storage-sharded over, or None;
    mirrors ``launch.sharding.AXIS_RULES``' divisibility rule."""
    if (not ctx.dist.is_dist or ctx.cfg.moe is None
            or "data" not in ctx.dist.shape):
        return None
    f = ctx.cfg.moe.expert_d_ff
    n = ctx.dist.shape["data"]
    return "data" if (f % n == 0 and f >= n) else None


def use_params(p, specs, table, ctx: Ctx):
    """A layer's local weight shards (laid out by ``specs``, the storage
    specs) at the layout its islands use: an expert stack split over
    ``model`` on its experts and over ``_moe_ff_axis`` on its ff dim
    (the reference's ``w_specs``), every other weight whole
    (all-gathered).  Differentiable: each gather's backward
    psum-scatters the layer's gradient back to the shards."""
    ff_axis = _moe_ff_axis(ctx)
    rule = {"experts": ctx.dist.model_axis, "expert_ff": ff_axis}
    out = {}
    with in_mesh(ctx.dist):
        for name, t in p.items():
            pd = table[name]
            want = (tuple(rule.get(a) for a in pd.axes)
                    if is_expert_stack(pd) else (None,) * t.ndim)
            out[name] = relayout(t, specs[name], want)
    return out


def _gather_seq(ctx: Ctx, *ts):
    """Sequence shards (dim 1) gathered over ``model``: every row."""
    with in_mesh(ctx.dist):
        return tuple(all_gather(t, ctx.seq_axis(), 1) for t in ts)


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


def _qkv(p, xn, ctx: Ctx, rope: bool = True):
    """The projections, per-head RMSNorm of q and k under ``qk_norm``,
    then rope (the reference's order; none for an encoder layer)."""
    cfg = ctx.cfg
    b, s, _ = xn.shape
    q = _mm(xn, p, "wq").reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = _mm(xn, p, "wk").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _mm(xn, p, "wv").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if ctx.angles is not None and rope:
        q = apply_rope(q, ctx.angles)
        k = apply_rope(k, ctx.angles)
    return q, k, v


def apply_attention(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """Returns (x', new_cache).  Prefill: ``new_cache`` is the prompt's
    rows (``_build_cache``).  Decode: ``new_cache`` is the step's fresh
    rows at the cache's compute dtype, the rows the reference gathers
    back out of its updated cache for the save; for an ``ATTN_LOCAL``
    layer the whole updated rolling buffer, which the reference saves
    whole.  An ``ENC`` layer attends every row (``causal=False``) without
    rope."""
    cfg = ctx.cfg
    b, s, d = x.shape
    window = cfg.window if spec.mixer == ATTN_LOCAL else 0
    enc = spec.mixer == ENC
    xn = rms_norm(x, p["norm_mixer"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, ctx, rope=not enc)
    if ctx.mode == "decode":
        out, new_cache = _decode_attn(q, k, v, ctx, cache, window)
    elif ctx.mode == "train":
        out = _seq_attn(q, k, v, ctx, not enc, window)
        new_cache = None
    else:
        out = (_seq_attn(q, k, v, ctx, not enc, window) if ctx.sharded
               else flash_attention_op(q, k, v, causal=not enc,
                                       window=window))
        new_cache = None
        if ctx.mode == "prefill" and not ctx.is_encoder:
            if ctx.sharded:
                k, v = _gather_seq(ctx, k, v)
            new_cache = _build_cache(k, v, ctx, window)
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


def _seq_attn(q, k, v, ctx: Ctx, causal: bool, window: int):
    """Full-sequence attention, plain: the ring over ``model`` under a
    mesh, one block locally (the training path's)."""
    axis = ctx.seq_axis() if ctx.sharded else None
    with in_mesh(ctx.dist):
        return ring_attention(q, k, v, axis=axis, causal=causal,
                              window=window)


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
    if ctx.sharded:
        return _decode_attn_sharded(q, k_new, v_new, ctx, kc, vc, window)
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


def _decode_attn_sharded(q, k_new, v_new, ctx: Ctx, kc, vc, window: int):
    """The sharded decode step: a rolling buffer (replicated over
    ``model``) as on one device; a slab sequence-sharded over the KV
    axes by the flash-decode merge."""
    if q.shape[1] > 1 or isinstance(kc, PackedRows):
        raise NotImplementedError(
            "a verify pass or packed rows under a mesh: the reference's "
            "speculative and offloaded engines run Dist.local()")
    if window:
        out, kc, vc = local_decode_attention(q, kc, vc, k_new, v_new,
                                             ctx.pos, window)
        return out, {"k": kc, "v": vc}
    with in_mesh(ctx.dist):
        out, _, _ = decode_attention(q, kc, vc, k_new, v_new, ctx.pos,
                                     axes=ctx.dist.kv_shard_axes)
    return out, {"k": k_new.to(kc.dtype), "v": v_new.to(kc.dtype)}


# ===========================================================================
# Cross-attention (whisper decoder)
# ===========================================================================


def apply_cross_layer(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """The JAX package's ``apply_cross_layer`` -> (x', new_cache): a
    causal self-attention (``apply_attention`` as ``ATTN``), then
    ``rms_norm(norm_cross)``, ``q = xn @ cwq`` and attention over every
    encoder row, then ``@ cwo``.  Prefill projects the encoder output
    ``ctx.memory`` to ``ck``/``cv`` (plain matmuls, as the reference's)
    and attends them through ``flash_attention`` at ``causal=False``
(in train mode through the reference's own ``ref_attention``, with no
cache);
    decode attends the cached ``ck``/``cv`` (``cross_decode_attention``)
    and passes them through unchanged.  ``new_cache``: the
    self-attention's rows beside ``ck``/``cv``."""
    cfg = ctx.cfg
    b, s, d = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x, new_cache = apply_attention(p, x, ctx, cache, LayerSpec(ATTN, spec.ffn))
    xn = rms_norm(x, p["norm_cross"], cfg.norm_eps)
    q = (xn @ p["cwq"]).reshape(b, s, h, dh)
    if ctx.mode == "decode":
        ck, cv = cache["ck"], cache["cv"]
        out = cross_decode_attention(q, ck, cv)
    else:
        mem = ctx.memory
        sm = mem.shape[1]
        ck = (mem @ p["cwk"]).reshape(b, sm, hkv, dh)
        cv = (mem @ p["cwv"]).reshape(b, sm, hkv, dh)
        if ctx.sharded:     # every encoder row, each rank its own queries
            ck, cv = _gather_seq(ctx, ck, cv)
        out = (ref_attention(q, ck, cv, causal=False) if ctx.mode == "train"
               else flash_attention_op(q, ck, cv, causal=False))
    out = out.reshape(b, s, h * dh).to(x.dtype)
    if ctx.mode == "train":
        return x + out @ p["cwo"], None
    return x + out @ p["cwo"], {**new_cache, "ck": ck, "cv": cv}


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
        with in_mesh(ctx.dist):
            ctxl, _, _ = mla_decode_attention(
                q_eff, q_rope, cc, krc, c, k_rope, ctx.pos,
                scale=1.0 / math.sqrt(dn + dr),
                axes=ctx.dist.kv_shard_axes if ctx.sharded else ())
        out = torch.einsum("bshr,rhv->bshv", ctxl.to(x.dtype), p["w_uv"])
        new_cache = {"c": c.to(cc.dtype), "kr": k_rope.to(krc.dtype)}
    elif ctx.mode == "train" or ctx.sharded:
        # the MLA-aware ring: the latent rotates, each block expands
        with in_mesh(ctx.dist):
            out = mla_ring_attention(
                torch.cat([q_nope, q_rope], dim=-1), c, k_rope, p["w_uk"],
                p["w_uv"], axis=ctx.seq_axis() if ctx.sharded else None)
        new_cache = None
        if ctx.mode == "prefill":
            c_all, kr_all = _gather_seq(ctx, c, k_rope)
            new_cache = {"c": c_all, "kr": kr_all}
    else:
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = mla_prefill_attention(q, c, k_rope, p["w_uk"], p["w_uv"])
        new_cache = ({"c": c, "kr": k_rope} if ctx.mode == "prefill"
                     else None)
    return x + _mm(out.reshape(b, s, h * dv), p, "wo"), new_cache


# ===========================================================================
# SSM (Mamba2)
# ===========================================================================


def _pick_chunk(length: int, target: int) -> int:
    """Largest divisor of ``length`` that is <= ``target`` (a prime
    length above ``target`` takes 1: one chunk a token)."""
    for c in range(min(target, length), 0, -1):
        if length % c == 0:
            return c
    return 1


def _causal_conv(x, w, b, halo=None):
    """Depthwise causal conv by shifted adds, in the reference's order.
    x (b, l, ch); w (width, ch); halo (b, width-1, ch), the previous
    context, or None (zeros).  A halo of another dtype is cast to
    ``x``'s first (the reference's concatenate promotes it)."""
    width = w.shape[0]
    if halo is None:
        halo = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([halo.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out + b


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in its own arithmetic:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def apply_ssm(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """The JAX package's ``apply_ssm`` on one device -> (x', new_cache).

    Prefill returns ``{"conv": conv_in[:, -(d_conv-1):], "state": h}``
    at compute precision (a prompt shorter than ``d_conv - 1`` gives
    fewer halo rows, as in the reference).  Decode rolls the halo,
    ``cat([halo, conv_in])[:, 1:]`` (the halo cast to ``conv_in``'s
    dtype first), runs one recurrent step over ``cache["state"]`` and
    returns both new leaves whole.  The five projections go through
    ``_mm`` (packed ones to ``int4_matmul``); the conv, the scan, ``D``
    and the gated RMSNorm are plain PyTorch."""
    del spec
    cfg = ctx.cfg
    s_cfg = cfg.ssm
    b, l, d = x.shape
    d_in = s_cfg.expand * d
    hd = s_cfg.head_dim
    H = d_in // hd
    G, N = s_cfg.n_groups, s_cfg.d_state
    gn = G * N
    xn = rms_norm(x, p["norm_mixer"], cfg.norm_eps)
    z = _mm(xn, p, "z_proj")                              # (b, l, d_in)
    xin = _mm(xn, p, "x_proj")
    bc = _mm(xn, p, "bc_proj")                            # (b, l, 2 gn)
    dt_raw = _mm(xn, p, "dt_proj")                        # (b, l, H)
    A = -torch.exp(p["A_log"].to(torch.float32))
    D = p["D"].to(torch.float32)[:, None]
    conv_in = torch.cat([xin, bc], dim=-1)                # (b, l, conv_ch)
    if ctx.mode == "decode":
        halo = cache["conv"]
        conv = silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"], halo))
        new_halo = torch.cat([halo.to(conv_in.dtype), conv_in], dim=1)[:, 1:]
        xc = conv[..., :d_in].reshape(b, H, hd)
        Bc = conv[..., d_in:d_in + gn].reshape(b, G, N)
        Cc = conv[..., d_in + gn:].reshape(b, G, N)
        dt = softplus(dt_raw[:, 0] + p["dt_bias"])        # (b, H)
        state = cache["state"]
        heads_split = ctx.sharded and state.shape[1] != H
        if heads_split:     # the cache's heads over ``model``
            with in_mesh(ctx.dist):
                state = all_gather(state, ctx.dist.model_axis, 1)
        y, h_new = ssm_mod.ssd_decode_step(xc, dt, A, Bc, Cc, state)
        y = (y + xc.to(torch.float32) * D).reshape(b, 1, d_in)
        h_new = h_new.to(torch.float32)
        if heads_split:
            with in_mesh(ctx.dist):
                h_new = chunk(h_new, ctx.dist.model_axis, 1)
        new_cache = {"conv": new_halo, "state": h_new}
    elif ctx.sharded:
        y, new_cache = _ssm_seq_sharded(p, conv_in, dt_raw, A, D, ctx)
    else:
        dt = softplus(dt_raw + p["dt_bias"])
        conv = silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
        xc = conv[..., :d_in].reshape(b, l, H, hd)
        Bc = conv[..., d_in:d_in + gn].reshape(b, l, G, N)
        Cc = conv[..., d_in + gn:].reshape(b, l, G, N)
        y, h_fin, _ = ssm_mod.ssd_chunked(xc, dt, A, Bc, Cc,
                                          _pick_chunk(l, s_cfg.chunk_size))
        y = (y + xc.to(torch.float32) * D).reshape(b, l, d_in)
        new_cache = ({"conv": conv_in[:, -(s_cfg.d_conv - 1):],
                      "state": h_fin.to(torch.float32)}
                     if ctx.mode == "prefill" else None)
    # gated RMSNorm, then the out projection
    y = rms_norm(y.to(x.dtype) * silu(z), p["ssm_norm"], cfg.norm_eps)
    return x + _mm(y, p, "out_proj"), new_cache


def _ssm_seq_sharded(p, conv_in, dt_raw, A, D, ctx: Ctx):
    """The SSM's train/prefill body under a mesh, on this rank's
    sequence shard: the conv's halo comes from the previous shard
    (``ppermute``; the first shard's is zeros), then ``ssd_sharded``.
    Returns (y (b, l_loc, d_in) f32, the prefill cache: the last
    ``d_conv - 1`` rows of the whole sequence and the final state, or
    None in train mode)."""
    s_cfg = ctx.cfg.ssm
    b, l, ch = conv_in.shape
    d_in = s_cfg.expand * ctx.cfg.d_model
    hd = s_cfg.head_dim
    H = d_in // hd
    G, N = s_cfg.n_groups, s_cfg.d_state
    gn = G * N
    axis = ctx.seq_axis()
    width = s_cfg.d_conv
    dt = softplus(dt_raw + p["dt_bias"])
    with in_mesh(ctx.dist):
        tail = conv_in[:, -(width - 1):]
        prev = ppermute(tail, axis,
                        [(i, i + 1) for i in range(axis_size(axis) - 1)])
        conv = silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"], prev))
        xc = conv[..., :d_in].reshape(b, l, H, hd)
        Bc = conv[..., d_in:d_in + gn].reshape(b, l, G, N)
        Cc = conv[..., d_in + gn:].reshape(b, l, G, N)
        y, h_fin = ssm_mod.ssd_sharded(xc, dt, A, Bc, Cc,
                                       _pick_chunk(l, s_cfg.chunk_size), axis)
        y = (y + xc.to(torch.float32) * D).reshape(b, l, d_in)
        if ctx.mode != "prefill":
            return y, None
        halo = all_gather(tail, axis, tiled=False)[-1]
    return y, {"conv": halo, "state": h_fin.to(torch.float32)}


def apply_mixer(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """The layer's mixer half -> (x', new_cache)."""
    if spec.mixer == MLA:
        return apply_mla(p, x, ctx, cache, spec)
    if spec.mixer == SSM:
        return apply_ssm(p, x, ctx, cache, spec)
    if spec.mixer == CROSS:
        return apply_cross_layer(p, x, ctx, cache, spec)
    return apply_attention(p, x, ctx, cache, spec)


# ===========================================================================
# FFN, whole layer, embedding, head
# ===========================================================================


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    """A dense layer's load-balance loss: f32 zero."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def apply_dense_ffn(p, x, ctx: Ctx):
    """The dense SwiGLU feed-forward; a streamed INT4 unit's packed
    ``w_gate#q`` pairs go through ``_mm``.  A resident INT4 table
    (``cfg.quant_weights``) holds ``w_gate#q`` where the reference looks
    for ``w_gate``, so the reference skips its feed-forward: so does the
    port (ROADMAP Queue 3 item 24)."""
    cfg = ctx.cfg
    if cfg.d_ff == 0 or ("w_gate" not in p and (
            cfg.quant_weights or "w_gate#q" not in p)):
        return x
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    h = silu(_mm(xn, p, "w_gate")) * _mm(xn, p, "w_up")
    return x + _mm(h, p, "w_down")


def shared_expert(p, xn):
    """The MoE layer's always-on shared expert on the normed ``xn``."""
    h = silu(_mm(xn, p, "ws_gate")) * _mm(xn, p, "ws_up")
    return _mm(h, p, "ws_down")


def apply_moe_ffn(p, x, ctx: Ctx):
    """The MoE feed-forward: route and combine the routed experts, then
    add the shared expert.  Returns (x', the load-balance loss).  On one
    device over the whole bank; under a mesh by the reference's
    expert-parallel branches (``_moe_sharded``)."""
    cfg = ctx.cfg
    b, s, d = x.shape
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    if ctx.sharded:
        out, aux = _moe_sharded(p, xn, ctx)
    else:
        out, aux = moe_mod.moe_ffn(xn.reshape(b * s, d), p, cfg.moe)
    x = x + out.reshape(b, s, d)
    if cfg.moe.num_shared:
        x = x + shared_expert(p, xn)
    return x, aux


def _moe_sharded(p, xn, ctx: Ctx):
    """The reference's three branches over ``model`` (experts) and
    ``_moe_ff_axis`` (each expert's ff dim): decode with the ff dim split
    gathers the batch and runs ``moe_ffn_decode``, one psum over both
    axes; decode otherwise runs ``moe_ffn_replicated``; train and prefill
    run ``moe_ffn`` over ``all_to_all`` on the local tokens, the capacity
    taken on their count (``T_loc``), the ff slices all-gathered first.
    Returns (out like ``xn``, aux)."""
    m = ctx.cfg.moe
    bl, sl, d = xn.shape
    axis = ctx.dist.model_axis
    ff_axis = _moe_ff_axis(ctx)
    data = ctx.dist.data_axes
    w = {k: p[k] for k in ("wg", "w_gate", "w_up", "w_down")}
    with in_mesh(ctx.dist):
        if ctx.mode == "decode" and ff_axis is not None:
            spec = (ctx.dp, None, None)
            xa = relayout(xn, spec, (None, None, None))
            o, a = moe_mod.moe_ffn_decode(
                xa.reshape(-1, d), w, m, ep_axis=axis, ff_axis=ff_axis,
                combine_axes=(ff_axis, axis))
            return relayout(o.reshape(xa.shape), (None, None, None),
                            spec), a
        if ctx.mode == "decode":
            o, a = moe_mod.moe_ffn_replicated(xn.reshape(-1, d), w, m,
                                              axis=axis)
            return o.reshape(xn.shape), pmean(a, data) if ctx.dp else a
        T_loc = bl * sl
        capacity = int(m.capacity_factor * T_loc * m.top_k
                       / m.num_experts) + 1
        if ff_axis is not None:    # the FSDP gather of the expert slices
            w["w_gate"] = all_gather(w["w_gate"], ff_axis, 2)
            w["w_up"] = all_gather(w["w_up"], ff_axis, 2)
            w["w_down"] = all_gather(w["w_down"], ff_axis, 1)
        o, a = moe_mod.moe_ffn(xn.reshape(T_loc, d), w, m, capacity,
                               axis=axis)
        a = pmean(a, data + (axis,)) if ctx.dp else pmean(a, axis)
        return o.reshape(xn.shape), a


def apply_layer(p, x, ctx: Ctx, cache, spec: LayerSpec):
    """One ATTN, ATTN_LOCAL, MLA, SSM, ENC or CROSS layer with its DENSE
    or MOE feed-forward -> (x', new_cache, aux): ``aux`` the MoE
    feed-forward's load-balance loss, f32 zero for a dense one."""
    _dense_only(ctx.cfg, spec)
    x, new_cache = apply_mixer(p, x, ctx, cache, spec)
    if spec.ffn == MOE:
        x, aux = apply_moe_ffn(p, x, ctx)
        return x, new_cache, aux
    return apply_dense_ffn(p, x, ctx), new_cache, _no_aux(x)


def _head_ctx(ctx):
    """(cfg, the ``Ctx`` under a mesh or None): the head functions take
    a ``Ctx``, or a ``ModelConfig`` for one device (the engines')."""
    if isinstance(ctx, Ctx):
        return ctx.cfg, (ctx if ctx.sharded else None)
    return ctx, None


def embed_tokens(p, tokens: torch.Tensor, ctx: Optional[Ctx] = None):
    """tokens (b, s) -> (b, s, d).  Under a mesh ``p["emb"]`` is this
    rank's vocabulary shard over ``model`` and each shard looks up the
    ids in its slice (zeros elsewhere): a psum merges them, or, with the
    sequence sharded over the same axis, every token is gathered first
    and a psum-scatter returns each rank its rows."""
    if ctx is None or not ctx.sharded:
        return p["emb"][tokens.long()]
    axis = ctx.dist.model_axis
    s_sharded = ctx.mode != "decode"
    emb = p["emb"]
    with in_mesh(ctx.dist):
        V_loc = emb.shape[0]
        start = axis_index(axis) * V_loc
        tok = all_gather(tokens, axis, 1) if s_sharded else tokens
        rel = tok.long() - start
        ok = (rel >= 0) & (rel < V_loc)
        e = torch.where(ok[..., None], emb[torch.clamp(rel, 0, V_loc - 1)],
                        0.0)
        return psum_scatter(e, axis, 1) if s_sharded else psum(e, axis)


def _w_out(p, cfg: ModelConfig) -> torch.Tensor:
    return p["emb"].T if cfg.tie_embeddings else p["w_out"]


def lm_head_loss(p, x: torch.Tensor, labels: torch.Tensor, ctx,
                 s_chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy, the reference's head: f32 logits of ``x
    @ w_out`` (x (b, s, d), labels (b, s) int), the vocabulary padding
    masked to ``NEG_INF``, the mean of ``lse - ll``.  ``ctx``: a
    ``Ctx``, or the ``ModelConfig`` on one device.

    Under a mesh the head is vocabulary-sharded over ``model``: x and
    the labels are all-gathered over ``model``, each shard computes its
    logits ``s_chunk`` rows at a time and the softmax statistics merge
    by pmax/psum, so no rank holds the whole vocabulary's logits; the
    loss is then averaged over the data axes (the same on every rank)."""
    cfg, sh = _head_ctx(ctx)
    if sh is None:
        logits = (x @ _w_out(p, cfg)).to(torch.float32)
        pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.mean(lse - ll)
    axis = sh.dist.model_axis
    w = _w_out(p, cfg)
    with in_mesh(sh.dist):
        x_all = all_gather(x, axis, 1)
        lab = all_gather(labels, axis, 1)
        V_loc = w.shape[1]
        start = axis_index(axis) * V_loc
        pad_mask = (start + torch.arange(V_loc, device=x.device)) \
            < cfg.vocab_size
        s = x_all.shape[1]
        n = max(1, s // s_chunk) if s % s_chunk == 0 else 1
        cs = s // n
        losses = []
        for c in range(n):
            xc, lc = x_all[:, c * cs:(c + 1) * cs], lab[:, c * cs:(c + 1) * cs]
            lg = (xc @ w).to(torch.float32)
            lg = torch.where(pad_mask, lg, NEG_INF)
            m = pmax(lg.amax(dim=-1), axis)
            se = psum(torch.exp(lg - m[..., None]).sum(dim=-1), axis)
            lse = m + torch.log(se)
            rel = lc.long() - start
            ok = (rel >= 0) & (rel < V_loc)
            ll = torch.gather(lg, -1,
                              torch.clamp(rel, 0, V_loc - 1)[..., None])[..., 0]
            losses.append(lse - psum(torch.where(ok, ll, 0.0), axis))
        return pmean(torch.mean(torch.stack(losses)), sh.dist.data_axes)


def lm_head_argmax(p, x: torch.Tensor, ctx) -> torch.Tensor:
    """Greedy next token from the last position, the vocabulary padding
    masked.  x (b, s, d) -> (b,) int32.  ``ctx``: a ``Ctx``, or the
    ``ModelConfig`` on one device.  Under a mesh each vocabulary shard
    takes its own best and a pmax picks the best of them (on a tie
    across shards the higher id, as the reference's)."""
    cfg, sh = _head_ctx(ctx)
    w = _w_out(p, cfg)
    if sh is None:
        logits = (x[:, -1] @ w).to(torch.float32)
        pad = torch.arange(logits.shape[-1], device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    axis = sh.dist.model_axis
    with in_mesh(sh.dist):
        V_loc = w.shape[1]
        start = axis_index(axis) * V_loc
        lg = (x[:, -1] @ w).to(torch.float32)
        lg = torch.where((start + torch.arange(V_loc, device=x.device))
                         < cfg.vocab_size, lg, NEG_INF)
        m_loc = lg.amax(dim=-1)
        i_loc = torch.argmax(lg, dim=-1).to(torch.int32) + start
        m = pmax(m_loc, axis)
        idx = torch.where(m_loc >= m, i_loc, torch.full_like(i_loc, -1))
        return pmax(idx, axis)


def lm_head_argmax_positions(p, x: torch.Tensor,
                             cfg: ModelConfig) -> torch.Tensor:
    """Per-position greedy tokens for the verify pass: every one of the
    ``b * s`` positions goes through ``lm_head_argmax``'s row arithmetic
    as a sequence of its own.  x (b, s, d) -> (b, s) int32."""
    b, s, d = x.shape
    return lm_head_argmax(p, x.reshape(b * s, 1, d), cfg).reshape(b, s)
