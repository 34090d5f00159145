"""PIPO memory model (paper §3.5 + Appendix B), generalized to every
ModelConfig in the registry.

Notation follows the paper: l layers, d model dim, V vocab, p precision
bytes, b batch, s input length (prompt + generated), h heads, h_kv KV
heads, d_h MLP hidden dim.

  W = 2*W_embed + l*(W_mha + W_mlp)
  C = 2*p*b*s*l*d*(h_kv/h)                (total KV cache)
  peak M = max(M_mha, M_mlp, M_embed) with/without preloading

``preload`` generalizes the paper's boolean to an integer *depth*: the
number of extra resident layers the pipeline keeps in flight beyond the
computing one (``PipelineScheduler(depth=D)`` holds D+1 layers).  The
paper's performance pipeline is depth 1, the memory pipeline depth 0.
``depth_capacity`` inverts the model: the largest depth whose resident
window still fits a device budget.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class MemoryEstimate:
    weights: int          # total weight bytes W
    kv_cache: int         # total KV bytes C
    peak_prefill: int     # peak device bytes, prefill stage
    peak_decode: int      # peak device bytes, decode stage
    w_mha: int
    w_mlp: int
    w_embed: int


def weight_sizes(cfg: ModelConfig, p: int):
    """(W_embed, W_mha, W_mlp) for one layer, paper Appendix B shapes."""
    d = cfg.d_model
    w_embed = p * d * cfg.vocab_size
    if cfg.num_heads:
        hkv_ratio = cfg.num_kv_heads / cfg.num_heads
        w_mha = p * d * (cfg.num_heads * cfg.head_dim
                         + 2 * cfg.num_kv_heads * cfg.head_dim
                         + cfg.num_heads * cfg.head_dim) \
            + p * d  # norm
    else:  # SSM mixer
        w_mha = p * cfg.mixer_params(cfg.pattern[0])
    if cfg.moe is not None and any(sp.ffn == "moe" for sp in cfg.pattern):
        w_mlp = p * cfg.ffn_params(cfg.pattern[-1])
    else:
        w_mlp = p * 3 * d * cfg.d_ff
    return w_embed, w_mha, w_mlp


def estimate(cfg: ModelConfig, *, batch: int, seq: int, p: int = 2,
             preload: "bool | int" = True) -> MemoryEstimate:
    d, V, l = cfg.d_model, cfg.vocab_size, cfg.num_layers
    b, s = batch, seq
    h = max(1, cfg.num_heads)
    d_h = max(1, cfg.d_ff)
    hkv_ratio = (cfg.num_kv_heads / h) if cfg.num_heads else 0.0

    w_embed, w_mha, w_mlp = weight_sizes(cfg, p)
    W = 2 * w_embed + l * (w_mha + w_mlp)
    C = int(2 * p * b * s * l * d * hkv_ratio)
    C_layer = C // max(1, l)

    pre_n = int(preload)              # extra resident layers (preload depth)

    # ---- prefill stage (Appendix B.1) ----
    m_mha_pre = (p * b * s * (5 * d + h * s)
                 + w_mha + pre_n * w_mlp + (1 + pre_n) * C_layer)
    m_mlp_pre = (p * b * s * (3 * d_h + 2 * d)
                 + w_mlp + pre_n * w_mha + pre_n * C_layer)
    m_embed_pre = p * b * s * (d + V) + (1 + pre_n) * w_embed
    peak_prefill = max(m_mha_pre, m_mlp_pre, m_embed_pre)

    # ---- decode stage (Appendix B.2): input length 1 ----
    m_mha_dec = (p * b * (5 * d + h)
                 + w_mha + pre_n * w_mlp + (1 + pre_n) * 2 * p * b * s * d
                 * hkv_ratio)
    m_mlp_dec = (p * b * (3 * d_h + 2 * d)
                 + w_mlp + pre_n * w_mha + pre_n * 2 * p * b * s * d
                 * hkv_ratio)
    m_embed_dec = p * b * (d + V) + (1 + pre_n) * w_embed
    peak_decode = max(m_mha_dec, m_mlp_dec, m_embed_dec)

    return MemoryEstimate(int(W), int(C), int(peak_prefill),
                          int(peak_decode), int(w_mha), int(w_mlp),
                          int(w_embed))


def quant_weight_ratio(p: int, quant: "str | None") -> float:
    """Streamed-weight byte ratio under quantization: INT4 packs two
    nibbles per byte (+ scales), so weights cost ~0.5 bytes each against
    a p-byte baseline.  The single source for the convention shared by
    ``configure``, ``depth_capacity``, and ``serving_preload_depth``."""
    return (0.5 / p) if quant == "int4" else 1.0


def quant_kv_ratio(p: int, kv_mode: "str | None") -> float:
    """Streamed/pinned KV byte ratio under ``kv_mode``: INT4 cache rows
    are stored and cross the link packed (two nibbles per byte + group
    scales), the same 0.5-byte convention as ``quant_weight_ratio`` —
    in-flight preloads and host-pinned cache both sit packed; the f32
    expansion only exists inside the consuming compute."""
    return (0.5 / p) if kv_mode == "int4" else 1.0


def depth_capacity(cfg: ModelConfig, *, batch: int, seq: int, p: int = 2,
                   budget_bytes: int, quant: "str | None" = None,
                   kv_mode: "str | None" = None,
                   kv_layer_bytes: "int | None" = None,
                   depth_cap: int = 8) -> int:
    """Largest preload depth whose resident window fits ``budget_bytes``
    of device memory.

    Depth D keeps D+1 schedulable layers resident: the computing layer
    plus D in-flight preloads, each pinning its weights and its decode KV
    working copy.  Activations are depth-independent, so the marginal
    cost of one more depth step is one layer's weights (quant-scaled:
    INT4 units cross the link and sit in flight packed, the same
    convention ``autoconfig.configure`` uses for placement) plus one
    layer's KV payload; the base cost is the depth-0 peak.  The KV term
    is the modeled live slab (``kv_mode``-scaled) unless the caller
    passes ``kv_layer_bytes`` — the EXACT per-layer live KV_LOAD size a
    ``TieredKVStore`` measures, which replaces the model entirely (the
    adaptive window's pricing is then exact, not modeled).  Always
    returns at least 1 — the pipeline's minimum useful window — even
    when the budget is already blown (placement, not depth, is the knob
    there)."""
    est0 = estimate(cfg, batch=batch, seq=seq, p=p, preload=0)
    base = max(est0.peak_prefill, est0.peak_decode)
    w_layer = int(max(est0.w_mha, est0.w_mlp)
                  * quant_weight_ratio(p, quant))
    if kv_layer_bytes is not None:
        kv_layer = int(kv_layer_bytes)
    else:
        kv_layer = int(est0.kv_cache // max(1, cfg.num_layers)
                       * quant_kv_ratio(p, kv_mode))
    per_extra = max(1, w_layer + kv_layer)
    headroom = budget_bytes - base
    if headroom < per_extra:
        return 1
    return int(max(1, min(depth_cap, headroom // per_extra)))


def host_pinned_bytes(cfg: ModelConfig, *, b_max: int, max_len: int,
                      p: int = 4, quant: "str | None" = None,
                      kv_mode: "str | None" = None,
                      placement: str = "host") -> "tuple[int, int]":
    """(fixed_bytes, per_spill_bytes) the serving host tier pins: the
    full decode KV cache (packed under ``kv_mode="int4"`` — the tiered
    KV store keeps cache rows AND their spills as nibbles) plus — for
    host placement — the weights themselves (packed under quant, the
    same byte convention as ``quant_weight_ratio``; disk placement keeps
    only in-flight buffers in host RAM), and the marginal cost of one
    retained slot spill (one request's KV rows).  The single
    implementation behind BOTH the resolve-time host guard
    (``autoconfig.serving_depth_decision``) and the live one
    (``live_depth``) — the two must never drift."""
    est = estimate(cfg, batch=b_max, seq=max_len, p=p, preload=1)
    w_host = int(est.weights * quant_weight_ratio(p, quant)) \
        if placement == "host" else 0
    kv = int(est.kv_cache * quant_kv_ratio(p, kv_mode))
    return w_host + kv, kv // max(1, b_max)


def live_depth(cfg: ModelConfig, *, active: int, pos_used: int,
               b_max: int, max_len: int, p: int = 4,
               quant: "str | None" = None,
               kv_mode: "str | None" = None, spills: int = 0,
               placement: str = "host", device_budget: int,
               host_budget: int, depth_cap: int = 8,
               host_fixed: "int | None" = None,
               per_spill: "int | None" = None,
               kv_layer_bytes: "int | None" = None) -> int:
    """Preload depth under LIVE serving pressure (the ``AdaptiveDepth``
    policy's model): the static sizing prices the window at worst case —
    ``b_max`` slots, every one at ``max_len`` — but between decode steps
    the engine knows how many requests are actually in flight
    (``active``), the longest position actually written (``pos_used``),
    and how many slot spills the host currently retains (``spills``).
    Feeding those into the same §3.5 capacity model yields a window that
    deepens under light load and shrinks as KV/spill pressure ramps:

      * device side: ``depth_capacity`` at (batch=active, seq=pos_used+1)
        — the KV payload each in-flight layer pins is priced at its live
        occupancy, not the allocation bound; when the engine measures the
        exact live KV_LOAD size (``TieredKVStore.load_nbytes``) it passes
        ``kv_layer_bytes`` and the modeled term drops out entirely;
      * host side: the ``serving_preload_depth`` guard with the *live*
        retained-spill count instead of the worst-case ``spill_cap`` —
        a host saturated by spills forces depth 1 exactly as at resolve
        time.

    ``host_fixed``/``per_spill`` accept the load-invariant
    ``host_pinned_bytes`` terms precomputed once (the per-step caller's
    fast path — AdaptiveDepth sits on the decode hot path).
    """
    b = max(1, min(int(active), b_max))
    s = max(8, min(int(pos_used) + 1, max_len))
    if host_fixed is None or per_spill is None:
        host_fixed, per_spill = host_pinned_bytes(
            cfg, b_max=b_max, max_len=max_len, p=p, quant=quant,
            kv_mode=kv_mode, placement=placement)
    if host_fixed + spills * per_spill > host_budget:
        return 1
    return depth_capacity(cfg, batch=b, seq=s, p=p,
                          budget_bytes=device_budget, quant=quant,
                          kv_mode=kv_mode, kv_layer_bytes=kv_layer_bytes,
                          depth_cap=depth_cap)
