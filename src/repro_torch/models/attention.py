"""Attention for the port's model path.

``ref_attention`` and ``attn_partials`` are the plain oracles (defined in
``kernels/ref.py`` beside the kernels' other plain versions).
``decode_attention`` is the single-shard decode step of the JAX
package's ``models/attention.py``: write the step's new K/V row at
``pos`` (a scalar or a ragged ``(b,)`` tensor), then attend through the
kernel dispatch.  ``decode_attention_packed`` is the same step over a
``kv_mode="int4"`` history that stays packed (``kvstore.PackedRows``):
the fresh row is not quantized before it is attended, as in the
reference, which writes it into its dequantized cache.
``spec_decode_attention`` (and ``spec_decode_attention_packed`` over
packed rows) is the speculative verify pass: ``s`` fresh rows per
sequence, each query attended as its own ragged decode step.
``chunk_prefill_attention`` is a prefill chunk's attention over the
engine-held prefix (``flash_attention`` with ``q_offset``).
``local_decode_attention`` is a sliding-window layer's decode step over
its rolling buffer, through the same ``decode_attention`` kernel.
``cross_decode_attention`` is a whisper decoder token's attention over
every cached encoder row, through the same kernel.  Layout
BSHD: q (b, sq, h, dh), k/v (b, sk, hkv, dh).

MLA (DeepSeek) keeps a latent cache, ``c`` (b, S, r) and ``kr`` (b, S,
dr), shared by every head.  ``mla_decode_attention`` is the reference's
absorbed decode step over it, in plain PyTorch on every device (the
reference computes it in jnp, not in a Pallas kernel).
``mla_prefill_attention`` is ``mla_ring_attention`` on one device: the
latent expands to per-head K/V and the causal attention runs through
``flash_attention``.

Training attends through plain, differentiable PyTorch, as the JAX
package's training path does (it reaches no Pallas kernel): the kernels
have no backward.  ``ring_attention`` and ``mla_ring_attention`` are the
reference's at ``axis=None`` (one ring step over the whole sequence),
``attn_partials`` bounds the score matrix to ``q_chunk`` query rows at a
time.

Under a mesh (inside ``in_mesh``, ``models.layers``' islands) the same
functions take their ``axis``/``axes`` branches, the reference's
collective bodies in plain PyTorch: ``ring_attention`` and
``mla_ring_attention`` rotate the K/V (the MLA latent) around the
sequence shards of ``axis`` by ``ppermute``, merging each block's
partials; ``decode_attention`` and ``mla_decode_attention`` write the
step's row into the shard that owns ``pos`` of a sequence-sharded cache
and merge the shards' ``(m, l, o)`` partials by one ``pmax`` and two
``psum``s, never the cache.  No kernel runs there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.kvstore import quantize_kv_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import _mask, ref_attention
from repro_torch.kernels.ref import attn_partials as _block_partials
from repro_torch.models.common import (NEG_INF, axis_index, axis_size,
                                       empty_partials, finalize_partials,
                                       merge_partials, pmax, ppermute, psum)

__all__ = ["ref_attention", "attn_partials", "decode_attention",
           "cross_decode_attention",
           "decode_attention_packed", "spec_decode_attention",
           "spec_decode_attention_packed", "chunk_prefill_attention",
           "local_decode_attention", "mla_decode_attention",
           "mla_prefill_attention", "ring_attention", "mla_ring_attention"]


def attn_partials(q, k, v, mask, *, q_chunk: int = 0):
    """Online-softmax partials (m (b, h, sq), l, o (b, h, sq, dv)) in
    f32 (``kernels.ref.attn_partials``).  mask (sq, sk) or (b, sq, sk)
    bool, or None.  ``q_chunk`` > 0 that divides a longer ``sq`` takes
    the queries ``q_chunk`` rows at a time, as the reference's
    ``lax.map`` does, so a score matrix never exceeds (..., q_chunk,
    sk)."""
    sq = q.shape[1]
    if not (q_chunk and sq > q_chunk and sq % q_chunk == 0):
        return _block_partials(q, k, v, mask)
    parts = [_block_partials(
        q[:, i:i + q_chunk], k, v,
        None if mask is None else mask[..., i:i + q_chunk, :])
        for i in range(0, sq, q_chunk)]
    return tuple(torch.cat(t, dim=2) for t in zip(*parts))


def ring_attention(q, k, v, *, axis=None, causal: bool = True,
                   window: int = 0, q_chunk: int = 512):
    """The JAX package's ``ring_attention``: q (b, sq, h, dh), k/v (b,
    sk, hkv, dv) -> (b, sq, h, dv) at q's dtype.  At ``axis=None`` one
    block of partials over every key (``attn_partials``, ``q_chunk``
    rows at a time), merged into the empty partials and finalized, in
    the reference's order.  Under a mesh the inputs are this rank's
    sequence shard of ``axis``: step ``t`` attends the K/V block of
    shard ``i - t`` (masked by global positions) and passes its block on
    to shard ``i + 1``; a windowed layer takes only the
    ``ceil(window / sk) + 1`` steps its window reaches."""
    b, sq, h, _ = q.shape
    sk, dv = v.shape[1], v.shape[3]
    dev = q.device
    P = axis_size(axis)
    i = axis_index(axis)
    q_pos = i * sq + torch.arange(sq, device=dev)
    steps = min(P, -(-window // sk) + 1) if window else P
    m, l, o = empty_partials((b, h, sq), dv, dev)
    for t in range(steps):
        j = (i - t) % P
        msk = _mask(q_pos, j * sk + torch.arange(sk, device=dev), causal,
                    window)
        m, l, o = merge_partials((m, l, o), attn_partials(
            q, k, v, msk, q_chunk=q_chunk))
        if axis and t < steps - 1:
            perm = [(s_, (s_ + 1) % P) for s_ in range(P)]
            k, v = ppermute(k, axis, perm), ppermute(v, axis, perm)
    return finalize_partials(m, l, o).transpose(1, 2).to(q.dtype)


def mla_ring_attention(q, c, kr, w_uk, w_uv, *, axis=None,
                       q_chunk: int = 256):
    """The JAX package's ``mla_ring_attention``: the latent c (b, sk, r)
    and kr (b, sk, dr) expand to ``k = [c . w_uk | kr]`` and ``v = c .
    w_uv``, then causal partials over q (b, sq, h, dn + dr) (``q_chunk``
    rows at a time, the reference's default of 256), merged and
    finalized -> (b, sq, h, dv) at q's dtype.  Under a mesh the ring
    rotates the latent (c, kr), not the expanded K/V, and expands each
    block where it arrives."""
    b, sq, h, _ = q.shape
    sk, dr = c.shape[1], kr.shape[-1]
    dv = w_uv.shape[-1]
    dev = q.device
    P = axis_size(axis)
    i = axis_index(axis)
    q_pos = i * sq + torch.arange(sq, device=dev)
    m, l, o = empty_partials((b, h, sq), dv, dev)
    for t in range(P):
        j = (i - t) % P
        k_nope = torch.einsum("bsr,rhn->bshn", c, w_uk)
        v = torch.einsum("bsr,rhv->bshv", c, w_uv)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(b, sk, h, dr)],
                      dim=-1)
        msk = _mask(q_pos, j * sk + torch.arange(sk, device=dev), True, 0)
        m, l, o = merge_partials((m, l, o), attn_partials(
            q, k, v, msk, q_chunk=q_chunk))
        if axis and t < P - 1:
            perm = [(s_, (s_ + 1) % P) for s_ in range(P)]
            c, kr = ppermute(c, axis, perm), ppermute(kr, axis, perm)
    return finalize_partials(m, l, o).transpose(1, 2).to(q.dtype)


def _owner_write(cache, new, pos, i: int):
    """Write the step's row ``new`` (b, 1, ...) at global position
    ``pos`` (int or (b,)) into this shard's slab ``cache`` (b, S_loc,
    ...), in place, where shard ``i`` owns it (``pos // S_loc == i``)."""
    S_loc = cache.shape[1]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        p_ = pos.to(device=cache.device, dtype=torch.long)
        owner = torch.div(p_, S_loc, rounding_mode="floor")
        loc = p_ - owner * S_loc
        rows = torch.arange(cache.shape[0], device=cache.device)
        own = (owner == i).reshape((-1,) + (1,) * (cache.ndim - 2))
        cache[rows, loc] = torch.where(own, new[:, 0].to(cache.dtype),
                                       cache[rows, loc])
    elif int(pos) // S_loc == i:
        cache[:, int(pos) - i * S_loc] = new[:, 0].to(cache.dtype)


def _merge_shards(m, l, o, axes):
    """The shards' partials merged over ``axes``: one pmax, two psums."""
    M = pmax(m, axes)
    scale = torch.exp(m - M)
    return M, psum(l * scale, axes), psum(o * scale[..., None], axes)


def _valid(pos, kv_pos):
    """Key positions ``<= pos``: (1, S) for an int, (b, 1, S) ragged."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        p_ = pos.to(device=kv_pos.device, dtype=torch.long)
        return (kv_pos[None, :] <= p_[:, None])[:, None, :]
    return (kv_pos <= int(pos))[None, :]


def decode_attention(q, k_cache, v_cache, k_new, v_new, pos, *, axes=()):
    """q (b, 1, h, dh); caches (b, S, hkv, dh); k_new/v_new (b, 1, hkv,
    dh); pos: int OR (b,) int tensor of ragged positions (each row writes
    and attends its own position).  Returns (out (b, 1, h, dh), k_cache,
    v_cache).  The caches are updated IN PLACE (the JAX package returns
    functionally updated copies; the port saves a cache-sized copy per
    layer and step).

    ``axes`` (under a mesh): the caches are this rank's sequence shard
    over ``axes``; the shard that owns ``pos`` writes the row, each
    shard computes its partials over its rows (plain PyTorch, as the
    reference's jnp) and the partials merge across shards."""
    if axes:
        i = axis_index(axes)
        S_loc = k_cache.shape[1]
        _owner_write(k_cache, k_new, pos, i)
        _owner_write(v_cache, v_new, pos, i)
        kv_pos = i * S_loc + torch.arange(S_loc, device=k_cache.device)
        m, l, o = _merge_shards(*attn_partials(q, k_cache, v_cache,
                                               _valid(pos, kv_pos)), axes)
        out = finalize_partials(m, l, o).transpose(1, 2).to(q.dtype)
        return out, k_cache, v_cache
    b = k_cache.shape[0]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        rows = torch.arange(b, device=k_cache.device)
        p = pos.to(device=k_cache.device, dtype=torch.long)
        k_cache[rows, p] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, p] = v_new[:, 0].to(v_cache.dtype)
    else:
        k_cache[:, int(pos)] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, int(pos)] = v_new[:, 0].to(v_cache.dtype)
    out = ops.decode_attention_op(q[:, 0], k_cache, v_cache, pos)
    return out[:, None], k_cache, v_cache


def decode_attention_packed(q, k_rows, v_rows, k_new, v_new, pos):
    """q (b, 1, h, dh); ``k_rows``/``v_rows`` ``PackedRows`` of the history
    (b, S, F//2); k_new/v_new (b, 1, hkv, dh); pos: int or (b,) tensor.
    Row r attends the packed rows ``< pos[r]`` and its fresh row at
    ``pos[r]``, every value at the rows' compute dtype.  Returns
    (b, 1, h, dh)."""
    hkv = k_new.shape[2]
    out = ops.decode_attention_int4_op(
        q[:, 0], k_rows.packed, k_rows.scale, v_rows.packed, v_rows.scale,
        pos, hkv=hkv, group=k_rows.group, k_new=k_new[:, 0],
        v_new=v_new[:, 0], cache_dtype=k_rows.dtype)
    return out[:, None]


def _locs(pos, b: int, s: int, device):
    """(first positions (b,) int32, rows (b, 1), positions (b, s)) of a
    step writing ``s`` rows per sequence from ``pos`` (int or (b,))."""
    p0 = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    p0 = p0.expand(b).contiguous()
    steps = torch.arange(s, device=device)
    return (p0, torch.arange(b, device=device)[:, None],
            p0.long()[:, None] + steps[None, :])


def spec_decode_attention(q, k_cache, v_cache, k_new, v_new, pos):
    """The speculative verify pass over plain caches: one step appends
    ``s`` rows per sequence (the current token and the draft's proposals)
    and attends each query through its own causal prefix.  q (b, s, h,
    dh); caches (b, S, hkv, dh); k_new/v_new (b, s, hkv, dh); ``pos``
    (int or (b,)) is the position of the FIRST new row.  The fresh rows
    are written at ``pos..pos+s-1`` in place, at the caches' dtype, then
    query ``t`` runs as the ragged decode step at ``pos + t``
    (``decode_attention``, one launch per query): it sees the loaded
    prefix, the pass's earlier rows and its own, exactly the rows
    sequential decode would see.  Returns (out (b, s, h, dh), k_cache,
    v_cache)."""
    b, s = k_new.shape[:2]
    p0, rows, locs = _locs(pos, b, s, k_cache.device)
    k_cache[rows, locs] = k_new.to(k_cache.dtype)
    v_cache[rows, locs] = v_new.to(v_cache.dtype)
    out = torch.stack([ops.decode_attention_op(q[:, t], k_cache, v_cache,
                                               p0 + t) for t in range(s)],
                      dim=1)
    return out, k_cache, v_cache


def spec_decode_attention_packed(q, k_rows, v_rows, k_new, v_new, pos):
    """The verify pass over a ``kv_mode="int4"`` history that stays packed
    (``PackedRows``).  Between sequential steps rows ``pos..pos+t-1``
    would cross the store, quantized, before query ``t`` reads them; so
    the first ``s - 1`` fresh rows are quantized with the store's row
    codec (cast to the rows' compute dtype first, as the store's save
    does) into the packed slab at ``pos..pos+s-2``, and query ``t`` runs
    ``decode_attention_int4`` at ``pos + t`` with row ``t`` as its fresh
    row: each earlier row at stored precision, its own row fresh.  The
    packed slab is written in place.  Returns (b, s, h, dh)."""
    b, s, hkv, dh = k_new.shape
    p0, rows, locs = _locs(pos, b, s - 1, k_rows.packed.device)
    if s > 1:
        for pr, new in ((k_rows, k_new), (v_rows, v_new)):
            flat = new[:, :s - 1].to(pr.dtype).reshape(b, s - 1, hkv * dh)
            packed, scale = quantize_kv_rows(flat, pr.group)
            pr.packed[rows, locs] = packed
            pr.scale[rows, locs] = scale
    return torch.stack([
        ops.decode_attention_int4_op(
            q[:, t], k_rows.packed, k_rows.scale, v_rows.packed,
            v_rows.scale, p0 + t, hkv=hkv, group=k_rows.group,
            k_new=k_new[:, t], v_new=v_new[:, t], cache_dtype=k_rows.dtype)
        for t in range(s)], dim=1)


def chunk_prefill_attention(q, k, v, *, q_offset: int):
    """Prefill-chunk attention: the chunk's queries (global positions
    ``q_offset .. q_offset+sq-1``) attend causally over the running
    prefix ``k``/``v`` (``sk = q_offset + sq`` rows: the engine-held K/V
    of earlier chunks, then the chunk's own).  Each query row sees
    exactly the columns a monolithic prefill leaves unmasked for it.
    q (b, sq, h, dh), k/v (b, sk, hkv, dh) -> (b, sq, h, dh)."""
    return ops.flash_attention_op(q, k, v, causal=True, q_offset=q_offset)


def local_decode_attention(q, k_cache, v_cache, k_new, v_new, pos, window):
    """Rolling-buffer decode for a sliding-window layer (the JAX
    package's ``local_decode_attention``): caches (b, W, hkv, dh), slot j
    holding position ``p_j = pos - ((pos - j) mod W)``; ``pos`` an int or
    a ragged (b,) tensor.  The step's row is written at slot ``pos % W``
    (in place), then each row attends the slots with ``p_j >= 0``.
    Returns (out (b, 1, h, dh), k_cache, v_cache).  ``window`` is W, the
    buffer's length (as in the reference, the buffer's shape decides).

    The valid slots are exactly ``j <= min(pos, W - 1)``: for ``pos >= W
    - 1`` every slot holds one of the last W positions, and for ``pos <
    W`` slot j > pos would hold ``pos - j + W > pos``, a position not yet
    written.  So ``decode_attention`` over the buffer, each row's
    position clamped to W - 1, computes the same function: the same
    scores over the same masked slots.  On the card that is one launch
    of the ``decode_attention`` kernel; only the order of the sums
    differs from the reference's (its plain version is the reference's
    arithmetic)."""
    del window
    b, W = k_cache.shape[:2]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        p = pos.to(device=k_cache.device)
        rows = torch.arange(b, device=k_cache.device)
        slot = (p % W).long()
        k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
        clamped = torch.clamp(p, max=W - 1)
    else:
        k_cache[:, int(pos) % W] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, int(pos) % W] = v_new[:, 0].to(v_cache.dtype)
        clamped = min(int(pos), W - 1)
    out = ops.decode_attention_op(q[:, 0], k_cache, v_cache, clamped)
    return out[:, None], k_cache, v_cache


def cross_decode_attention(q, ck, cv):
    """A decode token's cross attention over every encoder row: q (b, 1,
    h, dh); ck/cv (b, S_enc, hkv, dh), the cache (bf16 in serving); ->
    (b, 1, h, dh) at the cache's dtype.  Nothing is written and every
    row is valid, so on the card it is one ``decode_attention`` launch
    at ``pos = S_enc - 1`` for every row, its f32 output rounded to the
    cache's dtype.  The plain version (CPU tensors, or
    ``use_kernels(False)``) is the reference's own arithmetic,
    ``ref_attention(q, ck, cv, causal=False)``
    (``src/repro/models/layers.py:446`` calling
    ``src/repro/models/attention.py:47-67``): f32 scores, the softmax's
    probabilities rounded to the cache's dtype, their product with
    ``cv`` at that dtype.  It differs from the self-attention decode's
    plain version, which rounds the unnormalized partials."""
    if q.device.type == "cpu" or not ops.kernels_enabled():
        return ref_attention(q, ck, cv, causal=False)
    out = ops.decode_attention_op(q[:, 0], ck, cv, ck.shape[1] - 1)
    return out[:, None].to(cv.dtype)


def mla_decode_attention(q_eff, q_rope, c_cache, kr_cache, c_new, kr_new,
                         pos, *, scale: float, axes=()):
    """The JAX package's ``mla_decode_attention``.  q_eff (b, 1, h, r):
    ``q_nope`` absorbed through ``w_uk``; q_rope (b, 1, h, dr); latent
    caches c_cache (b, S, r), kr_cache (b, S, dr); the step's rows c_new
    (b, 1, r), kr_new (b, 1, dr); ``pos`` an int or a ragged (b,)
    tensor.  The rows are written at ``pos`` IN PLACE, at the caches'
    dtype, by the shard that owns it (on one device: a position outside
    the slab writes nothing); row i attends positions ``<= pos[i]`` with
    f32 scores ``(q_eff . c + q_rope . kr) * scale``.
    A row with nothing to attend (the reference's dead rows) gets zero
    probabilities.  The probabilities are rounded to the cache dtype
    before ``p . c``, and that product to the cache dtype, as the
    reference's ``einsum(p.astype(c.dtype), c)`` does; under a mesh
    (``axes``: the caches are this rank's sequence shard) the shards'
    ``(m, l, o)`` merge by one pmax and two psums; ``ctx = o / max(l,
    1e-30)``.  Returns (ctx (b, 1, h, r) f32, c_cache, kr_cache)."""
    b, S, _ = c_cache.shape
    dev = c_cache.device
    i = axis_index(axes)
    _owner_write(c_cache, c_new, pos, i)
    _owner_write(kr_cache, kr_new, pos, i)
    kv_pos = i * S + torch.arange(S, device=dev)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        valid = _valid(pos, kv_pos)[:, None]                # (b, 1, 1, S)
    else:
        valid = kv_pos <= int(pos)                          # (S,)
    f32 = torch.float32
    s = (torch.einsum("bqhr,bsr->bhqs", q_eff.to(f32), c_cache.to(f32))
         + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32),
                        kr_cache.to(f32))) * scale
    s = torch.where(valid, s, torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    dead = m <= NEG_INF / 2
    p = torch.where(dead[..., None], torch.zeros((), device=dev), p)
    l = p.sum(dim=-1)
    dt = c_cache.dtype
    o = torch.einsum("bhqs,bsr->bhqr", p.to(dt).to(f32),
                     c_cache.to(f32)).to(dt).to(f32)
    if axes:
        m, l, o = _merge_shards(m, l, o, axes)
    ctx = o / torch.clamp_min(l, 1e-30)[..., None]         # (b, h, 1, r)
    return ctx.transpose(1, 2), c_cache, kr_cache


def mla_prefill_attention(q, c, kr, w_uk, w_uv):
    """Causal MLA attention over the prompt's own latent rows: the JAX
    package's ``mla_ring_attention`` with ``axis=None``.  q (b, s, h, dn
    + dr) (nope then rope); c (b, s, r); kr (b, s, dr); w_uk (r, h, dn);
    w_uv (r, h, dv).  The latent expands to ``k = [c . w_uk | kr]`` (b,
    s, h, dn + dr), ``kr`` broadcast over the heads, and ``v = c . w_uv``
    (b, s, h, dv); then one ``flash_attention`` at head_dim ``dn + dr``
    with V zero-padded from ``dv`` to ``dn + dr``.  That is exact: the
    kernel's scale ``1/sqrt(dn + dr)`` is the reference's, and zero
    columns of V add nothing to the columns kept.  Returns (b, s, h,
    dv)."""
    b, s, h, dq = q.shape
    dr = kr.shape[-1]
    dv = w_uv.shape[-1]
    if dv > dq:
        raise ValueError(f"mla_prefill_attention: v_head_dim {dv} wider "
                         f"than the query's {dq}")
    k_nope = torch.einsum("bsr,rhn->bshn", c, w_uk)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    v = F.pad(torch.einsum("bsr,rhv->bshv", c, w_uv), (0, dq - dv))
    out = ops.flash_attention_op(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    return out[..., :dv]
