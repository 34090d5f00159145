"""Mamba2 / SSD (state-space duality) [arXiv:2405.21060].

The port of the JAX package's ``models/ssm.py``:

  * ``segsum``: lower-triangular segment sums, ``-inf`` above the
    diagonal so that ``exp`` gives exact zeros (the mask is applied
    before ``exp``, so no ``-inf - -inf`` reaches it);
  * ``ssd_chunked``: the intra-chunk quadratic (dual) form, the chunk
    summaries, and the inter-chunk recurrence as a loop over chunks with
    the reference's combine ``(a1 * a2, s1 * a2 + s2)``; the reference
    runs that combine under ``lax.associative_scan``, so the two agree
    to rounding, not bit for bit;
  * ``ssd_sequential``: the token-by-token oracle (tests only);
  * ``ssd_decode_step``: one token's recurrent update.

Everything computes in f32, whatever dtype arrives.  A group of ``B``/``C``
serves ``H // G`` consecutive heads (the reference's ``repeat``).
``ssd_sharded`` runs under a mesh with the sequence sharded over an
axis: each shard scans its own rows, the shards' (decay, state)
summaries are all-gathered, each shard applies its true incoming state
through ``state_factor``, and the last shard's final state is psum'd to
every shard.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import (all_gather, axis_index, axis_size,
                                       psum)

F32 = torch.float32


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N): group g serves heads g*H/G .. (g+1)*H/G - 1."""
    G = t.shape[-2]
    return torch.repeat_interleave(t, H // G, dim=-2)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., cs) -> (..., cs, cs): ``out[i, j] = sum(a[j+1..i])`` for
    i >= j, ``-inf`` otherwise."""
    cs = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(cs, device=a.device)
    mask = i[:, None] >= i[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, A, B, C, chunk: int, h_init=None):
    """Chunked SSD.

    xh (b, l, H, hd); dt (b, l, H) (softplus already applied); A (H,)
    negative; B, C (b, l, G, N).  Returns (y (b, l, H, hd), h_final (b, H,
    hd, N), (state_factor (b, l, H), total_decay (b, H))):
    ``state_factor`` is each position's decay from the sequence start,
    which applies an external initial state through C."""
    b, l, H, hd = xh.shape
    G, N = B.shape[-2:]
    if l % chunk:
        raise ValueError(f"ssd_chunked: length {l} is not a multiple of "
                         f"chunk {chunk}")
    nc, cs = l // chunk, chunk
    xh = xh.to(F32).reshape(b, nc, cs, H, hd)
    dt = dt.to(F32).reshape(b, nc, cs, H)
    B_ = B.to(F32).reshape(b, nc, cs, G, N)
    C_ = C.to(F32).reshape(b, nc, cs, G, N)
    dA = dt * A.to(F32)                                   # (b, nc, cs, H)
    Acs = torch.cumsum(dA, dim=2)
    dtx = dt[..., None] * xh                              # (b, nc, cs, H, hd)

    # intra-chunk (quadratic dual form)
    L = torch.exp(segsum(dA.movedim(2, -1)))              # (b, nc, H, cs, cs)
    CB = torch.einsum("bcigr,bcjgr->bcgij", C_, B_)       # (b, nc, G, cs, cs)
    CB = torch.repeat_interleave(CB, H // G, dim=2)       # (b, nc, H, cs, cs)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", CB * L, dtx)

    # chunk summaries: sum_j exp(A_end - Acs_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(Acs[:, :, -1:, :] - Acs)     # (b, nc, cs, H)
    B_heads = _heads(B_, H)                               # (b, nc, cs, H, N)
    S = torch.einsum("bcjhn,bcjhp,bcjh->bchpn", B_heads, dtx, decay_to_end)
    chunk_decay = torch.exp(Acs[:, :, -1, :])             # (b, nc, H)

    # inter-chunk recurrence, chunk by chunk: (a1, s1) then (a2, s2) ->
    # (a1 * a2, s1 * a2 + s2)
    a_run, s_run = chunk_decay[:, 0], S[:, 0]
    a_scan, s_scan = [a_run], [s_run]
    for c in range(1, nc):
        a2 = chunk_decay[:, c]
        a_run = a_run * a2
        s_run = s_run * a2[..., None, None] + S[:, c]
        a_scan.append(a_run)
        s_scan.append(s_run)
    a_scan = torch.stack(a_scan, dim=1)                   # (b, nc, H)
    s_scan = torch.stack(s_scan, dim=1)                   # (b, nc, H, hd, N)
    h_start = torch.cat([torch.zeros_like(s_scan[:, :1]), s_scan[:, :-1]],
                        dim=1)
    h_final = s_scan[:, -1]

    # inter-chunk states applied to the outputs
    C_heads = _heads(C_, H)                               # (b, nc, cs, H, N)
    in_decay = torch.exp(Acs)
    y_off = torch.einsum("bcihn,bchpn,bcih->bcihp", C_heads, h_start,
                         in_decay)
    y = y_diag + y_off

    prefix_excl = torch.cat([torch.ones_like(a_scan[:, :1]), a_scan[:, :-1]],
                            dim=1)
    state_factor = (in_decay * prefix_excl[:, :, None, :]).reshape(b, l, H)
    total_decay = a_scan[:, -1]

    if h_init is not None:
        h0 = h_init.to(F32)
        y = y + torch.einsum("bihn,bhpn,bih->bihp",
                             C_heads.reshape(b, l, H, N), h0,
                             state_factor).reshape(b, nc, cs, H, hd)
        h_final = h_final + h0 * total_decay[..., None, None]
    return y.reshape(b, l, H, hd), h_final, (state_factor, total_decay)


def ssd_sequential(xh, dt, A, B, C, h_init=None):
    """The token-by-token recurrence (the oracle): (y (b, l, H, hd), h)."""
    b, l, H, hd = xh.shape
    N = B.shape[-1]
    h = (torch.zeros((b, H, hd, N), dtype=F32, device=xh.device)
         if h_init is None else h_init.to(F32))
    ys = []
    for t in range(l):
        y, h = ssd_decode_step(xh[:, t], dt[:, t], A, B[:, t], C[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def ssd_decode_step(xh, dt, A, B, C, h: Optional[torch.Tensor]):
    """One token.  xh (b, H, hd); dt (b, H); B, C (b, G, N); h (b, H, hd,
    N).  Returns (y (b, H, hd), h')."""
    H = xh.shape[1]
    B_heads, C_heads = _heads(B.to(F32), H), _heads(C.to(F32), H)
    dt = dt.to(F32)
    decay = torch.exp(dt * A.to(F32))
    upd = torch.einsum("bhn,bhp,bh->bhpn", B_heads, xh.to(F32), dt)
    h = h.to(F32) * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", C_heads, h)
    return y, h


def ssd_sharded(xh, dt, A, B, C, chunk: int, axis):
    """Sequence-sharded SSD (inside ``in_mesh``; ``axis=None`` or one
    shard: ``ssd_chunked``).  The inputs are this rank's rows of
    ``axis``; the incoming state of shard ``i`` is ``sum_{j<i} state_j
    * prod_{j<m<i} decay_m`` over the gathered summaries, applied
    through ``state_factor``.  Returns (y (b, l_loc, H, hd), the global
    final state (b, H, hd, N), the same on every shard)."""
    y, h_final, (state_factor, total_decay) = ssd_chunked(
        xh, dt, A, B, C, chunk)
    if not axis or axis_size(axis) == 1:
        return y, h_final
    P = axis_size(axis)
    i = axis_index(axis)
    decays = all_gather(total_decay, axis, tiled=False)   # (P, b, H)
    states = all_gather(h_final, axis, tiled=False)       # (P, b, H, hd, N)
    # walk back j = i-1 .. 0 over the same P - 1 candidates on every shard
    # (masked where j < 0): each shard's backward then runs the same
    # collectives
    h_in = torch.zeros_like(h_final)
    run = torch.ones_like(total_decay)
    for step_back in range(1, P):
        j = i - step_back
        valid = torch.tensor(j >= 0, device=xh.device)
        h_in = h_in + torch.where(valid, states[max(j, 0)],
                                  0.0) * run[..., None, None]
        run = run * torch.where(valid, decays[max(j, 0)], 1.0)
    b, l, H, hd = xh.shape
    C_heads = _heads(C.to(F32), H)
    y = y + torch.einsum("bihn,bhpn,bih->bihp", C_heads, h_in, state_factor)
    h_final = h_final + h_in * total_decay[..., None, None]
    last = torch.tensor(i == P - 1, device=xh.device)
    return y, psum(torch.where(last, h_final, 0.0), axis)
