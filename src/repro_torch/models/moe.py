"""Mixture-of-Experts: sort-based capacity dispatch (the single-device
part of the JAX package's ``models/moe.py``).

Dispatch is gather/scatter based: every (token, choice) pair lands in a
capacity slot of its expert's ``(E, C, d)`` buffer, overflow pairs are
dropped, and the experts' outputs are gathered back and combined with
the router weights.  ``moe_ffn`` routes and computes over the full bank;
``moe_ffn_union`` is the offloaded engines' compact combine over the
routed union only.

Expert parallelism (the reference's, under a mesh inside ``in_mesh``):
``moe_ffn``'s ``axis`` branch holds ``E / P`` experts per shard of
``axis``; each shard routes its own tokens over all ``E`` and the
dispatch buffer goes out and back through two ``all_to_all``s.
``moe_ffn_replicated`` (decode) routes tokens replicated over ``axis``
through the local experts only, capacity ``T`` (no drops), and merges
by one ``psum``; ``moe_ffn_decode`` is the same with each expert's ff
dim sliced over a second axis, one ``psum`` over both merging the ff
partial sums and the experts.

Expert weights come in one of two forms, per projection name:
``params[name]`` indexable per expert (an ``(E, K, N)`` stack or a list
of ``(K, N)`` tensors), or the packed INT4 pair ``name#q``/``name#s``
(stacks or lists of ``(K, N//2)`` uint8 and ``(K//g, N)`` scales), whose
products go through ``int4_matmul`` on the card.  Each expert runs its
own three products on its ``C`` rows, so an expert's output does not
depend on the other experts in the bank: the union combine equals the
full-bank path bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.ops import int4_matmul_op
from repro_torch.models.common import (all_to_all, axis_index, axis_size,
                                       psum, silu)


def router_topk(logits: torch.Tensor, k: int):
    """logits (T, E) -> (weights (T, k) softmaxed over the chosen, ids
    (T, k)).  A stable descending sort puts the lower index first among
    equal logits, as ``lax.top_k`` does (``torch.topk`` leaves ties
    unordered on the card)."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    w = torch.softmax(vals[:, :k].to(torch.float32), dim=-1)
    return w, ids[:, :k]


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """GShard-style auxiliary loss: E * sum_e f_e * p_e (f_e: the top-1
    share of expert e, p_e: its mean router probability)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    onehot = torch.nn.functional.one_hot(ids[..., 0], num_experts)
    f = onehot.to(torch.float32).mean(dim=0)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def _dispatch_indices(ids: torch.Tensor, num_experts: int, capacity: int):
    """ids (T, k) -> (expert, slot, valid), each (T, k): the capacity
    slot each (token, choice) lands in, in token order within an expert
    (a stable sort), overflow (slot >= capacity) invalid."""
    T, k = ids.shape
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(num_experts, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    ranks_sorted = (torch.arange(T * k, device=flat.device)
                    - starts[flat[order]])
    ranks = torch.empty_like(flat)
    ranks[order] = ranks_sorted
    valid = ranks < capacity
    return flat.reshape(T, k), ranks.reshape(T, k), valid.reshape(T, k)


def expert_weights(params, name: str):
    """Projection ``name`` of every expert, indexable per expert: the
    f32 stack (or list), or ``(packed, scale)`` pairs."""
    if name in params:
        return params[name]
    return list(zip(params[name + "#q"], params[name + "#s"]))


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, tuple):
        packed, scale = w
        return int4_matmul_op(x, packed, scale,
                              group=packed.shape[0] // scale.shape[0])
    return x @ w


def _expert_ffn(w_gate, w_up, w_down, xb: torch.Tensor) -> torch.Tensor:
    """Experts on their dispatch rows: ``xb`` (E, C, d), weights per
    expert ``(d, f)``/``(f, d)`` (``expert_weights``) -> (E, C, d)."""
    return torch.stack([
        _proj(silu(_proj(xb[e], w_gate[e])) * _proj(xb[e], w_up[e]),
              w_down[e])
        for e in range(xb.shape[0])])


def _dispatch(x: torch.Tensor, ids: torch.Tensor, E: int, capacity: int):
    """The (E, C, d) dispatch buffer of tokens ``x`` (T, d) routed to
    ``ids`` (T, k), and (expert, slot, keep) per (token, choice), flat.
    Overflow pairs go to slot C-1 as zero rows that are *added*
    (``index_put_`` accumulates), as the reference's ``.at[].add``
    does, so a dropped pair never overwrites a kept one."""
    T, d = x.shape
    k = ids.shape[1]
    e_id, slot, valid = _dispatch_indices(ids, E, capacity)
    e_flat = e_id.reshape(-1)
    slot_c = torch.clamp_max(slot, capacity - 1).reshape(-1)
    keep = valid.reshape(-1, 1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((E, capacity, d))
    buf.index_put_((e_flat, slot_c), torch.where(keep, x[flat_t], 0.0),
                   accumulate=True)
    return buf, e_flat, slot_c, keep


def _combine(out_buf, e_flat, slot_c, keep, w, x):
    """Gather each kept pair's expert row back and sum the choices with
    the router weights ``w`` (T, k) -> (T, d) at ``x``'s dtype."""
    T, k = w.shape
    gathered = torch.where(keep, out_buf[e_flat, slot_c], 0.0)
    gathered = gathered.reshape(T, k, -1) * w[..., None].to(x.dtype)
    return torch.sum(gathered, dim=1)


def moe_ffn_union(x: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                  params, capacity: int) -> torch.Tensor:
    """Scatter the tokens into the (E, C, d) dispatch buffer, run the
    experts, gather and combine with the router weights ``w`` (T, k).
    The offloaded engines' compact combine: ``params`` holds ONLY the
    ``U`` routed experts of this pass and ``ids`` (T, k) are remapped
    into ``[0, U)``.  Equal to ``moe_ffn`` on the full bank when the
    caller passes the same router outputs, the full bank's ``capacity``,
    and an order-preserving remap (sorted union -> rank): the stable
    dispatch sort then assigns the same slots and drops the same pairs."""
    w_gate, w_up, w_down = (expert_weights(params, n)
                            for n in ("w_gate", "w_up", "w_down"))
    buf, e_flat, slot_c, keep = _dispatch(x, ids, len(w_gate), capacity)
    out_buf = _expert_ffn(w_gate, w_up, w_down, buf)
    return _combine(out_buf, e_flat, slot_c, keep, w, x)


def _route(x, params, cfg: MoEConfig):
    logits = (x @ params["wg"]).to(torch.float32)
    w, ids = router_topk(logits, cfg.top_k)
    return w, ids, load_balance_loss(logits, ids, cfg.num_experts)


def moe_ffn(x: torch.Tensor, params, cfg: MoEConfig,
            capacity: Optional[int] = None, *, axis=None):
    """x (T, d), params: ``wg`` (d, E) and the expert projections
    (``expert_weights``).  Returns (out (T, d), aux loss).  ``capacity``
    defaults to ``int(capacity_factor * T * k / E) + 1``.

    ``axis`` (expert parallelism): ``params`` holds this shard's ``E /
    P`` experts; the buffer's block ``j`` goes to shard ``j``
    (``all_to_all``), which runs its experts on every shard's rows, and
    the rows come back the same way."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    P = axis_size(axis)
    w, ids, aux = _route(x, params, cfg)
    if capacity is None:
        capacity = int(cfg.capacity_factor * T * k / E) + 1
    if not axis:
        return moe_ffn_union(x, w, ids, params, capacity), aux
    w_gate, w_up, w_down = (expert_weights(params, n)
                            for n in ("w_gate", "w_up", "w_down"))
    E_loc = len(w_gate)
    if E_loc * P != E:
        raise ValueError(f"moe_ffn: {E_loc} local experts x {P} shards "
                         f"!= {E}")
    buf, e_flat, slot_c, keep = _dispatch(x, ids, E, capacity)
    buf = all_to_all(buf.reshape(P, E_loc, capacity, d), axis)
    buf = buf.transpose(0, 1).reshape(E_loc, P * capacity, d)
    out_buf = _expert_ffn(w_gate, w_up, w_down, buf)
    out_buf = out_buf.reshape(E_loc, P, capacity, d).transpose(0, 1)
    out_buf = all_to_all(out_buf, axis).reshape(E, capacity, d)
    return _combine(out_buf, e_flat, slot_c, keep, w, x), aux


def _local_experts(x, params, cfg: MoEConfig, ep_axis, reduce_axes):
    """Tokens ``x`` replicated over ``ep_axis`` through this shard's
    experts (capacity T: no drops); the pairs routed elsewhere add
    zeros, and one psum over ``reduce_axes`` merges the shards."""
    T, d = x.shape
    E = cfg.num_experts
    w, ids, aux = _route(x, params, cfg)
    w_gate, w_up, w_down = (expert_weights(params, n)
                            for n in ("w_gate", "w_up", "w_down"))
    E_loc = len(w_gate)
    buf, e_flat, slot_c, keep = _dispatch(x, ids, E, T)
    start = axis_index(ep_axis) * E_loc
    out_loc = _expert_ffn(w_gate, w_up, w_down, buf[start:start + E_loc])
    rel = e_flat - start
    mine = keep & ((rel >= 0) & (rel < E_loc))[:, None]
    out = _combine(out_loc, torch.clamp(rel, 0, E_loc - 1), slot_c, mine,
                   w, x)
    return psum(out, reduce_axes), aux


def moe_ffn_replicated(x: torch.Tensor, params, cfg: MoEConfig, *, axis):
    """Decode-mode EP: tokens x (T, d) replicated over ``axis``, experts
    sharded over it; each shard computes its local experts for all T
    tokens and one psum merges.  Returns (out (T, d), aux loss)."""
    return _local_experts(x, params, cfg, axis, axis)


def moe_ffn_decode(x: torch.Tensor, params, cfg: MoEConfig, *, ep_axis,
                   ff_axis, combine_axes):
    """Decode-mode EP with each expert's ff dim sliced over ``ff_axis``
    as well: the local down products are partial sums over ff, and one
    psum over ``combine_axes`` finishes both them and the cross-expert
    combine.  Returns (out (T, d), aux loss)."""
    del ff_axis
    return _local_experts(x, params, cfg, ep_axis, combine_axes)


def moe_ffn_dense_oracle(x: torch.Tensor, params, cfg: MoEConfig):
    """Every token through its top-k experts with no capacity, by a
    dense loop over the experts (tests, small T and E)."""
    T, d = x.shape
    logits = (x @ params["wg"]).to(torch.float32)
    w, ids = router_topk(logits, cfg.top_k)
    out = torch.zeros_like(x)
    ws = [expert_weights(params, n) for n in ("w_gate", "w_up", "w_down")]
    for e in range(cfg.num_experts):
        ye = _expert_ffn(*([wn[e]] for wn in ws), x[None])[0]
        for j in range(cfg.top_k):
            sel = (ids[:, j] == e)[:, None]
            out = out + torch.where(sel, ye * w[:, j:j + 1].to(x.dtype), 0.0)
    return out
