"""Adafactor-style optimizer: factored second moment and bf16 momentum
(the JAX package's ``optim/adafactor.py``; Shazeer & Stern,
arXiv:1804.04235).

A leaf of two or more dims keeps row and column statistics ``vr``
(shape[:-1]) and ``vc`` (shape[:-2] + shape[-1:]) in place of a full
second moment, a vector leaf a full f32 ``v``; the momentum ``m`` is
bf16.  The state keeps the reference's keys (``{"s": {leaf: {"m", "vr",
"vc" | "v"}}, "step"}``).  ``update`` writes the new statistics into
the state's tensors, as in ``optim.adamw``.  Placed leaves (DTensors)
keep ``m`` at the parameter's placements and ``vr``/``vc`` at the
reductions' (``adafactor_pspecs``: the parameter's spec without the
reduced dim); the math runs on the local blocks, and a mean over a
sharded dim is a ``pmean`` of the blocks' means over its axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.models.common import pmean, relayout
from repro_torch.optim.adamw import (F32, _mesh, _placed, _shard,
                                     _sharded_axes, _step_device, clip_scale,
                                     global_norm)
from repro_torch.tree import tree_map


def _zeros_without(p, dim: int):
    """f32 zeros of ``p``'s shape without ``dim``; for a DTensor at
    ``p``'s placements without that dim (replicated where ``p`` is
    sharded on it)."""
    shape = p.shape[:dim] + p.shape[dim + 1:]
    pl = getattr(p, "placements", None)
    if pl is None:
        return torch.zeros(shape, dtype=F32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dzeros
    out = [Replicate() if not q.is_shard() or q.dim == dim
           else Shard(q.dim - (q.dim > dim)) for q in pl]
    return dzeros(shape, dtype=F32, device_mesh=p.device_mesh,
                  placements=out)


@dataclass(frozen=True)
class Adafactor:
    lr: Union[float, Callable] = 1e-3
    b1: float = 0.9              # bf16 momentum (0 disables)
    decay: float = 0.99          # second-moment decay
    eps: float = 1e-30
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    @staticmethod
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(self, params):
        def leaf(p):
            st = {}
            if self.b1:
                st["m"] = torch.zeros_like(
                    p, dtype=torch.bfloat16,
                    memory_format=torch.contiguous_format)
            if self._factored(p.shape):
                st["vr"] = _zeros_without(p, p.ndim - 1)
                st["vc"] = _zeros_without(p, p.ndim - 2)
            else:
                st["v"] = torch.zeros_like(
                    p, dtype=F32, memory_format=torch.contiguous_format)
            return st
        step = torch.zeros((), dtype=torch.int32, device=_step_device(params))
        return {"s": tree_map(leaf, params), "step": step}

    @torch.no_grad()
    def update(self, grads, state, params):
        """-> (updates at each parameter's dtype, the new state, the
        global norm of ``grads`` before clipping); the new statistics
        are written into ``state``'s."""
        step = _shard(state["step"])[0] + 1
        gn = global_norm(grads)
        scale = clip_scale(gn, self.clip_norm)
        lr = self.lr(step) if callable(self.lr) else self.lr
        d = self.decay

        def leaf(g, st, p):
            (g, gs), (p_l, ps) = _shard(g), _shard(p)
            g = relayout(g.to(F32) * scale, gs, ps)
            loc = {k: _shard(t)[0] for k, t in st.items()}
            new = {}
            if self._factored(g.shape):
                spec = tuple(ps) + (None,) * (g.ndim - len(ps))
                rows, cols = (_sharded_axes((spec[-2],)),
                              _sharded_axes((spec[-1],)))
                vr = d * loc["vr"] + (1 - d) * pmean(
                    torch.mean(torch.square(g), -1), cols)
                vc = d * loc["vc"] + (1 - d) * pmean(
                    torch.mean(torch.square(g), -2), rows)
                new["vr"], new["vc"] = vr, vc
                row = torch.clamp_min(pmean(torch.mean(vr, -1, keepdim=True),
                                            rows), self.eps)[..., None]
                denom = torch.sqrt(vr[..., None] * vc[..., None, :] / row
                                   + self.eps)
            else:
                v = d * loc["v"] + (1 - d) * torch.square(g)
                new["v"] = v
                denom = torch.sqrt(v + self.eps)
            u = g / denom
            if self.b1:
                m = self.b1 * loc["m"].to(F32) + (1 - self.b1) * u
                new["m"] = m.to(torch.bfloat16)
                u = m
            u = u + self.weight_decay * p_l.to(F32)
            for k, t in new.items():
                loc[k].copy_(t)
            return (_placed((-lr * u).to(p.dtype), p),
                    {k: st[k] for k in new})

        with _mesh(params):
            out = tree_map(leaf, grads, state["s"], params)
        updates = tree_map(lambda g, o: o[0], grads, out)
        new_s = tree_map(lambda g, o: o[1], grads, out)
        return updates, {"s": new_s, "step": step}, gn
