"""Adafactor-style optimizer: factored second moment and bf16 momentum
(the JAX package's ``optim/adafactor.py``; Shazeer & Stern,
arXiv:1804.04235).

A leaf of two or more dims keeps row and column statistics ``vr``
(shape[:-1]) and ``vc`` (shape[:-2] + shape[-1:]) in place of a full
second moment, a vector leaf a full f32 ``v``; the momentum ``m`` is
bf16.  The state keeps the reference's keys (``{"s": {leaf: {"m", "vr",
"vc" | "v"}}, "step"}``).  ``update`` writes the new statistics into
the state's tensors, as in ``optim.adamw``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.optim.adamw import F32, clip_scale, global_norm
from repro_torch.tree import leaves, tree_map


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
            z = lambda shape, dt: torch.zeros(shape, dtype=dt,
                                              device=p.device)
            st = {}
            if self.b1:
                st["m"] = z(p.shape, torch.bfloat16)
            if self._factored(p.shape):
                st["vr"] = z(p.shape[:-1], F32)
                st["vc"] = z(p.shape[:-2] + p.shape[-1:], F32)
            else:
                st["v"] = z(p.shape, F32)
            return st
        step = torch.zeros((), dtype=torch.int32,
                           device=leaves(params)[0].device)
        return {"s": tree_map(leaf, params), "step": step}

    @torch.no_grad()
    def update(self, grads, state, params):
        """-> (updates at each parameter's dtype, the new state, the
        global norm of ``grads`` before clipping); the new statistics
        are written into ``state``'s."""
        step = state["step"] + 1
        gn = global_norm(grads)
        scale = clip_scale(gn, self.clip_norm)
        lr = self.lr(step) if callable(self.lr) else self.lr
        d = self.decay

        def leaf(g, st, p):
            g = g.to(F32) * scale
            new = {}
            if self._factored(g.shape):
                vr = d * st["vr"] + (1 - d) * torch.mean(torch.square(g), -1)
                vc = d * st["vc"] + (1 - d) * torch.mean(torch.square(g), -2)
                new["vr"], new["vc"] = vr, vc
                row = torch.clamp_min(torch.mean(vr, -1, keepdim=True),
                                      self.eps)[..., None]
                denom = torch.sqrt(vr[..., None] * vc[..., None, :] / row
                                   + self.eps)
            else:
                v = d * st["v"] + (1 - d) * torch.square(g)
                new["v"] = v
                denom = torch.sqrt(v + self.eps)
            u = g / denom
            if self.b1:
                m = self.b1 * st["m"].to(F32) + (1 - self.b1) * u
                new["m"] = m.to(torch.bfloat16)
                u = m
            u = u + self.weight_decay * p.to(F32)
            return (-lr * u).to(p.dtype), {k: st[k].copy_(t)
                                           for k, t in new.items()}

        out = tree_map(leaf, grads, state["s"], params)
        updates = tree_map(lambda g, o: o[0], grads, out)
        new_s = tree_map(lambda g, o: o[1], grads, out)
        return updates, {"s": new_s, "step": step}, gn
