"""AdamW with global-norm clipping and schedules (the JAX package's
``optim/adamw.py``).

Moments are f32 whatever the parameter dtype (bf16 parameters with f32
``m``/``v``), ``step`` an int32 scalar, and the state keeps the
reference's keys (``{"m", "v", "step"}``), so a checkpoint of it has the
reference's leaf paths.  Trees are the port's nested dicts and tuples;
every sum over leaves runs in the reference's leaf order
(``repro_torch.tree``).  The math is the reference's, leaf by leaf, in
f32.

``update`` writes the new moments into the state's tensors and
``apply_updates`` adds into the parameters: the counterpart of the
reference's launchers (``launch/train.py``, ``launch/dryrun.py``), which
jit the step with ``donate_argnums=(0, 1)`` so that it reuses its
inputs' buffers.  A step thus holds one
copy of the state, not two, and the caller's trees hold the new one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.tree import leaves, tree_map

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(F32)))
                          for l in leaves(tree)))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    """lr(step): linear warmup to ``base_lr`` over ``warmup`` steps, then
    a cosine down to ``final_frac * base_lr`` at ``total``; f32."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * torch.clamp_max(step / max(1, warmup), 1.0)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def clip_scale(gn: torch.Tensor, clip_norm: float):
    """The factor that brings the global norm ``gn`` down to
    ``clip_norm`` (1.0 below it, or without clipping)."""
    if not clip_norm:
        return 1.0
    return torch.clamp_max(clip_norm / (gn + 1e-9), 1.0)


@dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params):
        z = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
        step = torch.zeros((), dtype=torch.int32,
                           device=leaves(params)[0].device)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": step}

    @torch.no_grad()
    def update(self, grads, state, params):
        """-> (updates at each parameter's dtype, the new state, the
        global norm of ``grads`` before clipping); the new moments are
        written into ``state``'s."""
        step = state["step"] + 1
        gn = global_norm(grads)
        scale = clip_scale(gn, self.clip_norm)
        lr = self.lr(step) if callable(self.lr) else self.lr
        step_f = step.to(F32)
        c1 = 1 - torch.pow(torch.tensor(self.b1, dtype=F32,
                                        device=step.device), step_f)
        c2 = 1 - torch.pow(torch.tensor(self.b2, dtype=F32,
                                        device=step.device), step_f)

        def upd(g, m, v, p):
            g = g.to(F32) * scale
            m_new = self.b1 * m + (1 - self.b1) * g
            v_new = self.b2 * v + (1 - self.b2) * torch.square(g)
            u = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            u = u + self.weight_decay * p.to(F32)
            return (-lr * u).to(p.dtype), m.copy_(m_new), v.copy_(v_new)

        out = tree_map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: tree_map(lambda g, o: o[i], grads, out)
        return pick(0), {"m": pick(1), "v": pick(2), "step": step}, gn


@torch.no_grad()
def apply_updates(params, updates):
    """``p + u`` at each parameter's dtype, added into ``p``."""
    return tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
