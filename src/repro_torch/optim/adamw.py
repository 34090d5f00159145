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

Placed leaves (DTensors, ``launch.sharding.place``) run the same math
on their local blocks, with the collectives of ``models.common``: each
gradient is relaid from its parameter's spec to its moments' (the ZeRO
specs, ``zero_pspecs``: a local slice, no communication), the update
back to its parameter's (an all-gather over ``data``), and
``global_norm`` sums each block's squares over the axes that shard it,
so every rank holds the whole tree's norm.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.models.common import (AbstractDTensor, Dist, active,
                                       in_mesh, psum, relayout)
from repro_torch.tree import leaves, tree_map

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares: a placed leaf's over its local block, psummed over the axes
    that shard it (one psum for each set of axes)."""
    with _mesh(tree):
        parts = {}
        for leaf in leaves(tree):
            loc, spec = _shard(leaf)
            axes = _sharded_axes(spec)
            sq = torch.sum(torch.square(loc.to(F32)))
            parts[axes] = parts[axes] + sq if axes in parts else sq
        return torch.sqrt(sum(psum(v, axes) for axes, v in parts.items()))


def _shard(t):
    """(``t``'s local block, its spec): a DTensor's block and the spec of
    its placements; a plain tensor itself and ``()``."""
    pl = getattr(t, "placements", None)
    if pl is None:
        return t, ()
    return t.to_local(), Dist(mesh=t.device_mesh).spec_of(pl, t.ndim)


def _placed(local, like):
    """The block ``local`` as a DTensor at ``like``'s placements (no
    communication); ``local`` itself when ``like`` is a plain tensor."""
    pl = getattr(like, "placements", None)
    if pl is None:
        return local
    if isinstance(like, AbstractDTensor):
        return AbstractDTensor(local, like.device_mesh, pl, like.shape)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, pl, run_check=False,
                              shape=like.shape, stride=like.stride())


def _mesh(tree):
    """``in_mesh`` over the mesh of ``tree``'s placed leaves (a no-op
    context for a tree of plain tensors)."""
    for leaf in leaves(tree):
        mesh = getattr(leaf, "device_mesh", None)
        if mesh is not None:
            return in_mesh(Dist(mesh=mesh))
    return contextlib.nullcontext()


def _sharded_axes(spec) -> tuple:
    """The mesh axes ``spec`` shards any dim over, in the mesh's order."""
    used = {a for s in spec for a in (s if isinstance(s, tuple) else (s,))
            if a}
    return tuple(a for a in active().axis_names if a in used) if used else ()


def _step_device(params):
    return _shard(leaves(params)[0])[0].device


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
        """Zero moments like each parameter (DTensors at its placements),
        the step a plain int32 scalar."""
        z = lambda p: torch.zeros_like(p, dtype=F32,
                                       memory_format=torch.contiguous_format)
        step = torch.zeros((), dtype=torch.int32, device=_step_device(params))
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": step}

    @torch.no_grad()
    def update(self, grads, state, params):
        """-> (updates at each parameter's dtype and placements, the new
        state, the global norm of ``grads`` before clipping); the new
        moments are written into ``state``'s."""
        step = _shard(state["step"])[0] + 1
        gn = global_norm(grads)
        scale = clip_scale(gn, self.clip_norm)
        lr = self.lr(step) if callable(self.lr) else self.lr
        step_f = step.to(F32)
        c1 = 1 - torch.pow(torch.tensor(self.b1, dtype=F32,
                                        device=step.device), step_f)
        c2 = 1 - torch.pow(torch.tensor(self.b2, dtype=F32,
                                        device=step.device), step_f)

        def upd(g, m, v, p):
            (g, gs), (m_l, ms), (p_l, ps) = _shard(g), _shard(m), _shard(p)
            v_l = _shard(v)[0]
            g = relayout(g.to(F32) * scale, gs, ms)
            m_new = self.b1 * m_l + (1 - self.b1) * g
            v_new = self.b2 * v_l + (1 - self.b2) * torch.square(g)
            u = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            u = u + self.weight_decay * relayout(p_l.to(F32), ps, ms)
            m_l.copy_(m_new)
            v_l.copy_(v_new)
            return _placed(relayout(-lr * u, ms, ps).to(p.dtype), p), m, v

        with _mesh(params):
            out = tree_map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: tree_map(lambda g, o: o[i], grads, out)
        return pick(0), {"m": pick(1), "v": pick(2), "step": step}, gn


@torch.no_grad()
def apply_updates(params, updates):
    """``p + u`` at each parameter's dtype, added into ``p`` (a placed
    leaf's local block)."""
    def add(p, u):
        _shard(p)[0].add_(_shard(u)[0].to(p.dtype))
        return p
    return tree_map(add, params, updates)
