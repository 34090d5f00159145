"""Step functions: train / prefill / decode (the JAX package's
``launch/steps.py``), on one device or under a mesh ``Dist``.

Under a mesh the parameters and the optimizer state are DTensors
(``launch.sharding.place``): every rank computes the loss whole and
differentiates ``loss / world`` (the collectives' backward passes are
the JAX transpose rules, the adjoints of the program summed over ranks),
so each gradient comes back as a DTensor of its parameter's placements,
counted once.  On an abstract mesh (the dry run's) the leaves are
``AbstractDTensor``s, whose blocks are differentiated directly.

A tree with an integer leaf (a resident INT4 table's ``#q``) cannot be
differentiated: ``value_and_grad`` refuses it before any work, with the
reference's ``jax.grad`` reason (ROADMAP Queue 3 item 22).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import AbstractDTensor, Dist
from repro_torch.models.model import Model
from repro_torch.optim import apply_updates
from repro_torch.tree import flatten_with_path, leaves, unflatten


def _to(device, batch):
    """A numpy (or tensor) batch on ``device`` (placed leaves as they
    are)."""
    return {k: v if isinstance(v, AbstractDTensor) or (
        isinstance(v, torch.Tensor) and v.device == device)
        else torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device(t) -> torch.device:
    local = getattr(t, "to_local", None)
    return local().device if local is not None else t.device


def value_and_grad(model: Model, params, batch, remat: bool = True,
                   dist: Dist = None):
    """(loss, gradient tree) of ``model.train_loss`` at ``params`` by
    ``torch.autograd``, the batch moved to the parameters' device; a
    parameter the loss does not reach gets a zero gradient, as under
    ``jax.grad``.  ``params`` is left as it was (no ``requires_grad``).
    Under a mesh ``dist`` the loss is the whole one and the gradients are
    DTensors like the parameters."""
    dist = dist or Dist.local()
    for path, t in flatten_with_path(params):
        if not (t.dtype.is_floating_point or t.dtype.is_complex):
            raise TypeError(
                f"grad requires real- or complex-valued inputs (input dtype "
                f"that is a sub-dtype of np.inexact), but got "
                f"{str(t.dtype)[6:]} (parameter {path})")
    flat = leaves(params)
    batch = _to(_device(flat[0]), batch)
    live = [p.detach().requires_grad_(True) for p in flat]
    blocks = [_block(p) for p in live]
    with torch.enable_grad():
        loss = model.train_loss(unflatten(params, live), batch, dist,
                                remat=remat)
        share = loss / dist.world if dist.is_dist else loss
        grads = torch.autograd.grad(share, blocks, allow_unused=True)
    return loss.detach(), unflatten(params, [
        _like(torch.zeros_like(b) if g is None else g, p)
        for p, b, g in zip(flat, blocks, grads)])


def _block(t):
    """What autograd differentiates: an ``AbstractDTensor``'s block, any
    other leaf (a tensor or a DTensor) itself."""
    return t.to_local() if isinstance(t, AbstractDTensor) else t


def _like(g, p):
    """A gradient block laid out as the parameter ``p``."""
    if isinstance(p, AbstractDTensor):
        return AbstractDTensor(g, p.device_mesh, p.placements, p.shape)
    return g


def make_train_step(model: Model, dist: Dist = None, opt=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``value_and_grad``, then ``opt.update`` and
    ``apply_updates``.  The batch's numpy arrays move to the parameters'
    device.  The step updates the parameters and the optimizer state in
    place, as the reference's launchers donate them to the jitted step
    (``donate_argnums=(0, 1)``): the caller's trees hold the new state.
    ``make_train_step(model, opt)`` is the one-device step."""
    if opt is None and not isinstance(dist, Dist):
        dist, opt = None, dist

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch, dist=dist)
        updates, opt_state, gnorm = opt.update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(model: Model, dist: Dist = None, cache_len=None):
    if cache_len is None and not isinstance(dist, Dist):
        dist, cache_len = None, dist

    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, dist, cache_len)
    return prefill_step


def make_decode_step(model: Model, dist: Dist = None):
    def decode_step(params, batch, caches):
        with torch.no_grad():
            return model.decode_step(params, batch, caches, dist)
    return decode_step
