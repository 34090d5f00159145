"""Step functions: train / prefill / decode (the JAX package's
``launch/steps.py``, on one device)."""
from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.optim import apply_updates
from repro_torch.tree import leaves, unflatten


def _to(device, batch):
    """A numpy (or tensor) batch on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(model: Model, params, batch, remat: bool = True):
    """(loss, gradient tree) of ``model.train_loss`` at ``params`` by
    ``torch.autograd``, the batch moved to the parameters' device; a
    parameter the loss does not reach gets a zero gradient, as under
    ``jax.grad``.  ``params`` is left as it was (no ``requires_grad``)."""
    flat = leaves(params)
    batch = _to(flat[0].device, batch)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = model.train_loss(unflatten(params, live), batch, remat=remat)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)])


def make_train_step(model: Model, opt):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: ``value_and_grad``, then ``opt.update`` and
    ``apply_updates``.  The batch's numpy arrays move to the parameters'
    device.  The step updates the parameters and the optimizer state in
    place, as the reference's launchers donate them to the jitted step
    (``donate_argnums=(0, 1)``): the caller's trees hold the new state."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        updates, opt_state, gnorm = opt.update(grads, opt_state, params)
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(model: Model, cache_len: int):
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, cache_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, batch, caches):
        with torch.no_grad():
            return model.decode_step(params, batch, caches)
    return decode_step
