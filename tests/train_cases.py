"""Shared set-up of the training tests (``tests/test_torch_train*.py``):
a seeded batch for a config, the JAX package's loss and gradients at its
own ``init`` (jitted once per case), and the port's on the same weights
carried over through ``core.convert.from_reference_train_state``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scaled_down as jax_scaled_down
from repro.models import Dist
from repro.models import build_model as jax_build_model
from repro_torch import tree as PT
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.convert import from_reference_train_state
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.model import build_model


def configs(arch, **overrides):
    """(JAX config, port config): ``scaled_down`` with ``overrides``; a
    ``capacity_factor`` override replaces the MoE config's."""
    cf = overrides.pop("capacity_factor", None)
    jc = jax_scaled_down(jax_get_config(arch), **overrides)
    pc = scaled_down(get_config(arch), **overrides)
    if cf is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=cf))
        pc = dataclasses.replace(pc, moe=dataclasses.replace(
            pc.moe, capacity_factor=cf))
    return jc, pc


def batch(cfg, b=2, s=32, seed=0):
    """numpy labels with tokens, or the frontend's ``embeds``, and an
    encoder-decoder's ``enc_embeds``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"labels": toks[:, 1:]}
    if cfg.frontend == "embeds" and not cfg.enc_dec:
        out["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = toks[:, :-1]
    if cfg.enc_dec:
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def jax_params(jc, dtype=jnp.float32, seed=0):
    return jax_build_model(jc).init(jax.random.PRNGKey(seed), dtype)


def jax_loss_grads(jc, params, b, dtype=jnp.float32):
    """The JAX package's (loss, gradient leaves as numpy f32, in
    ``jax.tree_util`` order)."""
    model = jax_build_model(jc)
    jb = {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
          for k, v in b.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: model.train_loss(p, jb, Dist.local())))(params)
    return float(loss), [np.asarray(x, np.float32)
                         for x in jax.tree.leaves(g)]


def port_params(params, dtype=None):
    """The JAX parameter tree as the port's tensors on the CPU."""
    return from_reference_train_state(jax.tree.map(np.asarray, params),
                                      None, "cpu", dtype)[0]


def port_loss_grads(pc, params, b, remat=True, dtype=torch.float32):
    """The port's (loss, [(path, gradient as numpy f32)])."""
    tb = {k: (torch.from_numpy(v).to(dtype) if v.dtype == np.float32
              else torch.from_numpy(v)) for k, v in b.items()}
    loss, g = value_and_grad(build_model(pc), params, tb, remat)
    return float(loss), [(p, t.float().numpy())
                         for p, t in PT.flatten_with_path(g)]


def assert_grads_close(jg, pg, tol=1e-4):
    """Every leaf within ``tol`` x that leaf's max |g| of the JAX one."""
    assert len(jg) == len(pg)
    for want, (path, got) in zip(jg, pg):
        assert want.shape == got.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(want - got).max())
        assert err <= tol * scale, (path, err, scale)
