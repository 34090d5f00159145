"""Dispatch for the port's kernels (the JAX package's ``kernels/ops.py``).

Each op goes to its kernel wrapper, which launches the CUDA kernel for a
CUDA tensor and runs the plain PyTorch version for a CPU tensor.
``use_kernels(False)`` is the explicit caller choice of the plain
versions on any device (the card's reference path).  ``LAUNCHES`` counts
each wrapper's kernel launches; ``reset_launches`` zeroes them.

The kernels have no backward pass, and neither do the reference's
Pallas kernels: training attends through plain PyTorch
(``models.attention.ring_attention``).  So an op handed a tensor that
requires grad while grad mode is on raises (``NoGradError``) rather than
return a result autograd cannot see through; it neither detaches the
input nor switches to its plain version.  Serving never needs gradients
and is unaffected.

Every op takes bf16 inputs as they are, as the TPU kernels do: a bf16
``x``, q (and k, v) or q over any cache goes straight to the kernel
wrapper, which launches the kernel's bf16 instance on the card and runs
the plain version at the input dtype on the CPU (so there the kernel
arm equals ``use_kernels(False)`` bit for bit).  No op widens an input
or casts an output itself, a shape the bf16 instance cannot take raises,
and no failed build or launch gives way to a plain version.  The output
has the input's dtype on either arm (``x``'s for ``int4_matmul_op``, as
the reference's ``x @ dequant(W)``; q's for the attentions).
On meta tensors each wrapper prices its kernel (``kernels.cost``, at
its operands' sizes) and returns an empty output of the kernel's shape
and dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention_int4 import decode_attention_int4
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int4_matmul import int4_matmul

__all__ = ["use_kernels", "kernels_enabled", "int4_matmul_op",
           "flash_attention_op", "decode_attention_op",
           "decode_attention_int4_op", "LAUNCHES",
           "reset_launches", "NoGradError"]

_STATE = {"enabled": True}


class NoGradError(RuntimeError):
    """A kernel op was asked to differentiate."""


def _no_grad(op: str, *tensors):
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise NoGradError(
            f"{op}: the kernel has no backward pass and an input requires "
            f"grad; train through the plain PyTorch path "
            f"(Ctx(mode='train'), models.attention.ring_attention), or "
            f"call under torch.no_grad()")


def use_kernels(flag: bool):
    _STATE["enabled"] = bool(flag)


def kernels_enabled() -> bool:
    """Whether the ops launch their kernels (``use_kernels``)."""
    return _STATE["enabled"]


def int4_matmul_op(x, packed, scale, *, group: int = 128):
    _no_grad("int4_matmul", x, packed, scale)
    if not _STATE["enabled"]:
        return R.int4_matmul_ref(x, packed, scale, group).to(x.dtype)
    return int4_matmul(x, packed, scale, group=group)


def flash_attention_op(q, k, v, *, causal=True, window=0, q_offset=0):
    _no_grad("flash_attention", q, k, v)
    if not _STATE["enabled"]:
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def decode_attention_op(q, k_cache, v_cache, pos):
    _no_grad("decode_attention", q, k_cache, v_cache)
    if not _STATE["enabled"]:
        return R.decode_attention_ref(q, k_cache, v_cache, pos)
    return decode_attention(q, k_cache, v_cache, pos)


def decode_attention_int4_op(q, k_packed, k_scale, v_packed, v_scale, pos, *,
                             hkv: int, group: int, k_new=None, v_new=None,
                             cache_dtype=torch.float32):
    _no_grad("decode_attention_int4", q, k_packed, k_scale, v_packed,
             v_scale, k_new, v_new)
    kw = dict(hkv=hkv, group=group, k_new=k_new, v_new=v_new,
              cache_dtype=cache_dtype)
    if not _STATE["enabled"]:
        return R.decode_attention_int4_ref(q, k_packed, k_scale, v_packed,
                                           v_scale, pos, **kw)
    return decode_attention_int4(q, k_packed, k_scale, v_packed, v_scale,
                                 pos, **kw)
