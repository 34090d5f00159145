"""Dispatch for the port's kernels (the JAX package's ``kernels/ops.py``).

Each op goes to its kernel wrapper, which launches the CUDA kernel for a
CUDA tensor and runs the plain PyTorch version for a CPU tensor.
``use_kernels(False)`` is the explicit caller choice of the plain
versions on any device (the card's reference path).  ``LAUNCHES`` counts
each wrapper's kernel launches; ``reset_launches`` zeroes them.
"""
from __future__ import annotations

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.int4_matmul import int4_matmul

__all__ = ["use_kernels", "int4_matmul_op",
           "flash_attention_op", "decode_attention_op", "LAUNCHES",
           "reset_launches"]

_STATE = {"enabled": True}


def use_kernels(flag: bool):
    _STATE["enabled"] = bool(flag)


def int4_matmul_op(x, packed, scale, *, group: int = 128):
    if not _STATE["enabled"]:
        return R.int4_matmul_ref(x, packed, scale, group)
    return int4_matmul(x, packed, scale, group=group)


def flash_attention_op(q, k, v, *, causal=True, window=0, q_offset=0):
    if not _STATE["enabled"]:
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def decode_attention_op(q, k_cache, v_cache, pos):
    if not _STATE["enabled"]:
        return R.decode_attention_ref(q, k_cache, v_cache, pos)
    return decode_attention(q, k_cache, v_cache, pos)
