"""Model assembly for the serving engine: parameter tables, an own
parameter init, cache shapes and rope angles (the dense subset of the
JAX package's ``models/transformer.py``).

``init_params`` draws every table's shapes at the reference's scales (a
matrix at 1/sqrt(fan-in), a zero-scale vector as zeros, the embedding at
1/sqrt(d_model)) from one explicit ``numpy.random.default_rng(seed)``, in
sorted table order.  The reference draws with ``jax.random``, whose
numbers the port cannot reproduce; the tests carry the reference's
weights across instead (``core.convert.from_reference_serving``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.rope import rope_angles


def model_tables(cfg: ModelConfig):
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder stacks come with a later "
                                  "slice of the port")
    return {
        "embed": L.embed_table(cfg),
        "final_norm": {"scale": L.ParamDef((cfg.d_model,), (None,), 0.0)},
        "pat": tuple(L.layer_table(cfg, s) for s in cfg.pattern),
        "rem": tuple(L.layer_table(cfg, s) for s in cfg.remainder),
    }


def _init_entry(rng: np.random.Generator, pd: L.ParamDef, stack: int):
    shape = ((stack,) + pd.shape) if stack else pd.shape
    if pd.scale == 0.0:
        return np.zeros(shape, np.float32)
    scale = pd.scale if pd.scale > 0 else 1.0 / math.sqrt(max(1, pd.shape[0]))
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _init_table(table, rng, stack: int):
    return {name: _init_entry(rng, pd, stack)
            for name, pd in sorted(table.items())}


def init_params(cfg: ModelConfig, seed: int):
    """The reference's parameter tree as f32 numpy arrays: ``embed``,
    ``final_norm``, ``pat`` (one table per pattern position, stacked over
    periods) and ``rem``."""
    tabs = model_tables(cfg)
    rng = np.random.default_rng(seed)
    return {
        "embed": _init_table(tabs["embed"], rng, 0),
        "final_norm": _init_table(tabs["final_norm"], rng, 0),
        "pat": tuple(_init_table(t, rng, cfg.num_periods)
                     for t in tabs["pat"]),
        "rem": tuple(_init_table(t, rng, 0) for t in tabs["rem"]),
    }


def _layer_cache_shape(cfg: ModelConfig, spec: LayerSpec, b: int, L_: int):
    """dict name -> (shape, dtype, kind) for one layer's decode cache."""
    if spec.mixer != ATTN:
        raise NotImplementedError(f"the {spec.mixer} cache comes with a "
                                  f"later slice of the port")
    dh, hkv = cfg.head_dim, cfg.num_kv_heads
    bf = torch.bfloat16
    return {"k": ((b, L_, hkv, dh), bf, "kv"),
            "v": ((b, L_, hkv, dh), bf, "kv")}


def cache_struct(cfg: ModelConfig, b: int, cache_len: int):
    """({"pat": per-position {name: (shape, dtype)} with the period
    stack leading, "rem": ...}, the matching {name: kind} tree)."""
    def one(spec, stack):
        shapes = _layer_cache_shape(cfg, spec, b, cache_len)
        sds = {k: (((stack,) + s) if stack else s, d)
               for k, (s, d, _) in shapes.items()}
        return sds, {k: kind for k, (_, _, kind) in shapes.items()}
    pat = [one(spec, cfg.num_periods) for spec in cfg.pattern]
    rem = [one(spec, 0) for spec in cfg.remainder]
    return ({"pat": tuple(s for s, _ in pat), "rem": tuple(s for s, _ in rem)},
            {"pat": tuple(k for _, k in pat), "rem": tuple(k for _, k in rem)})


def _angles(cfg: ModelConfig, positions: torch.Tensor):
    """Rope angles (..., s, head_dim // 2) for integer ``positions``
    (..., s); None for a rope-free model."""
    if cfg.rope_theta == 0:
        return None
    if cfg.mrope_sections or cfg.mla is not None:
        raise NotImplementedError("M-RoPE and MLA rope come with later "
                                  "slices of the port")
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)
