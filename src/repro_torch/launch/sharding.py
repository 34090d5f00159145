"""Sharding rules (the JAX package's ``launch/sharding.py``): logical
parameter axes -> mesh axes, cache and batch specs, ZeRO-style
optimizer-state sharding, and ``place``, which lays a tree out on a
``DeviceMesh`` as DTensors.

Strategy, as in the reference:
  * weights: storage-sharded over ``model`` on their ff/vocab/experts/
    heads dims (each layer all-gathers its weights where it uses them,
    FSDP-style, in train and prefill; the same at decode);
  * activations: batch over ("pod", "data"), sequence over ``model``;
  * decode KV caches: sequence-sharded over ``model`` (or data + model
    for batch-1 long context);
  * optimizer moments: the parameter's spec plus its largest replicated
    dim over ``data``.

The spec trees are plain data: each leaf a ``PartitionSpec``, a tuple
of None, an axis name or a tuple of names per dim (JAX's
``PartitionSpec``), built on any mesh (``launch.mesh.AbstractMesh`` or a
``DeviceMesh``) with no process group touched.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import Dist, flat_groups, mesh_sizes
from repro_torch.tree import tree_map

# logical axis -> mesh axis (None = replicated)
AXIS_RULES = {
    "vocab": "model",
    "heads_ff": "model",
    "kv_ff": "model",
    "ff": "model",
    "experts": "model",
    "expert_ff": "data",     # ZeRO-3-style storage sharding within experts
    "heads": "model",
    "lora": None,
    "embed": None,
    "conv": None,
    None: None,
}


class PartitionSpec(tuple):
    """One leaf's spec: per dim None, an axis name or a tuple of names.
    A tuple subclass, so the port's tree helpers keep it whole (a
    leaf)."""

    def __new__(cls, *dims):
        names = [a for d in dims if d is not None
                 for a in (d if isinstance(d, tuple) else (d,))]
        if len(set(names)) != len(names):
            # JAX's NamedSharding refuses the same (DuplicateSpecError)
            raise ValueError(f"spec {dims} maps a mesh axis to more than "
                             f"one dim")
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a spec (JAX's ``NamedSharding``): where ``place`` and an
    elastic restore put a leaf."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named(mesh, specs):
    """A spec tree as a tree of ``NamedSharding``s on ``mesh``."""
    return tree_map(lambda sp: NamedSharding(mesh, sp), specs)


def make_dist(mesh, shape: Optional[ShapeConfig] = None) -> Dist:
    """The ``Dist`` of ``mesh`` (None: local).  A decode shape whose
    batch cannot shard over the data axes (``long_500k``, batch 1)
    spreads its KV cache over data + model."""
    if mesh is None:
        return Dist.local()
    sizes = mesh_sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    kv_axes = ()
    if shape is not None and shape.kind == "decode":
        dp = 1
        for a in data_axes:
            dp *= sizes[a]
        if shape.global_batch % dp != 0 or shape.global_batch < dp:
            kv_axes = data_axes + ("model",)
        else:
            kv_axes = ("model",)
    dist = Dist(mesh=mesh, data_axes=data_axes, model_axis="model",
                kv_axes=kv_axes)
    if hasattr(mesh, "mesh_dim_names"):
        flat_groups(mesh)           # collectively, before any island
    return dist


def _dp_size(dist: Dist) -> int:
    n = 1
    for a in dist.data_axes:
        n *= dist.shape[a]
    return n


def _batch_spec(dist: Dist, global_batch: int):
    if not dist.is_dist:
        return None
    dp = _dp_size(dist)
    if global_batch % dp == 0 and global_batch >= dp:
        return dist.data_axes if len(dist.data_axes) > 1 else dist.data_axes[0]
    return None


def _rule_dims(pd, stacked, sizes) -> list:
    dims = [None] if stacked else []
    for size, ax in zip(pd.shape, pd.axes):
        rule = AXIS_RULES.get(ax)
        if rule and size % sizes[rule] == 0 and size >= sizes[rule]:
            dims.append(rule)
        else:
            dims.append(None)
    return dims


def param_pspecs(cfg: ModelConfig, dist: Dist):
    """The spec tree of ``init_params``'s structure."""
    sizes = dist.shape
    return T.map_params_tree(
        cfg, lambda name, pd, stacked: P(*_rule_dims(pd, stacked, sizes)))


def cache_pspecs(cfg: ModelConfig, dist: Dist, global_batch: int,
                 cache_len: int, enc_len=None):
    """The spec tree of ``cache_struct``: a ``kv`` leaf's sequence over
    the KV axes, a ``state`` leaf's heads over ``model``, the batch over
    the data axes (not where the KV spans them)."""
    sizes = dist.shape
    struct, kinds = T.cache_struct(cfg, global_batch, cache_len, enc_len)
    b_spec = _batch_spec(dist, global_batch)
    kv = dist.kv_shard_axes or ("model",)
    kv_el = kv if len(kv) > 1 else kv[0]
    b_kv = None if any(a in kv for a in dist.data_axes) else b_spec
    msize = sizes["model"]

    def spec_for(kind, shape, stacked):
        nd = len(shape)
        lead = (None,) if stacked else ()
        if kind == "kv":
            seq = shape[len(lead) + 1]
            kv_ok = kv_el if seq % dist.kv_shards() == 0 else None
            return P(*lead, b_kv, kv_ok, *(None,) * (nd - len(lead) - 2))
        if kind == "state":
            H = shape[len(lead) + 1]
            h_ax = "model" if H % msize == 0 else None
            return P(*lead, b_spec, h_ax, *(None,) * (nd - len(lead) - 2))
        return P(*lead, b_spec, *(None,) * (nd - len(lead) - 1))

    def walk(sub, kk, stacked):
        return {k: spec_for(kk[k], s[0], stacked) for k, s in sub.items()}
    return {"pat": tuple(walk(s, k, True) for s, k in
                         zip(struct["pat"], kinds["pat"])),
            "rem": tuple(walk(s, k, False) for s, k in
                         zip(struct["rem"], kinds["rem"]))}


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, dist: Dist,
                 enc_pad: int = 0):
    del enc_pad
    b_spec = _batch_spec(dist, shape.global_batch)
    seq_ax = "model" if shape.seq_len % dist.shape["model"] == 0 else None
    if shape.kind in ("train", "prefill"):
        out = {}
        if shape.kind == "train":
            out["labels"] = P(b_spec, seq_ax)
        if cfg.frontend == "embeds" and not cfg.enc_dec:
            out["embeds"] = P(b_spec, seq_ax, None)
        else:
            out["tokens"] = P(b_spec, seq_ax)
        if cfg.enc_dec:
            out["enc_embeds"] = P(b_spec, "model", None)
        return out
    return {"token": P(b_spec, None), "pos": P()}


def zero_pspecs(cfg: ModelConfig, dist: Dist):
    """Optimizer-moment specs: the parameter's spec with its largest
    remaining replicated dim additionally over ``data`` (ZeRO-1)."""
    sizes = dist.shape
    dsize = sizes["data"]

    def fn(name, pd, stacked):
        dims = _rule_dims(pd, stacked, sizes)
        best, best_size = -1, 0
        off = 1 if stacked else 0
        for i, size in enumerate(pd.shape):
            if dims[i + off] is None and size % dsize == 0 and size > best_size:
                best, best_size = i + off, size
        if best >= 0:
            dims[best] = "data"
        return P(*dims)
    ptree = T.map_params_tree(cfg, fn)
    return {"m": ptree, "v": tree_map(lambda x: x, ptree), "step": P()}


def opt_struct(cfg: ModelConfig):
    """AdamW's state structure as meta tensors (f32 moments)."""
    ps = T.param_struct(cfg)
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")
    return {"m": tree_map(f32, ps), "v": tree_map(f32, ps),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def adafactor_struct(cfg: ModelConfig, opt):
    """Adafactor's state structure as meta tensors."""
    return opt.init(T.param_struct(cfg))


def adafactor_pspecs(cfg: ModelConfig, dist: Dist, opt):
    """Adafactor's state specs, from the parameter's: momentum mirrors
    it, ``vr`` drops the last dim, ``vc`` the second-to-last."""
    sizes = dist.shape

    def fn(name, pd, stacked):
        dims = _rule_dims(pd, stacked, sizes)
        ndim = len(pd.shape) + (1 if stacked else 0)
        st = {}
        if opt.b1:
            st["m"] = P(*dims)
        if ndim >= 2:
            st["vr"] = P(*dims[:-1])
            st["vc"] = P(*(dims[:-2] + dims[-1:]))
        else:
            st["v"] = P(*dims)
        return st
    return {"s": T.map_params_tree(cfg, fn), "step": P()}


def replicate(dist: Dist, tree):
    """Every leaf replicated (small trees)."""
    return tree_map(lambda _: P(), tree)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _mesh_device(device_mesh) -> torch.device:
    if device_mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_mesh.device_type)


def local_shard(t: torch.Tensor, spec, dist: Dist) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a
    view)."""
    for d, s in enumerate(tuple(spec)):
        if s is None:
            continue
        n, i = dist.size(s), dist.index(s)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"{n} ways ({s})")
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t


def place_leaf(leaf, sharding: NamedSharding, dtype=None):
    """One whole leaf (a tensor or a numpy array, the same on every rank)
    as the DTensor of ``sharding``: this rank's block on the mesh's
    device, with no communication."""
    from torch.distributed.tensor import DTensor
    mesh, spec = sharding.mesh, sharding.spec
    dist = Dist(mesh=mesh)
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    loc = local_shard(t, spec, dist).to(_mesh_device(mesh), copy=True,
                                        memory_format=torch.contiguous_format)
    return dist.dtensor(loc, spec, t.shape)


def place(tree, specs, device_mesh, dtype=None):
    """``tree`` (tensors or numpy arrays, each the whole value, the same
    on every rank) as DTensors on ``device_mesh`` under ``specs`` (a
    matching spec tree, or one spec for every leaf): each rank keeps its
    own block, on the mesh's device, with no communication.  ``dtype``
    casts the floating leaves."""
    if isinstance(specs, PartitionSpec):
        return tree_map(lambda leaf: place_leaf(
            leaf, NamedSharding(device_mesh, specs), dtype), tree)
    return tree_map(lambda leaf, sp: place_leaf(
        leaf, NamedSharding(device_mesh, sp), dtype), tree, specs)


def redistribute(tree, specs, device_mesh):
    """A tree of DTensors at the placements of ``specs`` (a matching spec
    tree)."""
    dist = Dist(mesh=device_mesh)
    return tree_map(lambda t, sp: t.redistribute(
        device_mesh, dist.placements(sp, t.ndim)), tree, specs)


def unplace(tree):
    """Every DTensor leaf as the whole tensor (gathered), every other as
    it is."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)
