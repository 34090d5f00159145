"""Shared model utilities: the distribution context, the axis-optional
collectives, norms, activation, online-softmax partials (the JAX
package's ``models/common.py``).

``Dist`` makes every model function runnable in two worlds:

  * ``Dist.local()``: no mesh; every collective is the identity, so each
    island body doubles as the single-device oracle;
  * a mesh: one process (rank) per device, each holding its local shard
    of every tensor, and the islands (ring attention, flash-decode over
    a sequence-sharded cache, expert-parallel all-to-all, the sharded
    SSD, the vocabulary-sharded embedding and head) exchange through
    collectives over the mesh axes' process groups.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, or an ``AbstractMesh`` (axis names and sizes, no process group;
``launch.mesh``), on which only the spec trees are built.  A tuple of
axes is one flattened group, its ranks in row-major order of the mesh
(``axis_index`` of ``("data", "model")`` is ``data * model_size +
model``).

Every rank runs the same program: a collective's output enters each
rank's result by the same ops (masked where the rank's part is void, as
the reference's static loops are), so each rank's backward meets the
same collectives in the same order.  The collectives differentiate by
the JAX transpose rules: the backward
of ``psum`` is ``psum``, of ``all_gather`` ``psum_scatter`` (and back),
of ``all_to_all`` the same exchange, of ``ppermute`` the inverse
permutation, and ``pmax`` stops the gradient.  These are the adjoints of
the program summed over ranks, so a loss that every rank holds whole
(psum'd) is differentiated as ``loss / world`` on each rank, and a
parameter's local shard enters through ``pvary`` (identity forward,
``psum`` over the axes it is replicated on backward): each gradient is
then counted once, neither multiplied by a group's size nor dropped.
``COLLECTIVES`` counts the calls by name, forward and backward.

Collectives run inside ``in_mesh(dist)``, the counterpart of
``shard_map``'s mesh: the groups come from the ``Dist`` in force, and
each backward keeps the group of its forward.

On an ``AbstractMesh`` (the dry run's production meshes, no process
group) the program is one rank's, traced on meta tensors: every
collective returns an empty tensor of its local result's shape, appends
``(kind, bytes, group size)`` to ``COLL_RECORD`` (the roofline counter
reads it; ``kind`` the HLO name, ``bytes`` the output's) and never
calls ``torch.distributed``; ``axis_index`` is 0.  A placed leaf there
is an ``AbstractDTensor`` (the block, the mesh, the placements and the
whole shape), which ``Dist.dtensor`` makes where a ``DeviceMesh``
gives a DTensor.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Sequence

import torch

NEG_INF = -1e30

# collectives issued, by name ("all_gather", "psum", ...), forward and
# backward; reset by whoever reads them
COLLECTIVES: collections.Counter = collections.Counter()
# collectives issued on an AbstractMesh: (kind, output bytes, group
# size), forward and backward; emptied by whoever reads them
COLL_RECORD: list = []


class AbstractGroup(NamedTuple):
    """A group of axes on an ``AbstractMesh``: its size, no ranks."""
    size: int


class AbstractDTensor:
    """One rank's block of a tensor laid out on an ``AbstractMesh``: what
    a DTensor is on a ``DeviceMesh``, with the calls the port makes of
    one (``to_local``, ``placements``, ``device_mesh``, the whole
    ``shape``).  Not a tensor: the code that differentiates through one
    takes its block (``launch.steps.value_and_grad``)."""

    def __init__(self, local: torch.Tensor, device_mesh, placements, shape):
        self._local = local
        self.device_mesh = device_mesh
        self.placements = tuple(placements)
        self.shape = torch.Size(shape)

    def to_local(self) -> torch.Tensor:
        return self._local

    @property
    def dtype(self):
        return self._local.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def detach(self) -> "AbstractDTensor":
        return AbstractDTensor(self._local.detach(), self.device_mesh,
                               self.placements, self.shape)

    def requires_grad_(self, flag: bool = True) -> "AbstractDTensor":
        self._local.requires_grad_(flag)
        return self

    def __repr__(self):
        return (f"AbstractDTensor(local={tuple(self._local.shape)}, "
                f"shape={tuple(self.shape)}, {self.placements})")


def is_placed(t) -> bool:
    """Whether ``t`` is a rank's block of a laid-out tensor (a DTensor
    or an ``AbstractDTensor``)."""
    if isinstance(t, AbstractDTensor):
        return True
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axes(axis) -> tuple:
    if not axis:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def flat_groups(mesh) -> dict:
    """{axes: this rank's process group} for every tuple of two or more
    of ``mesh``'s axes, made at the first call and kept on the mesh
    (``new_subgroups_by_enumeration`` is collective over the world: every
    rank makes them at the same point, in the same order)."""
    groups = getattr(mesh, "_repro_flat_groups", None)
    if groups is not None:
        return groups
    import torch.distributed as tdist
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh
    groups = {}
    for n in range(2, len(names) + 1):
        for combo in itertools.combinations(range(len(names)), n):
            rest = [i for i in range(len(names)) if i not in combo]
            k = math.prod(grid.shape[i] for i in combo)
            rows = grid.permute(*rest, *combo).reshape(-1, k).tolist()
            mine, _ = tdist.new_subgroups_by_enumeration(rows)
            groups[tuple(names[i] for i in combo)] = mine
    mesh._repro_flat_groups = groups
    return groups


@dataclass(frozen=True)
class Dist:
    """Distribution context threaded through every model function."""

    mesh: Any = None                     # DeviceMesh, AbstractMesh or None
    data_axes: tuple = ()                # batch axes, e.g. ("pod", "data")
    model_axis: Optional[str] = None     # TP/SP/EP axis ("model")
    # axes the decode KV cache's sequence dim is sharded over; defaults to
    # (model_axis,); long_500k (batch 1) uses ("data", "model")
    kv_axes: tuple = ()

    @staticmethod
    def local() -> "Dist":
        return Dist()

    @property
    def is_dist(self) -> bool:
        return self.mesh is not None

    @property
    def is_abstract(self) -> bool:
        """A mesh with no process group (``launch.mesh.AbstractMesh``)."""
        return self.is_dist and not hasattr(self.mesh, "get_group")

    @property
    def shape(self) -> dict:
        return mesh_sizes(self.mesh) if self.is_dist else {}

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def model_size(self) -> int:
        if not self.is_dist or self.model_axis is None:
            return 1
        return self.shape[self.model_axis]

    @property
    def kv_shard_axes(self) -> tuple:
        if self.kv_axes:
            return self.kv_axes
        return (self.model_axis,) if self.model_axis else ()

    def kv_shards(self) -> int:
        n = 1
        for a in self.kv_shard_axes:
            n *= self.shape[a]
        return n

    @property
    def world(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def size(self, axis) -> int:
        n = 1
        for a in _axes(axis):
            n *= self.shape[a]
        return n

    def index(self, axis) -> int:
        """This rank's coordinate along ``axis`` (a tuple: flattened,
        row-major); 0 on an abstract mesh."""
        if self.is_abstract:
            return 0
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + self.mesh.get_local_rank(a)
        return idx

    def group(self, axis):
        """The process group of ``axis`` (a name or a tuple of names)."""
        axes = _axes(axis)
        order = self.axis_names
        if tuple(sorted(axes, key=order.index)) != axes:
            raise ValueError(f"axes {axes} out of the mesh's order {order}")
        if self.is_abstract:
            return AbstractGroup(self.size(axes))
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        return flat_groups(self.mesh)[axes]

    # ---- specs <-> DTensor placements --------------------------------
    def placements(self, spec, ndim: int):
        """DTensor placements (one per mesh dim) of a spec: a tuple of
        None, an axis name or a tuple of names per tensor dim (missing
        trailing dims replicated)."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for a in self.axis_names:
            dims = [d for d, s in enumerate(tuple(spec)[:ndim])
                    if a in _axes(s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def spec_of(self, placements, ndim: int) -> tuple:
        """The spec of DTensor ``placements`` (the inverse of
        ``placements``)."""
        dims = [[] for _ in range(ndim)]
        for a, pl in zip(self.axis_names, placements):
            if pl.is_shard():
                dims[pl.dim].append(a)
            elif not pl.is_replicate():
                raise ValueError(f"placement {pl} has no spec")
        return tuple(None if not d else d[0] if len(d) == 1 else tuple(d)
                     for d in dims)

    def dtensor(self, local, spec, shape):
        """This rank's block ``local`` as the DTensor of whole ``shape``
        laid out by ``spec`` on the mesh (an ``AbstractDTensor`` on an
        abstract mesh)."""
        shape = torch.Size(shape)
        if self.is_abstract:
            return AbstractDTensor(local, self.mesh,
                                   self.placements(spec, len(shape)), shape)
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            local, self.mesh, self.placements(spec, len(shape)),
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    def constrain(self, x, *spec):
        """``with_sharding_constraint``: a DTensor is redistributed to
        ``spec``; a local shard is already laid out by the islands'
        convention (activations (batch over the data axes, sequence over
        ``model``)), so it passes as it is, as does everything locally."""
        if not self.is_dist:
            return x
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, self.placements(spec, x.ndim))
        return x

    def sharding(self, *spec):
        """The DTensor placements of ``spec`` (None locally)."""
        if not self.is_dist:
            return None
        return self.placements(spec, len(spec))


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                         default=None)


@contextlib.contextmanager
def in_mesh(dist: Dist):
    """Run collectives over ``dist``'s mesh (``shard_map``'s mesh)."""
    token = _ACTIVE.set(dist)
    try:
        yield dist
    finally:
        _ACTIVE.reset(token)


def active() -> Dist:
    d = _ACTIVE.get()
    if d is None or not d.is_dist:
        raise RuntimeError("a collective over a mesh axis runs inside "
                           "in_mesh(dist) with a mesh Dist")
    return d


# ---------------------------------------------------------------------------
# Axis-optional collectives (identity when axis is None), differentiated by
# the JAX transpose rules.
# ---------------------------------------------------------------------------

def _tdist():
    import torch.distributed as tdist
    return tdist


def _abstract(kind: str, x: torch.Tensor, group, shape=None):
    """A collective on an abstract group: an empty result of ``shape``
    (default ``x``'s), recorded in ``COLL_RECORD``."""
    out = torch.empty(x.shape if shape is None else shape, dtype=x.dtype,
                      device=x.device)
    COLL_RECORD.append((kind, out.numel() * out.element_size(), group.size))
    return out


def _all_reduce(x, group, op="sum"):
    if isinstance(group, AbstractGroup):
        return _abstract("all-reduce", x, group)
    tdist = _tdist()
    y = x.contiguous().clone()
    tdist.all_reduce(y, op=getattr(tdist.ReduceOp, op.upper()), group=group)
    return y


def _gather(x, group, n, dim):
    if isinstance(group, AbstractGroup):
        shape = list(x.shape)
        shape[dim] *= n
        return _abstract("all-gather", x, group, shape)
    tdist = _tdist()
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    tdist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter_sum(x, group, n, dim):
    if isinstance(group, AbstractGroup):
        shape = list(x.shape)
        shape[dim] //= n
        return _abstract("reduce-scatter", x, group, shape)
    tdist = _tdist()
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    tdist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _a2a(x, group):
    if isinstance(group, AbstractGroup):
        return _abstract("all-to-all", x, group)
    tdist = _tdist()
    x = x.contiguous()
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=group)
    return out


def _permute(x, group, pairs, me):
    """Send ``x`` along ``pairs`` ((src, dst) group indices); a rank that
    receives nothing gets zeros."""
    if isinstance(group, AbstractGroup):
        return _abstract("collective-permute", x, group)
    tdist = _tdist()
    ranks = tdist.get_process_group_ranks(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for s, d in pairs:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(tdist.P2POp(tdist.isend, x, ranks[d], group))
        elif d == me:
            ops.append(tdist.P2POp(tdist.irecv, out, ranks[s], group))
    if ops:
        for w in tdist.batch_isend_irecv(ops):
            w.wait()
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        COLLECTIVES["psum"] += 1
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["psum"] += 1
        return _all_reduce(g, ctx.group), None


class _Pvary(torch.autograd.Function):
    """Identity forward; psum of the cotangent backward (JAX's
    ``pvary``/``pbroadcast``: a value replicated over ``axis`` entering
    per-rank computation)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["psum"] += 1
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        COLLECTIVES["all_gather"] += 1
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["psum_scatter"] += 1
        return _scatter_sum(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        COLLECTIVES["psum_scatter"] += 1
        return _scatter_sum(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["all_gather"] += 1
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        COLLECTIVES["all_to_all"] += 1
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["all_to_all"] += 1
        return _a2a(g, ctx.group), None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs, me):
        ctx.group, ctx.pairs, ctx.me = group, pairs, me
        COLLECTIVES["ppermute"] += 1
        return _permute(x, group, pairs, me)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES["ppermute"] += 1
        inv = [(d, s) for s, d in ctx.pairs]
        return _permute(g, ctx.group, inv, ctx.me), None, None, None


def psum(x, axis):
    return _Psum.apply(x, active().group(axis)) if axis else x


def pvary(x, axis):
    """``x``, replicated over ``axis``, entering per-rank computation:
    the identity, whose backward psums the cotangent over ``axis``."""
    return _Pvary.apply(x, active().group(axis)) if axis else x


def pmax(x, axis):
    """pmax for softmax/logsumexp stabilization, on the detached ``x``
    (JAX's stop-gradient): every use stabilizes an ``exp`` whose final
    value does not depend on the max."""
    if not axis:
        return x
    COLLECTIVES["pmax"] += 1
    return _all_reduce(x.detach(), active().group(axis), "max")


def pmean(x, axis):
    return psum(x, axis) / axis_size(axis) if axis else x


def axis_index(axis) -> int:
    return active().index(axis) if axis else 0


def axis_size(axis) -> int:
    return active().size(axis) if axis else 1


def all_gather(x, axis, dim: int = 0, tiled: bool = True):
    """The shards of ``axis`` concatenated along ``dim`` (``tiled``), or
    stacked on a new leading dim."""
    if not axis:
        return x if tiled else x[None]
    if not tiled:
        x, dim = x[None], 0
    return _AllGather.apply(x, active().group(axis), axis_size(axis),
                            dim % x.ndim)


def psum_scatter(x, axis, dim: int = 0):
    """Sum over ``axis``, this rank keeping its ``1/size`` block of
    ``dim`` (tiled)."""
    if not axis:
        return x
    return _PsumScatter.apply(x, active().group(axis), axis_size(axis),
                              dim % x.ndim)


def all_to_all(x, axis):
    """The symmetric tiled all-to-all over dim 0: block ``j`` of dim 0
    goes to shard ``j``, whose block ``i`` of the result is this rank's
    (JAX's ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    if not axis:
        return x
    return _AllToAll.apply(x, active().group(axis))


def ppermute(x, axis, perm: Sequence):
    """``x`` sent from shard ``s`` to shard ``d`` for each ``(s, d)`` of
    ``perm``; a shard that receives nothing gets zeros."""
    if not axis:
        return x
    return _Ppermute.apply(x, active().group(axis),
                           tuple((int(s), int(d)) for s, d in perm),
                           axis_index(axis))


def chunk(x, axis, dim: int):
    """This rank's block of ``dim`` split over ``axis``: a local slice,
    whose backward zero-pads."""
    if not axis:
        return x
    n = axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis} ({n})")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(axis) * size, size)


def relayout(x, src, dst):
    """A local shard laid out by spec ``src`` as laid out by ``dst``
    (each a tuple of None, an axis name or a tuple of names per dim):
    all-gather every axis ``src`` shards a dim over and ``dst`` does
    not, then slice every axis ``dst`` adds.  Differentiable (the
    gather's backward psum-scatters, the slice's zero-pads)."""
    src = tuple(src) + (None,) * (x.ndim - len(tuple(src)))
    dst = tuple(dst) + (None,) * (x.ndim - len(tuple(dst)))
    for d in range(x.ndim):
        s_ax, d_ax = _axes(src[d]), _axes(dst[d])
        if s_ax == d_ax:
            continue
        if s_ax:
            x = all_gather(x, s_ax, d)
    for d in range(x.ndim):
        s_ax, d_ax = _axes(src[d]), _axes(dst[d])
        if s_ax != d_ax and d_ax:
            x = chunk(x, d_ax, d)
    return x


def replicated_axes(dist: Dist, spec) -> tuple:
    """The mesh axes ``spec`` shards no dim over, in mesh order."""
    used = {a for s in tuple(spec) for a in _axes(s)}
    return tuple(a for a in dist.axis_names if a not in used)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in the ``1 + scale`` form (a zero scale is the identity
    gain)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


# ---------------------------------------------------------------------------
# Online-softmax partials (m, l, o): m = running max of scores, l = sum
# exp(score - m), o = sum exp(..) * v (o unnormalized).
# ---------------------------------------------------------------------------

def merge_partials(a, b):
    m_a, l_a, o_a = a
    m_b, l_b, o_b = b
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    l = l_a * ca + l_b * cb
    o = o_a * ca[..., None] + o_b * cb[..., None]
    return m, l, o


def finalize_partials(m, l, o):
    return o / torch.clamp_min(l, 1e-30)[..., None]


def empty_partials(shape_ml, d: int, device=None, dtype=torch.float32):
    """The partials of no block: m = NEG_INF, l = 0, o = 0."""
    m = torch.full(shape_ml, NEG_INF, dtype=dtype, device=device)
    l = torch.zeros(shape_ml, dtype=dtype, device=device)
    o = torch.zeros((*shape_ml, d), dtype=dtype, device=device)
    return m, l, o
