"""Model assembly for ``ATTN``/``ATTN_LOCAL``/``MLA``/``SSM`` stacks and
whisper's encoder-decoder (``ENC`` encoder, ``CROSS`` decoder) with
dense or MoE feed-forwards:
parameter tables, an own parameter init, cache shapes and rope angles,
the whole-model forward passes (``init_cache``, ``_run_stack``,
``prefill``, ``decode_step``) and the training loss (``train_loss``),
with the tree's shapes, dtypes and logical axes (``map_params_tree``,
``param_struct``, ``param_axes``) — the single-device part of the JAX
package's ``models/transformer.py``.

``init_params`` draws every table's shapes at the reference's scales (a
matrix at 1/sqrt(fan-in), a zero-scale vector as zeros, the embedding at
1/sqrt(d_model)).  As in the reference, the scale of a matrix whose
``scale`` is unset comes from its table shape's leading dim: for a
routed-expert stack ``(E, d, f)`` that is the expert count, so every
expert is drawn at 1/sqrt(E).  Each entry of each layer draws from its own numpy
generator, seeded by ``(seed, part, position, period, entry)``, and each
expert of a routed-expert stack from its own, seeded by ``(...,
expert)`` (``table_params``, ``expert_params``), so an engine can draw
one unit — or one expert — at a time: the offloaded engine packs and
frees each as it goes, on several threads (``draw_tables``), and still
holds the numbers the whole-tree ``init_params`` gives the resident
engine.  The reference draws with
``jax.random``, whose numbers the port cannot reproduce; the tests carry
the reference's weights across instead (``core.convert``).

The forward passes keep the JAX package's layout (``pat`` tables and
caches stacked over periods, ``rem`` unstacked) and loop over layers in
Python where the JAX package scans.  Decode updates the caches in place
(the JAX package returns new ones).  A sliding-window layer's cache is
its rolling ``(b, W, hkv, dh)`` buffer (kind ``"rep"``), beside the
global layers' ``max_len`` slabs (kind ``"kv"``); an MLA layer's is its
latent ``c`` (b, L, kv_lora_rank) and ``kr`` (b, L, qk_rope_head_dim)
slabs (kind ``"kv"``), and its rope turns ``qk_rope_head_dim`` features.
An SSM layer's is its conv halo ``(b, d_conv - 1, conv_ch)`` (bf16, kind
``"rep"``) and its f32 state ``(b, H, head_dim, d_state)`` (kind
``"state"``); decode replaces both leaves with the step's whole new ones,
as the reference's functional decode does, so the halo leaf holds f32
after the first decode step there too.  Every parameter is f32, the
reference's SSM scalars (``A_log``, ``D``, ``dt_bias``) among them.

Encoder-decoder (whisper): the tree gains ``"enc"``, its one ``ENC``
table stacked over ``num_encoder_layers`` and its final norm.  Prefill
encodes the batch's ``enc_embeds`` frames (``_encode``: sinusoidal
positions, the ENC stack, the norm) and each CROSS layer caches its
``ck``/``cv`` projections of them (kind ``"rep"``, ``enc_len`` rows)
beside its ``k``/``v`` slabs; decode attends those rows.  A rope-free
model (``rope_theta`` 0) adds sinusoidal positions to its inputs: the
prompt's first ``s`` rows, or each decode row's own, computed at its
position where the reference indexes a ``max_seq_len`` table.  A batch
may carry ``"embeds"`` in place of tokens (the frontends' stubs), and
an M-RoPE model (qwen2-vl) rotates by its three equal position
components.

Training (``train_loss``) runs the stack in train mode (plain,
differentiable PyTorch, no kernel and no cache), sums the layers'
load-balance losses and adds ``AUX_WEIGHT`` times their mean over the
MoE layers to the head's cross-entropy, as the reference does.  With
``remat`` each layer of the period loop and of the encoder goes through
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward pass, the counterpart of the reference's
``jax.checkpoint(policy=nothing_saveable)`` around its scan body.

Under a mesh (``dist``, one rank per device; ``models.layers``): a
parameter leaf is a DTensor (``launch.sharding.place``), whose
placements give its storage spec, or a whole tensor, replicated; each
enters through ``pvary`` over the axes it is replicated on, so its
gradient is summed over them, and each layer all-gathers its own weights
(``layers.use_params``) where the reference's GSPMD gathers inside the
scan.  The batch's leaves, DTensors or whole tensors, become this rank's
shard of the activations' layout (``Ctx.act_spec``); rope angles and
sinusoidal rows are taken at the shard's own positions.  ``train_loss``
returns the loss every rank holds whole (``launch.steps`` differentiates
it divided by the world); ``prefill`` returns the next tokens and the
caches as DTensors under ``launch.sharding.cache_pspecs``, and
``decode_step`` takes them so (or whole) and returns them so.
"""
from __future__ import annotations

import collections
import itertools
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, CROSS, DENSE, ENC,
                                      MLA, MOE, SSM, LayerSpec, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import (Dist, all_gather, in_mesh,
                                       is_placed, pvary, relayout,
                                       replicated_axes)
from repro_torch.models.rope import (rope_angles, sinusoidal_positions,
                                     sinusoidal_rows)
from repro_torch.tree import leaves, unflatten

# the tree's tables; a part's index seeds its draws ("enc_pat" and
# "enc_final_norm" are the encoder's "pat" and "final_norm")
PARTS = ("embed", "final_norm", "pat", "rem", "enc_pat", "enc_final_norm")
ENC_SPEC = LayerSpec(ENC, DENSE)
AUX_WEIGHT = 0.01  # load-balance loss weight
# parameters the reference keeps in f32 whatever the tree's dtype
F32_NAMES = ("A_log", "dt_bias", "D")


def keeps_dtype(name: str) -> bool:
    """Whether a leaf keeps its own dtype whatever the tree's: the f32
    SSM scalars and a resident INT4 table's packed bytes (``#q``,
    uint8) and scales (``#s``, f32)."""
    return name in F32_NAMES or name.endswith(("#q", "#s"))


def _np_dtype(pd: L.ParamDef):
    return np.uint8 if pd.scale == -2.0 else np.float32


def model_tables(cfg: ModelConfig):
    t = {
        "embed": L.embed_table(cfg),
        "final_norm": {"scale": L.ParamDef((cfg.d_model,), (None,), 0.0)},
        "pat": tuple(L.layer_table(cfg, s) for s in cfg.pattern),
        "rem": tuple(L.layer_table(cfg, s) for s in cfg.remainder),
    }
    if cfg.enc_dec:
        t["enc"] = {
            "pat": (L.layer_table(cfg, ENC_SPEC),),
            "final_norm": {"scale": L.ParamDef((cfg.d_model,), (None,),
                                               0.0)},
        }
    return t


def _init_entry(rng: np.random.Generator, pd: L.ParamDef,
                shape=None) -> np.ndarray:
    """``pd`` drawn at its scale, at ``shape`` (default ``pd.shape``; an
    expert's slice of a stack keeps the stack's scale).  A resident INT4
    table's packed bytes (scale -2, ``#q``) are uint8 in [0, 255), its
    scales (-3, ``#s``) f32 in [1e-3, 2e-3), as the reference draws them."""
    shape = pd.shape if shape is None else shape
    if pd.scale == -2.0:
        return rng.integers(0, 255, shape, dtype=np.uint8)
    if pd.scale == -3.0:
        return rng.uniform(1e-3, 2e-3, shape).astype(np.float32)
    if pd.scale == 0.0:
        return np.zeros(shape, np.float32)
    scale = pd.scale if pd.scale > 0 else 1.0 / math.sqrt(max(1, pd.shape[0]))
    out = rng.standard_normal(shape, dtype=np.float32)
    out *= np.float32(scale)
    return out


def _table(cfg: ModelConfig, part: str, q: int, tables=None):
    tabs = tables or model_tables(cfg)
    if part.startswith("enc_"):
        tabs, part = tabs["enc"], part[4:]
    return tabs[part][q] if part in ("pat", "rem") else tabs[part]


def table_params(cfg: ModelConfig, seed: int, part: str, q: int = 0,
                 p: int = 0, tables=None, experts: bool = True,
                 workers: int = 1) -> Dict[str, np.ndarray]:
    """One table's f32 tensors: ``embed`` or ``final_norm``, or the layer
    at pattern position ``q`` of period ``p`` (``pat``) / remainder
    position ``q`` (``rem``), or the encoder's layer ``p`` (``enc_pat``)
    / final norm (``enc_final_norm``).  Every entry has its own generator; a
    routed-expert stack is ``expert_params`` stacked over the experts
    (left out with ``experts=False``).  ``workers`` > 1 draws the other
    entries on that many threads (the same numbers)."""
    tab = _table(cfg, part, q, tables)
    k = PARTS.index(part)
    items = sorted(tab.items())

    def entry(i):
        return _init_entry(np.random.default_rng([seed, k, q, p, i]),
                           items[i][1])
    dense = [i for i, (_, pd) in enumerate(items)
             if not L.is_expert_stack(pd)]
    if workers > 1:
        with ThreadPoolExecutor(workers) as ex:
            drawn = dict(zip(dense, ex.map(entry, dense)))
    else:
        drawn = {i: entry(i) for i in dense}
    out = {}
    for i, (name, pd) in enumerate(items):
        if i in drawn:
            out[name] = drawn[i]
        elif experts:
            out[name] = np.stack([
                expert_params(cfg, seed, part, q, p, e, tables)[name]
                for e in range(pd.shape[0])])
    return out


def expert_params(cfg: ModelConfig, seed: int, part: str, q: int, p: int,
                  e: int, tables=None) -> Dict[str, np.ndarray]:
    """Expert ``e``'s slices of the layer's routed-expert stacks
    (``w_gate``/``w_up`` (d, f), ``w_down`` (f, d)), each from its own
    generator."""
    tab = _table(cfg, part, q, tables)
    k = PARTS.index(part)
    return {name: _init_entry(np.random.default_rng([seed, k, q, p, i, e]),
                              pd, pd.shape[1:])
            for i, (name, pd) in enumerate(sorted(tab.items()))
            if L.is_expert_stack(pd)}


def table_keys(cfg: ModelConfig):
    """``(part, q, p)`` of every layer table, in schedulable-unit order
    (period-major over the pattern, then the remainder)."""
    return ([("pat", q, p) for p in range(cfg.num_periods)
             for q in range(len(cfg.pattern))]
            + [("rem", q, 0) for q in range(len(cfg.remainder))])


def _draw(cfg: ModelConfig, seed: int, key: Tuple, tables):
    """``key`` is ``(part, q, p)`` (the whole table), ``(part, q, p,
    None)`` (the table without its expert stacks) or ``(part, q, p, e)``
    (expert ``e``)."""
    if len(key) == 3:
        return table_params(cfg, seed, *key, tables=tables)
    part, q, p, e = key
    if e is None:
        return table_params(cfg, seed, part, q, p, tables, experts=False)
    return expert_params(cfg, seed, part, q, p, e, tables)


def draw_tables(cfg: ModelConfig, seed: int, keys: Iterable[Tuple],
                workers: int = 0) -> Iterator[Tuple[Tuple, Dict]]:
    """Yield ``(key, tensors)`` in the order of ``keys`` (``_draw``),
    drawing up to ``workers`` keys ahead on threads (numpy's generators
    release the interpreter lock while they fill).  0: the host's core
    count, at most 8."""
    workers = workers or min(8, os.cpu_count() or 1)
    tabs = model_tables(cfg)
    it = iter(keys)
    with ThreadPoolExecutor(workers) as ex:
        ahead = collections.deque(
            (k, ex.submit(_draw, cfg, seed, k, tabs))
            for k in itertools.islice(it, workers))
        while ahead:
            key, fut = ahead.popleft()
            nxt = next(it, None)
            if nxt is not None:
                ahead.append((nxt, ex.submit(_draw, cfg, seed, nxt, tabs)))
            yield key, fut.result()


def init_params(cfg: ModelConfig, seed: int):
    """The reference's parameter tree as f32 numpy arrays: ``embed``,
    ``final_norm``, ``pat`` (one table per pattern position, stacked over
    periods) and ``rem``; an encoder-decoder's ``enc`` (``pat``: its one
    table stacked over ``num_encoder_layers``, and ``final_norm``)."""
    tabs = model_tables(cfg)
    # the vocabulary tables (``emb``, an untied ``w_out``) are a wide
    # model's largest entries: one thread each
    params = {part: table_params(cfg, seed, part, tables=tabs, workers=2)
              for part in ("embed", "final_norm")}
    pat = [{name: np.empty((cfg.num_periods,) + pd.shape, _np_dtype(pd))
            for name, pd in t.items()} for t in tabs["pat"]]
    rem = [None] * len(cfg.remainder)
    for (part, q, p), t in draw_tables(cfg, seed, table_keys(cfg)):
        if part == "pat":
            for name, a in t.items():
                pat[q][name][p] = a
        else:
            rem[q] = t
    params["pat"], params["rem"] = tuple(pat), tuple(rem)
    if cfg.enc_dec:
        n = cfg.num_encoder_layers
        enc = {name: np.empty((n,) + pd.shape, _np_dtype(pd))
               for name, pd in tabs["enc"]["pat"][0].items()}
        keys = [("enc_pat", 0, p) for p in range(n)]
        for (_, _, p), t in draw_tables(cfg, seed, keys):
            for name, a in t.items():
                enc[name][p] = a
        params["enc"] = {"pat": (enc,), "final_norm": table_params(
            cfg, seed, "enc_final_norm", tables=tabs)}
    return params


def to_device(tree, device, dtype=None):
    """A parameter tree of numpy arrays (``init_params``) as tensors on
    ``device``, in the same structure; with ``dtype`` every leaf but the
    SSM scalars and the packed INT4 tables (``keeps_dtype``: their dtype
    in the reference whatever the tree's) is cast to it on the device."""
    def put(name, a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t if dtype is None or keeps_dtype(name) else t.to(dtype)

    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(walk(v, name) for v in t)
        return put(name, t)
    return walk(tree)


def map_params_tree(cfg: ModelConfig, fn):
    """A tree of ``init_params``'s structure with leaf ``fn(name,
    ParamDef, stacked)``: ``stacked`` for the tables of ``pat`` and the
    encoder's ``pat``."""
    tabs = model_tables(cfg)

    def tab(t, stacked):
        return {name: fn(name, pd, stacked) for name, pd in t.items()}
    out = {
        "embed": tab(tabs["embed"], False),
        "final_norm": tab(tabs["final_norm"], False),
        "pat": tuple(tab(t, True) for t in tabs["pat"]),
        "rem": tuple(tab(t, False) for t in tabs["rem"]),
    }
    if cfg.enc_dec:
        out["enc"] = {
            "pat": tuple(tab(t, True) for t in tabs["enc"]["pat"]),
            "final_norm": tab(tabs["enc"]["final_norm"], False),
        }
    return out


def param_struct(cfg: ModelConfig, dtype=torch.bfloat16):
    """The tree's shapes and dtypes as ``device="meta"`` tensors: every
    leaf at ``dtype`` but the f32 SSM scalars, a packed ``#q`` uint8 and
    its ``#s`` f32; ``pat`` stacked over ``num_periods``, the encoder's
    over ``num_encoder_layers``.  The encoder's leaves are typed as the
    reference's ``param_struct`` types them, ``#q``/``#s`` at ``dtype``
    (ROADMAP Queue 3 item 23)."""
    def leaf(shape, name, packed=True):
        if packed and name.endswith("#q"):
            dt = torch.uint8
        elif (packed and name.endswith("#s")) or name in F32_NAMES:
            dt = torch.float32
        else:
            dt = dtype
        return torch.empty(shape, dtype=dt, device="meta")

    def fn(name, pd, stacked):
        return leaf(((cfg.num_periods,) + pd.shape) if stacked
                    else pd.shape, name)
    tree = map_params_tree(cfg, fn)
    if cfg.enc_dec:
        tree["enc"]["pat"] = tuple(
            {name: leaf((cfg.num_encoder_layers,) + pd.shape, name, False)
             for name, pd in t.items()}
            for t in model_tables(cfg)["enc"]["pat"])
    return tree


def param_axes(cfg: ModelConfig):
    """The tree's logical axis names per leaf (``ParamDef.axes``, with a
    leading None for a stacked table), for the sharding slice."""
    return map_params_tree(
        cfg, lambda name, pd, stacked: ((None,) + pd.axes) if stacked
        else pd.axes)


# ===========================================================================
# Caches
# ===========================================================================


def _layer_cache_shape(cfg: ModelConfig, spec: LayerSpec, b: int, L_: int,
                       enc_len=None):
    """dict name -> (shape, dtype, kind) for one layer's decode cache:
    a ``max_len`` slab (kind ``"kv"``) for global attention, the rolling
    buffer of ``cfg.window`` rows (kind ``"rep"``) for a sliding-window
    layer, the latent ``c``/``kr`` slabs (kind ``"kv"``) for MLA, the
    conv halo (kind ``"rep"``) and f32 state (kind ``"state"``) for
    SSM; for CROSS the ``k``/``v`` slabs beside the encoder rows
    ``ck``/``cv`` (kind ``"rep"``, ``enc_len`` rows, by default
    ``cfg.encoder_seq_len``)."""
    dh, hkv = cfg.head_dim, cfg.num_kv_heads
    bf = torch.bfloat16
    if spec.mixer == ATTN:
        return {"k": ((b, L_, hkv, dh), bf, "kv"),
                "v": ((b, L_, hkv, dh), bf, "kv")}
    if spec.mixer == ATTN_LOCAL:
        W = cfg.window
        return {"k": ((b, W, hkv, dh), bf, "rep"),
                "v": ((b, W, hkv, dh), bf, "rep")}
    if spec.mixer == MLA:
        m = cfg.mla
        return {"c": ((b, L_, m.kv_lora_rank), bf, "kv"),
                "kr": ((b, L_, m.qk_rope_head_dim), bf, "kv")}
    if spec.mixer == SSM:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        H = d_in // s.head_dim
        conv_ch = d_in + 2 * s.n_groups * s.d_state
        return {"conv": ((b, s.d_conv - 1, conv_ch), bf, "rep"),
                "state": ((b, H, s.head_dim, s.d_state), torch.float32,
                          "state")}
    if spec.mixer == CROSS:
        E = enc_len or cfg.encoder_seq_len
        return {"k": ((b, L_, hkv, dh), bf, "kv"),
                "v": ((b, L_, hkv, dh), bf, "kv"),
                "ck": ((b, E, hkv, dh), bf, "rep"),
                "cv": ((b, E, hkv, dh), bf, "rep")}
    raise ValueError(f"no decode cache for a {spec.mixer} layer")


def cache_struct(cfg: ModelConfig, b: int, cache_len: int, enc_len=None):
    """({"pat": per-position {name: (shape, dtype)} with the period
    stack leading, "rem": ...}, the matching {name: kind} tree).
    ``enc_len``: a CROSS layer's encoder rows (``cfg.encoder_seq_len``
    when None)."""
    def one(spec, stack):
        shapes = _layer_cache_shape(cfg, spec, b, cache_len, enc_len)
        sds = {k: (((stack,) + s) if stack else s, d)
               for k, (s, d, _) in shapes.items()}
        return sds, {k: kind for k, (_, _, kind) in shapes.items()}
    pat = [one(spec, cfg.num_periods) for spec in cfg.pattern]
    rem = [one(spec, 0) for spec in cfg.remainder]
    return ({"pat": tuple(s for s, _ in pat), "rem": tuple(s for s, _ in rem)},
            {"pat": tuple(k for _, k in pat), "rem": tuple(k for _, k in rem)})


def init_cache(cfg: ModelConfig, b: int, cache_len: int, device="cuda",
               enc_len=None):
    """The zeroed decode cache (bf16 rows and f32 SSM states, as the
    reference's) on ``device`` (CUDA unless the caller asks for the
    CPU); ``enc_len`` as in ``cache_struct``."""
    device = resolve_device(device)
    struct, _ = cache_struct(cfg, b, cache_len, enc_len)
    return {grp: tuple({n: torch.zeros(s, dtype=dt, device=device)
                        for n, (s, dt) in t.items()} for t in struct[grp])
            for grp in ("pat", "rem")}


# ===========================================================================
# Forward passes
# ===========================================================================


def _angles(cfg: ModelConfig, positions: torch.Tensor):
    """Rope angles (..., s, rope_dim // 2) for integer ``positions``
    (..., s): ``rope_dim`` is ``head_dim``, or MLA's
    ``qk_rope_head_dim``; None for a rope-free model.  Under M-RoPE the
    positions broadcast to three equal (t, h, w) components, as the
    reference's text-only stub does."""
    if cfg.rope_theta == 0:
        return None
    rope_dim = (cfg.mla.qk_rope_head_dim if cfg.mla is not None
                else cfg.head_dim)
    if cfg.mrope_sections:
        pos3 = positions.expand((3,) + tuple(positions.shape))
        return rope_angles(pos3, rope_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    return rope_angles(positions, rope_dim, cfg.rope_theta)


# ===========================================================================
# Under a mesh: local shards in, DTensors out
# ===========================================================================


def _enter(params, dist: Dist):
    """(this rank's shard of every parameter leaf, each through
    ``pvary`` over the axes it is replicated on; the storage specs).  A
    DTensor's spec comes from its placements; a whole tensor is
    replicated."""
    local, specs = [], []
    with in_mesh(dist):
        for t in leaves(params):
            if is_placed(t):
                spec = dist.spec_of(t.placements, t.ndim)
                t = t.to_local()
            else:
                spec = (None,) * t.ndim
            local.append(pvary(t, replicated_axes(dist, spec)))
            specs.append(spec)
    return unflatten(params, local), unflatten(params, specs)


def _local(t, want, dist: Dist):
    """This rank's block of ``t`` (a DTensor, or the whole tensor on
    every rank) under the spec ``want``."""
    with in_mesh(dist):
        if is_placed(t):
            return relayout(t.to_local(), dist.spec_of(t.placements, t.ndim),
                            want)
        return relayout(t, (None,) * t.ndim, want)


def _local_batch(batch, ctx: L.Ctx):
    """The batch's leaves at the activations' layout: tokens, labels and
    embeds (batch, sequence), the encoder's frames (batch, frames over
    ``model``), a decode step's tokens and ragged positions (batch)."""
    dist = ctx.dist
    spec = ctx.act_spec()
    out = {}
    for k, v in batch.items():
        if k == "pos":
            out[k] = (_local(v, (ctx.dp,), dist)
                      if isinstance(v, torch.Tensor) and v.ndim == 1 else v)
        elif k == "enc_embeds":
            out[k] = _local(v, (ctx.dp, dist.model_axis, None), dist)
        else:
            out[k] = _local(v, spec + (None,) * (v.ndim - 2), dist)
    return out


def _positions(n: int, ctx: L.Ctx, device):
    """The positions of this rank's ``n`` sequence rows: its block of
    the whole sequence under a mesh, else ``0..n-1``."""
    axis = ctx.seq_axis() if ctx.sharded else None
    start = ctx.dist.index(axis) * n if axis else 0
    return torch.arange(start, start + n, device=device)


def _use(t, spec, want, dist: Dist):
    with in_mesh(dist):
        return relayout(t, spec, want)


def _embed_use(params, specs, ctx: L.Ctx):
    """The vocabulary tables at the islands' layout: ``emb`` split over
    ``model`` on the vocabulary, an untied ``w_out`` likewise."""
    if not ctx.sharded:
        return params["embed"]
    m = ctx.dist.model_axis
    want = {"emb": (m, None), "w_out": (None, m)}
    return {n: _use(t, specs["embed"][n], want[n], ctx.dist)
            for n, t in params["embed"].items()}


def _whole(params, specs, key, ctx: L.Ctx):
    """A table's leaves whole (all-gathered) under a mesh."""
    tab = params[key]
    if not ctx.sharded:
        return tab
    return {n: _use(t, specs[key][n], (None,) * t.ndim, ctx.dist)
            for n, t in tab.items()}


def _run_stack(params, x, ctx: L.Ctx, caches, cfg: ModelConfig,
               remat: bool = False, specs=None):
    """Every layer in order (the periods of ``pat``, then ``rem``).
    Returns (x, each layer's new cache rows: ``pat`` a list per pattern
    position over periods, ``rem`` a list; the layers' summed
    load-balance loss, f32).  ``remat`` (no caches) recomputes each
    period's activations in the backward pass.  Under a mesh ``specs``
    holds the leaves' storage specs and each layer gathers its weights
    (``layers.use_params``)."""
    tabs = model_tables(cfg) if ctx.sharded else None

    def use(ps, grp, q, stacked):
        if not ctx.sharded:
            return ps
        sp = specs[grp][q]
        sp = {n: t[1:] for n, t in sp.items()} if stacked else sp
        return L.use_params(ps, sp, tabs[grp][q], ctx)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_pat = [[] for _ in cfg.pattern]
    # one unbind per stacked leaf: its backward stacks the periods'
    # gradients once, where indexing ``t[p]`` would add a zero-filled
    # leaf-sized gradient per period
    pat = [{n: t.unbind(0) for n, t in tab.items()}
           for tab in params["pat"]]

    def period(x, p):
        a, rows = torch.zeros_like(aux), []
        for q, spec in enumerate(cfg.pattern):
            ps = use({n: t[p] for n, t in pat[q].items()}, "pat", q, True)
            cs = (None if caches is None else
                  {n: c[p] for n, c in caches["pat"][q].items()})
            x, nc, la = L.apply_layer(ps, x, ctx, cs, spec)
            a = a + la
            rows.append(nc)
        return x, a, rows

    for p in range(cfg.num_periods):
        if remat:
            x, a = checkpoint(lambda x, p=p: period(x, p)[:2], x,
                              use_reentrant=False)
            rows = [None] * len(cfg.pattern)
        else:
            x, a, rows = period(x, p)
        aux = aux + a
        for q, nc in enumerate(rows):
            new_pat[q].append(nc)
    new_rem = []
    for q, spec in enumerate(cfg.remainder):
        x, nc, a = L.apply_layer(use(params["rem"][q], "rem", q, False), x,
                                 ctx,
                                 None if caches is None
                                 else caches["rem"][q], spec)
        aux = aux + a
        new_rem.append(nc)
    return x, {"pat": new_pat, "rem": new_rem}, aux


def _head(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return L.lm_head_argmax(params["embed"], x[:, -1:], cfg)


def _next_tokens(params, x, cfg: ModelConfig, ctx: L.Ctx, specs,
                 embed) -> torch.Tensor:
    """``_head`` on one device; under a mesh the last row of the whole
    sequence (gathered from the shard that holds it) through the
    vocabulary-sharded head."""
    if not ctx.sharded:
        return _head(params, x, cfg)
    if ctx.mode != "decode":
        with in_mesh(ctx.dist):
            x = all_gather(x[:, -1:], ctx.seq_axis(), 1)
    x = L.rms_norm(x, _whole(params, specs, "final_norm", ctx)["scale"],
                   cfg.norm_eps)
    return L.lm_head_argmax(embed, x[:, -1:], ctx)


def _encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
            mode: str = "prefill", dist: Dist = None, specs=None):
    """Whisper's encoder over precomputed frame embeddings (b, s_enc, d):
    sinusoidal positions added, the ENC layers (bidirectional, no rope),
    then the encoder's final norm -> (b, s_enc, d).  In train mode each
    layer is rematerialised, as the reference's encoder stack is.  Under
    a mesh the frames are this rank's block (batch, frames over
    ``model``), the attention the non-causal ring."""
    dist = dist or Dist.local()
    b, s_enc, d = enc_embeds.shape
    ctx = L.Ctx(cfg=cfg, mode=mode, is_encoder=True, dist=dist)
    rows = sinusoidal_positions(
        s_enc * dist.size(ctx.seq_axis()) if dist.is_dist else s_enc, d,
        enc_embeds.dtype, enc_embeds.device)
    x = enc_embeds + rows[_positions(s_enc, ctx, rows.device)][None]
    enc = params["enc"]
    stack = {n: t.unbind(0) for n, t in enc["pat"][0].items()}
    tab = model_tables(cfg)["enc"]["pat"][0] if dist.is_dist else None

    def layer(x, p):
        ps = {n: t[p] for n, t in stack.items()}
        if dist.is_dist:
            ps = L.use_params(ps, {n: sp[1:] for n, sp in
                                   specs["enc"]["pat"][0].items()}, tab, ctx)
        return L.apply_layer(ps, x, ctx, None, ENC_SPEC)[0]
    for p in range(cfg.num_encoder_layers):
        x = (checkpoint(layer, x, p, use_reentrant=False)
             if mode == "train" else layer(x, p))
    norm = (_whole(enc, specs["enc"], "final_norm", ctx) if dist.is_dist
            else enc["final_norm"])
    return L.rms_norm(x, norm["scale"], cfg.norm_eps)


def _inputs_to_x(params, cfg: ModelConfig, ctx: L.Ctx, batch, embed=None):
    """The batch's ``embeds``, or its ``tokens``/``token`` embedded; a
    rope-free model adds sinusoidal positions: rows ``0..s-1`` at
    prefill (this rank's block of them under a mesh), the row at each
    decode position (int or ragged (b,))."""
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = L.embed_tokens(params["embed"] if embed is None else embed,
                           batch["tokens" if "tokens" in batch else "token"],
                           ctx)
    if cfg.rope_theta == 0:
        if ctx.mode == "decode":
            pos = torch.as_tensor(ctx.pos, device=x.device).reshape(-1)
            x = x + sinusoidal_rows(pos, cfg.d_model).to(x.dtype)[:, None]
        elif ctx.sharded:
            n = x.shape[1]
            rows = sinusoidal_positions(n * ctx.dist.size(ctx.seq_axis()),
                                        cfg.d_model, x.dtype, x.device)
            x = x + rows[_positions(n, ctx, x.device)][None]
        else:
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                         x.device)[None]
    return x


def n_moe_layers(cfg: ModelConfig) -> int:
    return (cfg.num_periods * sum(1 for sp in cfg.pattern if sp.ffn == MOE)
            + sum(1 for sp in cfg.remainder if sp.ffn == MOE))


def _setup(params, batch, cfg: ModelConfig, mode: str, dist: Dist,
           global_batch: int):
    """(params at this rank, their storage specs, the batch at this
    rank, the ``Ctx``) for one pass."""
    ctx = L.Ctx(cfg=cfg, mode=mode, dist=dist, batch_size=global_batch)
    if not dist.is_dist:
        return params, None, batch, ctx
    params, specs = _enter(params, dist)
    return params, specs, _local_batch(batch, ctx), ctx


def train_loss(params, batch, cfg: ModelConfig, remat: bool = True,
               dist: Dist = None):
    """The training loss of a batch of tensors: ``labels`` (b, s) with
    ``tokens`` (b, s) or ``embeds`` (b, s, d), and an encoder-decoder's
    ``enc_embeds`` (b, s_enc, d).  The stack in train mode (rope angles at
    positions ``0..s-1``, M-RoPE's three equal components), the final
    norm, ``lm_head_loss``, plus ``AUX_WEIGHT`` times the load-balance
    loss per MoE layer.  ``remat`` as the reference's (on).  Under a mesh
    every rank returns the whole loss."""
    dist = dist or Dist.local()
    params, specs, batch, ctx = _setup(params, batch, cfg, "train", dist,
                                       batch["labels"].shape[0])
    lab = batch["labels"]
    dev = lab.device
    ctx.memory = (_encode(params, cfg, batch["enc_embeds"], "train", dist,
                          specs) if cfg.enc_dec else None)
    ctx.angles = _angles(cfg, _positions(lab.shape[1], ctx, dev))
    embed = _embed_use(params, specs, ctx)
    x = _inputs_to_x(params, cfg, ctx, batch, embed)
    x = dist.constrain(x, *ctx.act_spec(), None)
    x, _, aux = _run_stack(params, x, ctx, None, cfg, remat=remat,
                           specs=specs)
    norm = _whole(params, specs, "final_norm", ctx)
    x = L.rms_norm(x, norm["scale"], cfg.norm_eps)
    loss = L.lm_head_loss(embed, x, lab, ctx)
    n_moe = n_moe_layers(cfg)
    if n_moe:
        loss = loss + AUX_WEIGHT * aux / n_moe
    return loss


def _slab(r, kind: str, seq: int, cache_len: int):
    """A layer's prefill rows laid into a zeroed ``cache_len`` slab along
    dim ``seq`` (a ``kv`` leaf); any other leaf as it is."""
    if kind != "kv":
        return r
    shape = list(r.shape)
    shape[seq] = cache_len
    out = r.new_zeros(shape)
    out.narrow(seq, 0, r.shape[seq]).copy_(r)
    return out


def prefill(params, batch, cfg: ModelConfig, cache_len: int,
            dist: Dist = None):
    """Process the prompt, ``batch["tokens"]`` (b, s) or
    ``batch["embeds"]`` (b, s, d), with an encoder-decoder's frames
    ``batch["enc_embeds"]`` (b, s_enc, d); returns (next_token (b,),
    caches): every global or MLA layer's rows laid into a zeroed
    ``cache_len`` slab, every sliding-window layer's rolling buffer and
    every CROSS layer's ``ck``/``cv`` as they are, at compute
    precision.  Under a mesh both come back as DTensors (the caches
    under ``cache_pspecs``)."""
    dist = dist or Dist.local()
    inp = batch["embeds" if "embeds" in batch else "tokens"]
    b, s = inp.shape[:2]
    params, specs, batch, ctx = _setup(params, batch, cfg, "prefill", dist,
                                       b)
    inp = batch["embeds" if "embeds" in batch else "tokens"]
    ctx.memory = (_encode(params, cfg, batch["enc_embeds"], "prefill",
                          dist, specs) if cfg.enc_dec else None)
    ctx.angles = _angles(cfg, _positions(inp.shape[1], ctx, inp.device))
    embed = _embed_use(params, specs, ctx)
    x = _inputs_to_x(params, cfg, ctx, batch, embed)
    x = dist.constrain(x, *ctx.act_spec(), None)
    x, rows, _ = _run_stack(params, x, ctx, None, cfg, specs=specs)
    _, kinds = cache_struct(cfg, b, cache_len)
    caches = {
        "pat": tuple({n: _slab(torch.stack([c[n] for c in per]), kd[n], 2,
                               cache_len)
                      for n in per[0]}
                     for per, kd in zip(rows["pat"], kinds["pat"])),
        "rem": tuple({n: _slab(r, kd[n], 1, cache_len) for n, r in t.items()}
                     for t, kd in zip(rows["rem"], kinds["rem"]))}
    tok = _next_tokens(params, x, cfg, ctx, specs, embed)
    if not dist.is_dist:
        return tok, caches
    return (dist.dtensor(tok, (ctx.dp,), (b,)),
            _cache_out(caches, cfg, ctx, b, cache_len, from_rows=True))


def _cache_specs(cfg: ModelConfig, ctx: L.Ctx, b: int, cache_len: int,
                 enc_len=None):
    from repro_torch.launch.sharding import cache_pspecs
    return cache_pspecs(cfg, ctx.dist, b, cache_len, enc_len)


def _cache_out(caches, cfg: ModelConfig, ctx: L.Ctx, b: int,
               cache_len: int, from_rows: bool = False):
    """Local cache leaves as DTensors under ``cache_pspecs``: prefill's
    rows (``from_rows``: the batch over the data axes, the rest whole)
    are cut to their blocks first."""
    dist = ctx.dist
    enc_len = _enc_len(caches)
    specs = _cache_specs(cfg, ctx, b, cache_len, enc_len)
    struct, _ = cache_struct(cfg, b, cache_len, enc_len)

    def one(t, spec, sd, stacked):
        if from_rows:
            lead = (None,) if stacked else ()
            src = lead + (ctx.dp,) + (None,) * (t.ndim - len(lead) - 1)
            t = _use(t, src, spec, dist)
        return dist.dtensor(t, spec, sd[0])
    return {grp: tuple({n: one(t[n], sp[n], st[n], grp == "pat")
                        for n in t}
                       for t, sp, st in zip(caches[grp], specs[grp],
                                            struct[grp]))
            for grp in ("pat", "rem")}


def _enc_len(caches):
    for grp in ("pat", "rem"):
        for t in caches[grp]:
            if "ck" in t:
                return t["ck"].shape[-3]
    return None


def decode_step(params, batch, caches, cfg: ModelConfig, dist: Dist = None):
    """One decode step.  batch: {"token": (b, 1) or "embeds": (b, 1, d),
    "pos": int or (b,) ragged positions}.  Writes each row's K/V at its
    position into ``caches`` in place, replaces each SSM layer's halo and
    state with the step's new ones (every row's, as the reference's),
    and returns (next_token (b,), caches).  A CROSS layer attends its
    cached encoder rows.  Under a mesh the caches are DTensors under
    ``cache_pspecs`` (their blocks written in place) or whole tensors,
    and both results come back as DTensors."""
    dist = dist or Dist.local()
    pos = batch["pos"]
    inp = batch["token" if "token" in batch else "embeds"]
    b = inp.shape[0]
    params, specs, batch, ctx = _setup(params, batch, cfg, "decode", dist, b)
    pos = batch["pos"]
    inp = batch["token" if "token" in batch else "embeds"]
    if dist.is_dist:
        cache_len = _cache_len(caches, cfg)
        cspecs = _cache_specs(cfg, ctx, b, cache_len, _enc_len(caches))
        caches = {grp: tuple({n: _local(t[n], sp[n], dist) for n in t}
                             for t, sp in zip(caches[grp], cspecs[grp]))
                  for grp in ("pat", "rem")}
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos[:, None]
    else:
        positions = torch.tensor([int(pos)], device=inp.device)
    ctx.angles, ctx.pos = _angles(cfg, positions), pos
    embed = _embed_use(params, specs, ctx)
    x = _inputs_to_x(params, cfg, ctx, batch, embed)
    x = dist.constrain(x, *ctx.act_spec(), None)
    x, rows, _ = _run_stack(params, x, ctx, caches, cfg, specs=specs)
    for q, spec in enumerate(cfg.pattern):
        if spec.mixer == SSM and cfg.num_periods:
            caches["pat"][q].update({n: torch.stack([r[n] for r in
                                                     rows["pat"][q]])
                                     for n in rows["pat"][q][0]})
    for q, spec in enumerate(cfg.remainder):
        if spec.mixer == SSM:
            caches["rem"][q].update(rows["rem"][q])
    tok = _next_tokens(params, x, cfg, ctx, specs, embed)
    if not dist.is_dist:
        return tok, caches
    return (dist.dtensor(tok, (ctx.dp,), (b,)),
            _cache_out(caches, cfg, ctx, b, cache_len))


def _cache_len(caches, cfg: ModelConfig) -> int:
    """The slab length of the caches' first ``kv`` leaf (the global one
    of a DTensor)."""
    _, kinds = cache_struct(cfg, 1, 1)
    for grp, seq in (("pat", 2), ("rem", 1)):
        for t, kd in zip(caches[grp], kinds[grp]):
            for n, kind in kd.items():
                if kind == "kv":
                    return t[n].shape[seq]
    return 1
