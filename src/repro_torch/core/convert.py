"""Load the JAX engines' parameters into the port's engines.

The JAX resident ``ServingEngine`` keeps one parameter tree
(``embed``, ``final_norm``, ``pat`` stacked over periods, ``rem``, and
an encoder-decoder's ``enc``);
taken out as numpy arrays it replaces the port ``ServingEngine``'s tree
leaf for leaf (``from_reference_resident``).  The JAX ``PipelinedLM``
keeps its embedding on the device and each unit's tensors merged on its
placement tier; the JAX
``OffloadedServingEngine`` keeps ``embed`` (``emb``, ``w_out``) and
``final_norm`` resident and each layer's tensors merged on its tier.
Taken out as numpy arrays (per unit key, name -> array, with
``name#q``/``name#s`` pairs for INT4 units), they re-merge here into
byte-identical buffers, so both engines compute on the same weights.

MoE layers: the offloaded engines keep each layer's router on the device
and each routed expert as a store buffer of its own (``exp[l][e]`` in
``PipelinedLM``, ``u[p][q]/exp[e]`` in serving), so the reference's
expert buffers re-merge under the same keys and its routers replace the
port's (``routers``); the resident tree carries the stacked ``(E, d,
f)``/``(E, f, d)`` experts, router and shared expert as table leaves.
``quant_roundtrip_params`` is the reference of the INT4 offloaded
engines: a resident tree whose streamed leaves went through the INT4
codec.

Training: ``from_reference_train_state`` carries the JAX training state
(parameters and the AdamW or Adafactor state, as numpy trees; bf16
leaves as ``ml_dtypes`` arrays) into the port's tensors leaf for leaf,
bf16 bytes reinterpreted rather than rounded.

Under a mesh both take ``mesh`` and ``specs`` (``launch.sharding``'s
spec trees) and return the trees placed as DTensors, each rank keeping
its block.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import MOE, ModelConfig
from repro_torch.core.transfer import int4_roundtrip
from repro_torch.device import resolve_device
from repro_torch.models.transformer import keeps_dtype


def _check_keys(units, keys):
    if sorted(units) != sorted(keys):
        raise ValueError(f"unit keys differ: got {sorted(units)}, the "
                         f"engine has {sorted(keys)}")


def lm_weights(lm):
    """A port ``PipelinedLM``'s weights as numpy arrays, in the form
    ``from_reference`` takes: (embedding, {store key: {name: array}},
    {layer: router})."""
    from repro_torch.core.transfer import split_views
    units = {}
    for key in lm.store_keys():
        if lm.placement == "host":
            buf = lm.host.get(key)
        elif lm.placement == "disk":
            buf = torch.from_numpy(lm.disk.get(key).reshape(-1))
        else:
            buf = lm.device.get(key)
        units[key] = {n: a.cpu().numpy().copy() for n, a in
                      split_views(buf, lm.weights.manifests[key]).items()}
    routers = {u.layer: lm.device.get(f"wg[{u.layer}]").cpu().numpy()
               for u in lm.units if u.kind == "moe"}
    return lm.device.get("emb").cpu().numpy(), units, routers


def from_reference(emb: np.ndarray, units: Dict[str, Dict[str, np.ndarray]],
                   lm, routers: Optional[Dict[int, np.ndarray]] = None
                   ) -> None:
    """Replace ``lm``'s embedding, routers and every store buffer's
    weights with the given arrays.  ``units`` must name exactly ``lm``'s
    store keys (its units' and, for MoE layers, its experts'), and
    ``routers`` every MoE layer's router."""
    _check_keys(units, lm.store_keys())
    cfg = lm.cfg
    if emb.shape != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embedding shape {emb.shape} != "
                         f"{(cfg.vocab_size, cfg.d_model)}")
    moe_layers = sorted(u.layer for u in lm.units if u.kind == "moe")
    if sorted(routers or {}) != moe_layers:
        raise ValueError(f"routers for layers {sorted(routers or {})}, "
                         f"the engine has MoE layers {moe_layers}")
    lm.device.put("emb", np.asarray(emb, np.float32))
    for layer in moe_layers:
        lm.device.put(f"wg[{layer}]", np.asarray(routers[layer], np.float32))
    for key in lm.store_keys():
        lm.weights.put(key, {name: np.asarray(a)
                             for name, a in units[key].items()})


def from_reference_serving(resident: Dict[str, Dict[str, np.ndarray]],
                           units: Dict[str, Dict[str, np.ndarray]],
                           eng, routers: Optional[Dict[str, np.ndarray]]
                           = None) -> None:
    """Replace a port ``OffloadedServingEngine``'s resident tensors
    (``{"embed": {...}, "final_norm": {...}}``), its MoE units' routers
    (``{unit key: (d, E)}``) and every store buffer's weights with the
    given arrays.  ``units`` must name exactly ``eng``'s unit and expert
    keys, and every resident tensor must keep its shape."""
    moe_units = [u for u in eng.units if u.moe]
    keys = [u.key for u in eng.units] + [k for u in moe_units
                                         for k in u.expert_keys]
    _check_keys(units, keys)
    if sorted(routers or {}) != sorted(u.key for u in moe_units):
        raise ValueError(f"routers for {sorted(routers or {})}, the engine "
                         f"has MoE units {[u.key for u in moe_units]}")
    for u in moe_units:
        arr = np.asarray(routers[u.key], np.float32)
        if arr.shape != tuple(u.router.shape):
            raise ValueError(f"{u.key} router: shape {arr.shape} != "
                             f"{tuple(u.router.shape)}")
        u.router = eng.device.put(f"{u.key}/wg", arr)
    for part, tab in eng.resident.items():
        if sorted(resident[part]) != sorted(tab):
            raise ValueError(f"{part}: got {sorted(resident[part])}, the "
                             f"engine has {sorted(tab)}")
        for name, old in tab.items():
            arr = np.asarray(resident[part][name], np.float32)
            if arr.shape != tuple(old.shape):
                raise ValueError(f"{part}/{name}: shape {arr.shape} != "
                                 f"{tuple(old.shape)}")
            tab[name] = eng.device.put(f"{part}/{name}", arr)
    for key in keys:
        eng.weights.put(key, {name: np.asarray(a)
                              for name, a in units[key].items()})


def from_reference_resident(params, eng=None, *, mesh=None, specs=None):
    """Replace a port ``ServingEngine``'s parameter tree with the JAX
    resident engine's (the same structure, numpy or array leaves; an
    encoder-decoder's ``enc`` subtree and its cross weights too).
    Every table must name the same tensors, each of the same shape.
    With ``mesh``: the JAX tree placed under ``specs`` (``param_pspecs``)
    as DTensors, returned (no engine is touched)."""
    if mesh is not None:
        from repro_torch.launch.sharding import place
        return place(_numpy_tree(params), specs, mesh)
    def tables(tree):
        enc = tree.get("enc")
        return ([("embed", tree["embed"]), ("final_norm", tree["final_norm"])]
                + [(f"{grp}[{q}]", t) for grp in ("pat", "rem")
                   for q, t in enumerate(tree[grp])]
                + ([] if enc is None else
                   [(f"enc/pat[{q}]", t) for q, t in enumerate(enc["pat"])]
                   + [("enc/final_norm", enc["final_norm"])]))
    mine, theirs = tables(eng.params), tables(params)
    if [k for k, _ in mine] != [k for k, _ in theirs]:
        raise ValueError(f"tables differ: got {[k for k, _ in theirs]}, "
                         f"the engine has {[k for k, _ in mine]}")
    for (key, tab), (_, ref) in zip(mine, theirs):
        if sorted(tab) != sorted(ref):
            raise ValueError(f"{key}: got {sorted(ref)}, the engine has "
                             f"{sorted(tab)}")
        for name, old in tab.items():
            arr = np.array(ref[name])
            if arr.shape != tuple(old.shape):
                raise ValueError(f"{key}/{name}: shape {arr.shape} != "
                                 f"{tuple(old.shape)}")
            old.copy_(torch.from_numpy(arr).to(old.dtype))


def quant_roundtrip_params(cfg: ModelConfig, params):
    """INT4 quantize->dequantize exactly the leaves the offloaded serving
    engine streams as INT4 — each layer's 2-D projections and each
    expert's slices — leaving the embedding, final norm and routers
    (device-resident, never streamed) as they are.  A resident engine on
    the result is the reference the INT4 offloaded engine must match
    token for token (numpy trees, or trees of tensors roundtripped on
    their device, in and out)."""
    def do_tab(tab, spec, stacked):
        out = {}
        for name, leaf in tab.items():
            arr = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            moe_stack = spec.ffn == MOE and name in ("w_gate", "w_up",
                                                     "w_down")
            if spec.ffn == MOE and name == "wg":
                out[name] = arr
            elif moe_stack or stacked:
                lead = arr.shape[:1 + (moe_stack and stacked)]
                flat = arr.reshape((-1,) + tuple(arr.shape[len(lead):]))
                stack = (torch.stack if isinstance(arr, torch.Tensor)
                         else np.stack)
                out[name] = stack([int4_roundtrip(a) for a in flat]
                                  ).reshape(arr.shape)
            else:
                out[name] = int4_roundtrip(arr)
        return out

    return {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "pat": tuple(do_tab(params["pat"][q], cfg.pattern[q], True)
                     for q in range(len(cfg.pattern))),
        "rem": tuple(do_tab(params["rem"][q], cfg.remainder[q], False)
                     for q in range(len(cfg.remainder))),
    }


def leaves_device(tree) -> torch.device:
    """The device of a placed tree's blocks."""
    from repro_torch.tree import leaves
    leaf = leaves(tree)[0]
    return leaf.to_local().device if hasattr(leaf, "to_local") \
        else leaf.device


def _tensor(arr, device) -> torch.Tensor:
    """One numpy leaf as a tensor on ``device`` with the same bytes: a
    bf16 (``ml_dtypes``) array is viewed as ``torch.bfloat16``, which
    numpy cannot name."""
    arr = np.array(arr, order="C")            # a copy; 0-d stays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return _tensor(tree, "cpu")


def from_reference_train_state(params, opt_state=None, device="cuda",
                               dtype=None, *, mesh=None, specs=None):
    """The JAX package's training state as the port's: ``params`` (its
    ``init_params`` tree) and ``opt_state`` (AdamW's ``{"m", "v",
    "step"}`` or Adafactor's ``{"s": {name: {"m", "vr", "vc" | "v"}},
    "step"}``, or None), numpy leaves, become tensors on ``device`` in
    the same structure.  Every leaf keeps its dtype, except that with
    ``dtype`` the parameters are cast to it (the SSM scalars stay f32
    and a resident INT4 table's ``#q``/``#s`` keep their uint8 and f32,
    as in the reference).  Returns (params, opt_state).  With ``mesh``
    (a ``DeviceMesh``) and ``specs`` ((parameter specs, optimizer-state
    specs), ``param_pspecs`` and ``zero_pspecs`` or ``adafactor_pspecs``)
    both come back placed on the mesh; ``device`` is then the mesh's."""
    if mesh is not None:
        from repro_torch.launch.sharding import place
        p, o = from_reference_train_state(params, opt_state, "cpu", dtype)
        p = place(p, specs[0], mesh)
        if o is None:
            return p, None
        step = o.pop("step")
        o = place(o, {k: v for k, v in specs[1].items() if k != "step"},
                  mesh)
        o["step"] = step.to(leaves_device(p))
        return p, o
    dev = resolve_device(device)

    def walk(t, cast, name=None):
        if isinstance(t, dict):
            return {k: walk(v, cast, k) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, cast, name) for v in t)
        out = _tensor(t, dev)
        if cast and dtype is not None and not keeps_dtype(name):
            out = out.to(dtype)
        return out
    return (walk(params, True),
            None if opt_state is None else walk(opt_state, False))
