"""Load the JAX engines' parameters into the port's engines.

The JAX resident ``ServingEngine`` keeps one parameter tree
(``embed``, ``final_norm``, ``pat`` stacked over periods, ``rem``);
taken out as numpy arrays it replaces the port ``ServingEngine``'s tree
leaf for leaf (``from_reference_resident``).  The JAX ``PipelinedLM``
keeps its embedding on the device and each unit's tensors merged on its
placement tier; the JAX
``OffloadedServingEngine`` keeps ``embed`` (``emb``, ``w_out``) and
``final_norm`` resident and each layer's tensors merged on its tier.
Taken out as numpy arrays (per unit key, name -> array, with
``name#q``/``name#s`` pairs for INT4 units), they re-merge here into
byte-identical buffers, so both engines compute on the same weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def from_reference(emb: np.ndarray, units: Dict[str, Dict[str, np.ndarray]],
                   lm) -> None:
    """Replace ``lm``'s embedding and every unit's weights with the given
    arrays.  ``units`` must name exactly ``lm``'s unit keys."""
    keys = [u.key for u in lm.units]
    if sorted(units) != sorted(keys):
        raise ValueError(f"unit keys differ: got {sorted(units)}, the "
                         f"engine has {sorted(keys)}")
    if emb.shape != lm.device.get("emb").shape:
        raise ValueError(f"embedding shape {emb.shape} != "
                         f"{tuple(lm.device.get('emb').shape)}")
    lm.device.put("emb", np.asarray(emb, np.float32))
    for key in keys:
        lm.weights.put(key, {name: np.asarray(a)
                             for name, a in units[key].items()})


def from_reference_serving(resident: Dict[str, Dict[str, np.ndarray]],
                           units: Dict[str, Dict[str, np.ndarray]],
                           eng) -> None:
    """Replace a port ``OffloadedServingEngine``'s resident tensors
    (``{"embed": {...}, "final_norm": {...}}``) and every unit's weights
    with the given arrays.  ``units`` must name exactly ``eng``'s unit
    keys, and every resident tensor must keep its shape."""
    keys = [u.key for u in eng.units]
    if sorted(units) != sorted(keys):
        raise ValueError(f"unit keys differ: got {sorted(units)}, the "
                         f"engine has {sorted(keys)}")
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


def from_reference_resident(params, eng) -> None:
    """Replace a port ``ServingEngine``'s parameter tree with the JAX
    resident engine's (the same structure, numpy or array leaves).
    Every table must name the same tensors, each of the same shape."""
    def tables(tree):
        return ([("embed", tree["embed"]), ("final_norm", tree["final_norm"])]
                + [(f"{grp}[{q}]", t) for grp in ("pat", "rem")
                   for q, t in enumerate(tree[grp])])
    mine, theirs = tables(eng.params), tables(params)
    if [k for k, _ in mine] != [k for k, _ in theirs]:
        raise ValueError(f"tables differ: got {[k for k, _ in theirs]}, "
                         f"the engine has {[k for k, _ in mine]}")
    for (key, tab), (_, ref) in zip(mine, theirs):
        if sorted(tab) != sorted(ref):
            raise ValueError(f"{key}: got {sorted(ref)}, the engine has "
                             f"{sorted(tab)}")
        for name, old in tab.items():
            arr = np.array(ref[name], np.float32)
            if arr.shape != tuple(old.shape):
                raise ValueError(f"{key}/{name}: shape {arr.shape} != "
                                 f"{tuple(old.shape)}")
            old.copy_(torch.from_numpy(arr))
