"""Load the JAX engine's parameters into a port ``PipelinedLM``.

The JAX ``PipelinedLM`` keeps its embedding on the device and each
unit's tensors merged on its placement tier.  Taken out as numpy arrays
(``emb`` and, per unit key, name -> array — ``name#q``/``name#s`` pairs
for INT4 units), they re-merge here into byte-identical buffers, so both
engines compute on the same weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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
