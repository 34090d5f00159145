"""Meshes (the JAX package's ``launch/mesh.py``) and pipeline-stage
placement.

One process (rank) per device: ``make_production_mesh`` and
``make_test_mesh`` build a ``DeviceMesh`` over the world that is running
(``torch.distributed`` initialized by the caller), whose named dims are
the JAX mesh's axes.  Single pod: (16, 16) = 256 ranks, ("data",
"model"); multi-pod: (2, 16, 16) = 512 ranks, ("pod", "data", "model"),
``pod`` an outer data-parallel axis.  ``AbstractMesh`` is a mesh's axis
names and sizes with no process group, on which the spec trees
(``launch.sharding``) are built without ranks.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh:
    """Axis names and sizes, no devices (``jax.sharding.AbstractMesh``):
    ``shape`` is ``{name: size}`` in mesh order."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"{shape} vs {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def _device_type(device) -> str:
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh over the running world of 256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION[multi_pod]
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_test_mesh(*, model: int = 4, data: int = 2, device="cuda"):
    """A (data, model) mesh over the running world of ``data * model``
    ranks (gloo CPU ranks in the tests, NCCL on cards)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), (data, model),
                            mesh_dim_names=("data", "model"))


def stage_devices(n_stages: int, device="cuda") -> List[torch.device]:
    """One device per pipeline-parallel stage: round-robin over the
    visible cards from ``device``'s (stage 0 on ``device``, stage ``s`` on
    card ``(index + s) % count``), or every stage on the CPU when the
    caller asks for it.  On one card every stage maps to that card and the
    activation handoff is a no-op."""
    dev = resolve_device(device)
    n = max(1, int(n_stages))
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", (dev.index + s) % count) for s in range(n)]
