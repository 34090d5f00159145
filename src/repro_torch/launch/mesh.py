"""Device placement for pipeline-parallel stages (the JAX package's
``launch/mesh.py::stage_devices``; its production meshes come with the
sharding slice of the port)."""
from __future__ import annotations

from typing import List

import torch

from repro_torch.device import resolve_device


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
