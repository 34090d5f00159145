"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to CUDA.  A
CUDA request without a card raises: nothing falls back to the CPU unless
the caller asks for ``"cpu"`` (the tests do).  The slice computes in
full float32, so TF32 is switched off wherever the port runs on a card.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
