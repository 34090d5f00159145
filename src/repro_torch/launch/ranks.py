"""Process groups for the mesh paths: one process (rank) per device.

``spawn`` starts ``world`` gloo CPU ranks with ``torch.multiprocessing``
(the ``spawn`` start method), the counterpart of XLA's forced host
devices (``--fake-devices``), each with one intra-op thread and joining
one process group through a ``FileStore`` (no port to pick, so
concurrent groups on one host do not collide).  ``init`` joins a group
whose ranks are started elsewhere (``--coordinator``): NCCL on a card,
gloo on the CPU.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import torch


def init(rank: int, world: int, *, init_method: str, device: str = "cuda"):
    """Join the process group of ``world`` ranks as ``rank``
    (``init_method``: ``tcp://host:port`` or ``file://path``); a card's
    rank takes card ``rank % count`` first."""
    import torch.distributed as dist
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)


def _entry(rank: int, fn: Callable, world: int, store: str, args: tuple):
    import torch.distributed as dist
    torch.set_num_threads(1)
    init(rank, world, init_method=f"file://{store}", device="cpu")
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          store_dir: Optional[str] = None, join: bool = True):
    """Run ``fn(rank, world, *args)`` on ``world`` fresh gloo CPU ranks
    (``fn`` a module-level function: the ranks import its module, not
    the caller's).  With ``join`` wait for every rank (an exception in
    one raises here); without, return the ``ProcessContext`` to
    ``join()`` (the caller works meanwhile)."""
    import torch.multiprocessing as mp
    store_dir = store_dir or tempfile.mkdtemp(prefix="repro_ranks_")
    store = os.path.join(store_dir, f"store_{os.getpid()}_{id(fn)}")
    if os.path.exists(store):
        os.remove(store)
    return mp.start_processes(_entry, args=(fn, world, store, tuple(args)),
                              nprocs=world, join=join, start_method="spawn")
