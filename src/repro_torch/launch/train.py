"""Training launcher (the JAX package's ``launch/train.py``):

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100 \\
      --seq 512 --batch 8 --ckpt <dir>

bf16 parameters (the reference's default) with AdamW's f32 moments, a
``DataPipeline`` over ``SyntheticSource``, and a ``TrainRunner`` that
checkpoints every 25 steps and at the last, in the JAX package's format,
and resumes from the newest checkpoint in ``--ckpt``.  The step updates
the state in place, as the reference's jitted step donates its inputs.
``--device`` is ``cuda`` by default; ``--scaled`` with ``--device cpu``
runs the reduced same-family config on the CPU.

The mesh follows the reference's rule over the ranks that run: (2, 16,
16) at 512 or more with ``--multi-pod``, (16, 16) at 256 or more, (n //
4, 4) at 8 or more, else none (one device, each rank on its own data
slice; ``--fake-devices`` below 8 trains in this one process, as the
reference's forced host devices then run on one device).  Under a mesh
every rank builds the whole batch and keeps its block; the parameters
go under ``param_pspecs`` and the moments under ``zero_pspecs``, and a
resume places the checkpoint under them whatever mesh wrote it.  One
process is one rank:

  * ``--fake-devices N`` (with ``--device cpu``) spawns N gloo CPU
    ranks, the counterpart of XLA's forced host devices (from 8, where
    the rule makes a mesh);
  * ``--coordinator host:port --num-hosts W --host-id R`` joins a
    process group of W ranks as rank R (NCCL on a card, gloo with
    ``--device cpu``), each started by its own command.

Rank 0 alone prints the ``devices=... mesh=...`` line and the closing
``done:`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fake-devices", type=int, default=0)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_train_ckpt"))
    ap.add_argument("--scaled", action="store_true",
                    help="reduced same-family config (CPU validation)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, init_params=None) -> dict:
    """Train, print the closing ``done:`` line and return the runner's
    result (rank 0's; with ``--fake-devices`` without the final state,
    which stays in the ranks).  ``init_params``: a parameter tree to
    start from in place of seed 0's draws (copied for each start, so the
    caller's tree is left as it was)."""
    args = parse_args(argv)
    if args.fake_devices:
        if args.device != "cpu":
            raise ValueError("--fake-devices spawns gloo CPU ranks: it "
                             "needs --device cpu")
        if mesh_shape(args.fake_devices, args.multi_pod) is None:
            return train(args, init_params, devices=args.fake_devices)
        from repro_torch.launch import ranks
        out_dir = tempfile.mkdtemp(prefix="repro_fake_")
        out_path = os.path.join(out_dir, "rank0.json")
        ranks.spawn(_rank, args.fake_devices, (args, init_params, out_path),
                    store_dir=out_dir)
        with open(out_path) as f:
            return json.load(f)
    if args.coordinator:
        from repro_torch.launch import ranks
        ranks.init(args.host_id, args.num_hosts,
                   init_method=f"tcp://{args.coordinator}",
                   device=args.device)
        try:
            return train(args, init_params)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    return train(args, init_params)


def _rank(rank: int, world: int, args, init_params, out_path: str):
    out = train(args, init_params)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({k: v for k, v in out.items()
                       if k not in ("params", "opt_state")}, f)


def mesh_shape(n: int, multi_pod: bool):
    """The reference's mesh rule over ``n`` devices: the mesh's shape, or
    None below 8."""
    if n >= 512 and multi_pod:
        return (2, 16, 16)
    if n >= 256:
        return (16, 16)
    if n >= 8:
        return (n // 4, 4)
    return None


def make_mesh(n: int, multi_pod: bool, device: str):
    """The mesh of ``mesh_shape`` over the ``n`` running ranks."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    shape = mesh_shape(n, multi_pod)
    if shape is None:
        return None
    if len(shape) == 3:
        return make_production_mesh(multi_pod=True, device=device)
    return make_test_mesh(model=shape[1], data=shape[0], device=device)


def train(args, init_params=None, devices=None) -> dict:
    """The training run of ``args`` in this process (rank ``r`` of the
    process group, if one is up).  ``devices``: the device count the
    ``devices=`` line reports, when it is not the world's (forced
    devices that run as one)."""
    import torch
    import torch.distributed as tdist

    from repro_torch.configs import get_config, scaled_down
    from repro_torch.data import DataConfig, DataPipeline, SyntheticSource
    from repro_torch.device import resolve_device
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import Dist, mesh_sizes
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner
    from repro_torch.tree import tree_map

    cfg = get_config(args.arch)
    if args.scaled:
        cfg = scaled_down(cfg)
    dev = resolve_device(args.device)
    grouped = tdist.is_available() and tdist.is_initialized()
    n = tdist.get_world_size() if grouped else 1
    rank0 = not grouped or tdist.get_rank() == 0
    mesh = make_mesh(n, args.multi_pod, args.device) if grouped else None
    dist = S.make_dist(mesh) if mesh is not None else Dist.local()
    if rank0:
        print(f"devices={devices or n} ({dev.type}) "
              f"mesh={mesh_sizes(mesh) if mesh is not None else None}")

    model = build_model(cfg)
    opt = AdamW()
    step_fn = make_train_step(model, dist, opt)
    shardings = None
    if mesh is not None:
        pspecs, ospecs = S.param_pspecs(cfg, dist), S.zero_pspecs(cfg, dist)
        opt_sh = S.named(mesh, ospecs)
        opt_sh["step"] = None                  # a plain replicated scalar
        shardings = (S.named(mesh, pspecs), opt_sh)

    def init_state():
        if init_params is None:
            params = model.init(0, device=dev, dtype=torch.bfloat16)
        else:
            params = tree_map(lambda t: t.detach().clone(), init_params)
        if mesh is None:
            return params, opt.init(params)
        params = S.place(params, pspecs, mesh)
        state = opt.init(params)
        for k in ("m", "v"):
            state[k] = S.redistribute(state[k], ospecs[k], mesh)
        return params, state

    if mesh is None:        # one device: this host's slice of the batch
        host, hosts = args.host_id, args.num_hosts
    else:                   # every rank the whole batch, kept in blocks
        host, hosts = 0, 1
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size, host_index=host,
                      host_count=hosts)
    data = DataPipeline(SyntheticSource(dcfg), dcfg)
    runner = TrainRunner(
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=25,
                     max_steps=args.steps),
        step_fn, init_state, data, shardings=shardings)
    out = runner.run()
    if rank0:
        last = f"{out['losses'][-1]:.4f}" if out["losses"] else "none"
        print(f"done: step={out['final_step']} last_loss={last} "
              f"timing={out['timing']}")
    return out


if __name__ == "__main__":
    main()
