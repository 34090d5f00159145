"""Training launcher (the JAX package's ``launch/train.py``), single
device:

  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100 \
      --seq 512 --batch 8 --ckpt <dir>

bf16 parameters (the reference's default) with AdamW's f32 moments, a
``DataPipeline`` over ``SyntheticSource`` sliced for ``--host-id`` of
``--num-hosts``, and a ``TrainRunner`` that checkpoints every 25 steps
and at the last, in the JAX package's format, and resumes from the
newest checkpoint in ``--ckpt``.  The step updates the state in place,
as the reference's jitted step donates its inputs.  ``--device`` is
``cuda`` by default; ``--scaled`` with ``--device cpu`` runs the reduced
same-family config on the CPU.  The mesh paths (``--multi-pod``,
``--coordinator``, ``--fake-devices``) wait for the sharding slice and
raise.
"""
from __future__ import annotations

import argparse
import os
import tempfile

MESH_FLAGS = ("multi_pod", "coordinator", "fake_devices")


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
    result.  ``init_params``: a parameter tree to start from in place of
    seed 0's draws (copied for each start, so the caller's tree is left
    as it was)."""
    args = parse_args(argv)
    asked = [f"--{f.replace('_', '-')}" for f in MESH_FLAGS
             if getattr(args, f)]
    if asked:
        raise NotImplementedError(
            f"{' '.join(asked)} needs a device mesh: the port trains on one "
            f"device, and the mesh, its shardings and the multi-host "
            f"runtime wait for the sharding slice (launch/sharding.py; "
            f"ROADMAP Queue 1 item 4b)")

    import torch

    from repro_torch.configs import get_config, scaled_down
    from repro_torch.data import DataConfig, DataPipeline, SyntheticSource
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner
    from repro_torch.tree import tree_map

    cfg = get_config(args.arch)
    if args.scaled:
        cfg = scaled_down(cfg)
    dev = resolve_device(args.device)
    print(f"devices=1 ({dev}) mesh=None")

    model = build_model(cfg)
    opt = AdamW()
    step_fn = make_train_step(model, opt)

    def init_state():
        if init_params is None:
            params = model.init(0, device=dev, dtype=torch.bfloat16)
        else:
            params = tree_map(lambda t: t.detach().clone(), init_params)
        return params, opt.init(params)

    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size,
                      host_index=args.host_id, host_count=args.num_hosts)
    data = DataPipeline(SyntheticSource(dcfg), dcfg)
    runner = TrainRunner(
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=25,
                     max_steps=args.steps),
        step_fn, init_state, data)
    out = runner.run()
    last = f"{out['losses'][-1]:.4f}" if out["losses"] else "none"
    print(f"done: step={out['final_step']} last_loss={last} "
          f"timing={out['timing']}")
    return out


if __name__ == "__main__":
    main()
