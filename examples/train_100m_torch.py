"""End-to-end training driver on the PyTorch port: ~100M-param llama-style
model, a few hundred steps on synthetic data with checkpoint/restart and
straggler stats.  The flow, sizes and printed lines of
``examples/train_100m.py``, built from the port's parts (``build_model``,
``Dist.local()``, ``AdamW`` with ``cosine_schedule``, ``DataPipeline``
over ``SyntheticSource``, ``TrainRunner`` with the step of
``launch/steps.py``).

  PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_100m_torch.py --device cpu \\
      --d-model 64 --layers 2 --seq 32 --batch 4 --steps 8

A run resumes from the newest checkpoint in ``--ckpt``.  Training
launches no hand-written kernel.  The printed tok/s is one run's, not a
benchmark.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig
from repro_torch.data import DataConfig, DataPipeline, SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import Dist
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.fault_tolerance import RunnerConfig, TrainRunner


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "train100m_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(
        name="lm-100m", num_layers=args.layers, d_model=args.d_model,
        num_heads=8, num_kv_heads=4, head_dim=args.d_model // 8,
        d_ff=4 * args.d_model, vocab_size=32000,
        pattern=(LayerSpec(ATTN, DENSE),))
    print(f"params: {cfg.param_count() / 1e6:.1f}M")

    m = build_model(cfg)
    dist = Dist.local()
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=20, total=args.steps),
                weight_decay=0.1)

    def init_state():
        params = m.init(0, device=dev, dtype=torch.bfloat16)
        return params, opt.init(params)

    step = make_train_step(m, dist, opt)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)
    data = DataPipeline(SyntheticSource(dcfg), dcfg)
    runner = TrainRunner(
        RunnerConfig(ckpt_dir=args.ckpt, ckpt_every=50,
                     max_steps=args.steps),
        step, init_state, data)

    t0 = time.time()
    out = runner.run()
    dt = time.time() - t0
    losses = out["losses"]
    toks = args.steps * args.batch * args.seq
    print(f"steps: {out['final_step']}  wall: {dt:.0f}s  "
          f"tok/s: {toks / dt:.0f}")
    print(f"loss: first={losses[0]:.3f} "
          f"mid={losses[len(losses) // 2]:.3f} last={losses[-1]:.3f}")
    print(f"timing: {out['timing']}")
    assert losses[-1] < losses[0], "training did not reduce loss"
    return {"params": cfg.param_count(), "final_step": out["final_step"],
            "losses": list(losses), "wall_s": dt, "tok_s": toks / dt,
            "timing": out["timing"]}


if __name__ == "__main__":
    main()
