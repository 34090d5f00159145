"""Serving launcher for the port: continuous batching over a registry
arch on the card (the JAX package's ``launch/serve.py``).

The CLI is generated from the one flag<->field table in
``serving.spec.CLI_FLAGS``: flags build an ``EngineSpec``, ``resolve()``
materializes the plan against the memory budget, and
``create_engine(plan)`` dispatches to the resident or offloaded engine.

Resident weights (default):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 10

Offloaded weights through the PIPO pipeline, packed INT4 weights and KV,
the window re-sized between decode steps:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --offload --quant int4 --kv-mode int4 --depth-policy adaptive

Speculative decoding (a device-resident llama3.2-1b draft proposing 4
tokens per verify pass of the streamed Llama-3.1-8B; the stats line
counts spec_steps/spec_proposed/spec_accepted), and two pipeline stages:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \\
      --offload --quant int4 --draft-arch llama3.2-1b --spec-k 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b \\
      --offload --quant int4 --stages 2

The architectures the offloaded engine cannot stream resolve to the
resident engine: whisper (its encoder fed the zero-frame stub) and
qwen2-vl (token prompts, M-RoPE):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base

Plans are first-class: --plan-json resolves the spec and dumps the plan
(every auto field and why it got its value) WITHOUT building an engine;
--spec-json loads an EngineSpec JSON as the base (explicit flags still
override its fields):
  PYTHONPATH=src python -m repro_torch.launch.serve --scaled --offload \\
      --quant int4 --plan-json -

The engine runs on the card; ``--device cpu`` runs the plain PyTorch
versions on the host instead.
"""
import argparse
import json
import time

import numpy as np

from repro_torch.serving.spec import (EngineSpec, SpecError, add_spec_args,
                                      spec_from_args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="PIPO serving launcher (spec-driven: flags -> "
                    "EngineSpec -> ResolvedPlan -> create_engine)")
    add_spec_args(ap)                       # generated from CLI_FLAGS
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic request count for the demo workload")
    ap.add_argument("--spec-json", metavar="FILE",
                    help="load an EngineSpec JSON as the base "
                         "(explicitly-given flags override its fields)")
    ap.add_argument("--plan-json", nargs="?", const="-", metavar="FILE",
                    help="resolve and dump the plan JSON (stdout when no "
                         "FILE), then exit without serving — the plan "
                         "dry-run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engine computes (default: the card)")
    return ap


def main(argv=None):
    """Run the CLI; returns the engine it served with (shut down), or
    None for a plan dry-run."""
    ap = build_parser()
    args = ap.parse_args(argv)
    base = None
    try:
        if args.spec_json:
            with open(args.spec_json) as f:
                base = EngineSpec.from_json(f.read())
        spec = spec_from_args(args, base=base)
        plan = spec.resolve()
    except (SpecError, OSError, json.JSONDecodeError) as e:
        ap.error(str(e))
    if args.plan_json:
        payload = json.dumps(plan.to_json(), indent=2)
        if args.plan_json == "-":
            print(payload)
        else:
            with open(args.plan_json, "w") as f:
                f.write(payload + "\n")
            print(f"plan written to {args.plan_json}")
        return None

    from repro_torch.serving.base import Request
    from repro_torch.serving.spec import create_engine

    print(f"plan: {plan.summary()}")
    eng = create_engine(plan, device=args.device)
    cfg = eng.cfg
    offloaded = plan.engine == "offloaded"
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, (8 + i % 8,)).astype(np.int32),
            max_new=8))
    done = eng.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    print(f"completed={len(done)} tokens={total} tok_s={total / dt:.1f} "
          f"stats={eng.stats}")
    if offloaded:
        rep = eng.pipeline_report()
        busy = {k: f"{v['busy_s']:.2f}s" for k, v in rep["per_kind"].items()}
        print(f"pipeline[{plan.pipeline}] depth={eng.sched.depth} "
              f"compute_util={rep['compute_util']:.2f} "
              f"bubble_frac={rep['bubble_frac']:.2f} busy={busy}")
    eng.shutdown()
    return eng


if __name__ == "__main__":
    main()
