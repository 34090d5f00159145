"""End-to-end serving driver on the PyTorch port: continuous batching over
a small model with batched requests, ragged decode, and KV offload at
slot granularity.  The flow, sizes and printed lines of
``examples/serve_offload.py``; the engine comes from the one declarative
path, EngineSpec -> resolve() -> create_engine.

  PYTHONPATH=src python examples/serve_offload_torch.py               # the card
  PYTHONPATH=src python examples/serve_offload_torch.py --device cpu  # the CPU

The plan resolves to the resident engine; on the card it launches
``flash_attention`` (each prefill) and ``decode_attention`` (each decode
step).  The printed tok/s is one run's, not a benchmark.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config, scaled_down
from repro_torch.serving.base import Request
from repro_torch.serving.spec import EngineSpec, create_engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = scaled_down(get_config("tinyllama-1.1b"), d_model=128,
                      num_heads=8, num_kv_heads=4, vocab_size=1024)
    spec = EngineSpec(arch="tinyllama-1.1b", cfg=cfg, b_max=4, max_len=128)
    plan = spec.resolve()             # placement/engine from the memory model
    print(f"resolved plan      : {plan.summary()}")
    eng = create_engine(plan, device=args.device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        prompt = rng.integers(0, cfg.vocab_size,
                              (8 + 4 * (i % 4),)).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=8 + (i % 5)))
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    dt = time.perf_counter() - t0

    total_new = sum(len(r.out) for r in done)
    ttfts = [r.t_first - r.t_submit for r in done]
    print(f"requests completed : {len(done)}/10")
    print(f"engine stats       : {eng.stats}")
    print(f"decode steps shared: {eng.stats['decode_steps']} "
          f"(vs {total_new} tokens -> "
          f"{total_new / max(1, eng.stats['decode_steps']):.2f} tok/step)")
    print(f"throughput         : {total_new / dt:.1f} tok/s")
    print(f"TTFT p50/p95       : {np.percentile(ttfts, 50):.2f}s / "
          f"{np.percentile(ttfts, 95):.2f}s")
    print(f"KV offloaded (host): {eng.host.bytes_used / 2**20:.1f} MiB")
    for r in done[:3]:
        print(f"  rid={r.rid} prompt_len={len(r.prompt)} out={r.out}")
    return {"plan": plan, "engine": plan.engine, "completed": len(done),
            "requests": len(reqs), "stats": dict(eng.stats),
            "tokens_out": total_new, "tok_s": total_new / dt,
            "ttft_p50_s": float(np.percentile(ttfts, 50)),
            "ttft_p95_s": float(np.percentile(ttfts, 95)),
            "host_kv_bytes": eng.host.bytes_used,
            "num_layers": cfg.num_layers,
            "outs": {r.rid: list(r.out) for r in done},
            "reqs": [(r.prompt, r.max_new) for r in reqs], "eng": eng}


if __name__ == "__main__":
    main()
