"""Quickstart on the PyTorch port: autoconfig -> pipelined offloaded
generation (the paper's Algorithm 2 workflow, end to end, on a
laptop-class budget).  The flow, sizes and printed lines of
``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py               # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the CPU

On the card the generation launches ``int4_matmul`` (every packed
projection), ``flash_attention`` (the prefill) and ``decode_attention``
(each decode step).  The printed tok/s is one run's, not a benchmark.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config, scaled_down
from repro_torch.core.autoconfig import configure
from repro_torch.core.offload import MemoryBudget
from repro_torch.serving.spec import EngineSpec, build_lm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. Pick a model and describe the hardware (paper laptop: 6GB VRAM,
    #    16GB DRAM, NVMe SSD).
    full_cfg = get_config("llama3.1-8b")
    budget = MemoryBudget()

    # 2. Automatic configuration (Eq. 1): weight placement + pipeline mode.
    ac = configure(full_cfg, batch=4, prompt_len=512, gen_len=32,
                   budget=budget, quant="int4")
    est = ac.est
    print("=== PIPO autoconfig (llama3.1-8b, RTX3060-class budget) ===")
    print(f" weights W (bf16)   : {est.weights / 2**30:6.1f} GiB"
          f"   (int4: {est.weights / 4 / 2**30:.1f} GiB)")
    print(f" kv cache C         : {est.kv_cache / 2**30:6.1f} GiB")
    print(f" peak M (prefill)   : {est.peak_prefill / 2**30:6.1f} GiB")
    print(f" placement          : {ac.weight_placement}  ({ac.reason})")
    print(f" pipeline           : {ac.pipeline}")
    print(f" int4 fused kernel  : {ac.use_int4_kernel}")

    # 3. Generate with a reduced same-family model, using the chosen
    #    placement/pipeline.
    cfg = scaled_down(full_cfg, d_model=256, num_heads=8, num_kv_heads=4,
                      d_ff=1024, vocab_size=2048)
    spec = EngineSpec(arch=full_cfg.name, cfg=cfg, offload=True,
                      placement=ac.weight_placement, pipeline=ac.pipeline,
                      b_max=2, max_len=96, depth=ac.preload_depth,
                      quant="int4" if ac.use_int4_kernel else None,
                      disk_root=os.path.join(tempfile.gettempdir(),
                                             "quickstart_torch_disk"))
    lm = build_lm(spec, device=args.device)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    toks, stats = lm.generate(prompt, gen_len=16)
    print("\n=== generation ===")
    print(f" tokens[0]       : {toks[0].tolist()}")
    print(f" throughput      : {stats['throughput_tok_s']:.1f} tok/s")
    print(f" TTFT            : {stats['ttft_s'] * 1e3:.0f} ms")
    print(f" compute busy    : {stats['compute_busy']:.0%}")
    print(f" device peak     : {stats['device_peak_gb']:.3f} GiB")
    return {"weights_gib": est.weights / 2**30,
            "kv_cache_gib": est.kv_cache / 2**30,
            "peak_prefill_gib": est.peak_prefill / 2**30,
            "placement": ac.weight_placement, "reason": ac.reason,
            "pipeline": ac.pipeline, "use_int4_kernel": ac.use_int4_kernel,
            "depth": ac.preload_depth, "plan": lm.plan,
            "num_layers": cfg.num_layers, "prompt": prompt, "tokens": toks,
            "lm": lm,
            "throughput_tok_s": stats["throughput_tok_s"],
            "ttft_s": stats["ttft_s"], "compute_busy": stats["compute_busy"],
            "device_peak_gb": stats["device_peak_gb"]}


if __name__ == "__main__":
    main()
