#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # everything (needs one H100-class card)
    python3 chip_smoke.py --only kernels  # build + kernel checks only
    python3 chip_smoke.py --only plan     # kernel checks, then runs (g)-(y)
    python3 chip_smoke.py --only moe      # kernel checks, then runs (o), (p)
    python3 chip_smoke.py --only families # kernel checks, then runs (q)-(s)
    python3 chip_smoke.py --only mla      # kernel checks, then run (t)
    python3 chip_smoke.py --only ssm      # kernel checks, then runs (u), (v)
    python3 chip_smoke.py --only frontends # kernel checks, then runs (w), (x)
    python3 chip_smoke.py --only train    # kernel checks, then run (y)
    python3 chip_smoke.py --only shard    # kernel checks, then run (z)
    python3 chip_smoke.py --only tooling  # kernel checks, then runs (aa)-(ac)
    python3 chip_smoke.py --only examples # kernel checks, then run (ad)

Phases, each synchronized before the next; any failure exits non-zero
before the result line:

1. report the card (``nvidia-smi`` name and power limit);
2. build the four kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (one process per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (batch generation and serving: ragged positions,
   bf16 caches, one slot's prefill) and at edge shapes, and each bf16
   instance (bf16 inputs read and the output written in-kernel) at run
   (aa)'s and the families' shapes, timed warm and cold; time kernel,
   plain version and one library call computing the same function
   (device time per call from a torch.profiler trace) and compute the
   roofline bound; the speculative runs' own shapes among them
   (``int4_matmul`` at M = b x (k+1) = 20, the llama3.2-1b draft's
   decode over its ``max_len`` slab and its one-slot prefills); the two
   decode kernels also give each row bit for bit alone, in the batch and
   over a longer slab, and ``decode_attention_int4`` without a fresh row
   at f32 equals ``decode_attention`` over the dequantized cache bit for
   bit;
4. run tinyllama-1.1b at full width and depth through
   ``build_lm(plan).generate``: (a) fp32 weights, (b) int4 fused,
   (c) int4 fused sequential, (d) int4 fused with ``kv_mode="int4"`` —
   ``REPEATS`` times each on one engine, every launch counter zeroed
   before and read after each run; medians, then one profiled run per
   configuration for the card's busy share; (c) and (d) load (b)'s
   packed weights (``core.convert.lm_weights``) instead of drawing them;
5. hold the whole path with kernels against ``use_kernels(False)`` on
   run (b)'s weights: final hidden states of a prefill and one decode
   step, and greedy-token agreement over run (b);
6. serve through ``create_engine(plan)``: (e) int4 weights and KV,
   ``SERVE_REQS`` (5) requests of ragged lengths on 4 slots (the fifth
   must enter a slot that a finished request freed while the others
   still decode), then the same requests again
   with a slot preempted mid-run (same tokens required), then kernels
   against ``use_kernels(False)`` on its weights; (f) bf16 caches
   (``kv_mode="fp32"``), 4 requests; (j) on tinyllama: (e)'s requests
   through the online engine (``sched="online"``, chunks of 32, INT4 KV:
   chunked prefill's final chunks take ``int4_matmul``'s small-M path),
   each prompt's last-position hidden state against a monolithic prefill
   (1e-4 x max) and the tokens against (e)'s;
7. (g) the paper's configuration, built only through the plan entry
   point: ``create_engine(EngineSpec(arch="llama3.1-8b",
   quant="int4").resolve())`` against the default ``MemoryBudget``
   (Llama-3.1-8B at full width and depth, 32 layers; depth-8 window),
   4 requests of ragged lengths, a short profiled serve for the card's
   busy share, then kernels against ``use_kernels(False)`` on its
   weights (final hidden states of a prefill within 1e-4 x max, of a
   decode step over the bf16 caches within 2e-2 x max, as run (e):
   the plain version rounds probabilities to bf16); peak device memory
   beside the plan's budget, the memory model's estimate and the
   engine's resident bytes (embedding and head), the host's RAM and the
   seconds spent drawing and packing the weights; then (k) a Poisson
   arrival trace of ``TRAFFIC_REQS`` (4) requests (prompts of 32-160
   tokens, 16 new each,
   at half of (g)'s completion rate) through (g)'s engine with
   ``run_trace`` (TTFT and TBT p50/p99, tok/s); then (j): the same plan
   with ``sched="online"`` (chunks of 32) on the same seed serves (g)'s
   requests (``flash_attention`` with ``q_offset > 0`` counted; hidden
   states and tokens against (g)'s, the logit margin at a first
   divergence; TTFT per request; the peak beside the budget, also at a
   3.5 GiB budget, which resolves to the same plan), and (k) through it;
8. (h) the CLI in-process: ``repro_torch.launch.serve.main`` serving
   llama3.2-1b offloaded with INT4 weights and KV and
   ``--depth-policy adaptive``, the depth chosen at each step printed;
9. (i) the resident engine: ``create_engine(EngineSpec(
   arch="tinyllama-1.1b").resolve())`` (full width and depth) serves run
   (e)'s requests, is profiled, is held against ``use_kernels(False)``
   (the tolerances of run (g)), and its tokens are compared with the
   offloaded engine's on the same weights (agreement printed; the first
   divergence, if any, with the resident model's logit margin there);
10. (l) replay (``core.replay``) of the traces recorded in (b), (c) and
   (g): the measured steady decode step beside the replay at the
   recorded knobs, in sequential mode and at depths 1-8; (b)'s predicted
   sequential step beside (c)'s measured one; ``resolve(trace=...)`` on
   (g)'s trace beside the memory model's depth;
11. speculative decoding and pipeline stages: (b') on (b)'s and (d)'s
   engines (no new build), a seeded random proposer (rejections) and an
   oracle from the run's own tokens (full acceptance), ``SPEC_K = 4``,
   tokens equal to the run's, then one verify step against
   ``use_kernels(False)`` (hidden states of all k+1 positions within
   1e-4 x max over f32 KV, 2e-2 x max over packed KV); (m)
   ``create_engine(EngineSpec(arch="llama3.1-8b", quant="int4",
   draft_arch="llama3.2-1b").resolve())``: (g)'s requests with the real
   device-resident draft, then an oracle from (g)'s streams on the same
   engine, tokens equal to (g)'s, the acceptance, step times, the
   draft's time per step, the verify pass's launches and the peak memory
   beside the budget, the memory model, the resident bytes and the
   draft's, and the verify step against ``use_kernels(False)`` (2e-2 x
   max, bf16 caches); (n) (g)'s spec with ``stages=2`` (two stages on
   one card), tokens equal to (g)'s, each stage's weight-load busy time
   and ``stage_bubbles``.  Phase 3 also
   times the verify pass's attention at (m)'s shapes
   (``spec_decode_attention``, plain and packed);
12. MoE: (o) ``create_engine(EngineSpec(arch="mixtral-8x7b",
   cfg=<depth cut to MOE_LAYERS = 2>, quant="int4",
   placement="disk").resolve())`` (Mixtral-8x7B at full width, 8
   experts, top-2; the whole model's plan: offloaded, disk, depth 1,
   with ``disk_root`` under the temporary directory, or a host budget
   when that disk is short) serves (g)'s 4 prompts, 3 new
   tokens each, routing each MoE layer's tokens and streaming only the
   routed experts: per step the experts each layer loaded (its routed
   union at a decode step), their bytes and the step's time; exact
   launch counts (``int4_matmul`` = 3 x the experts loaded + 4 x layers
   per pass, ``flash_attention`` = layers x prefills,
   ``decode_attention`` = layers x decode steps); the expert
   WEIGHT_LOAD bytes = the loads x each expert's bytes, below the bank's; the peak beside the budget, the
   memory model and the resident bytes (embedding, head, routers); the
   build's seconds and the process's peak RSS; then kernels against
   ``use_kernels(False)`` on the first prompt with the plain decode's
   probabilities kept f32 (every gate's top-k ids equal, prefill and
   decode hidden states within 1e-4 x max), beside the plain versions
   as they are (``moe_whole_path``); (p) ``build_lm`` on Mixtral at full width with its
   depth cut to 1 layer (``PipelinedLM`` draws from one generator, as
   the JAX engine does, so its build grows with depth), INT4 weights
   and KV, host, b 4, prompt 128, gen 16, performance and then
   sequential on the first engine's weights (``core.convert``): equal
   tokens, exact launch counts.  Phase 3 also holds and times
   ``int4_matmul`` at Mixtral's expert shapes (M 2, 19, 36 and 512);
13. the other families, each built only through the plan entry point at
   full width from seed 0, cut in depth (``GEMMA3_PERIODS``,
   ``QWEN3_LAYERS``): (q) ``create_engine(EngineSpec(
   arch="gemma3-4b", cfg=<16 of its 34 layers>, quant="int4",
   kv_mode="int4", max_len=2048).resolve())`` (Gemma3-4B: 13
   sliding-window layers of 1024 and 3 global, head_dim 256; offloaded,
   host, depth 1) serves
   prompts of 1500, 1016, 300 and 114 tokens, 16 new each (the window
   binds in the first prefill, the second wraps its rolling buffer in
   decode): exact launches (the local layers' decode over their rolling
   buffers through ``decode_attention``, the global layers' through
   ``decode_attention_int4``), the busy share, the peak beside the
   budget, the KV bytes per step (the rolling buffers move whole), then
   kernels against ``use_kernels(False)``; (r) ``create_engine(
   EngineSpec(arch="qwen3-8b", quant="int4").resolve())`` (Qwen3-8B,
   ``qk_norm``; offloaded, host, depth 8, bf16 caches) serves (g)'s
   requests, is held against ``use_kernels(False)``, then an oracle
   from its own streams on the same engine must give its tokens (the
   verify pass runs ``qk_norm`` on the card), with the verify step held
   at 2e-2 x max; (s) the resident engine on Gemma3-4B
   (``resolve(MemoryBudget(device=40 GiB, host=64 GiB))``) with its tree
   carried to the INT4 weights (``core.convert.quant_roundtrip_params``)
   serves (q)'s requests, its tokens compared with an fp-KV offloaded
   run on the same weights.  Phase 3 also holds and times the kernels
   at these shapes: ``flash_attention`` at head_dim 256 (the window of
   1024 over 1500 rows), ``decode_attention`` over the rolling buffers
   at the clamped positions against the reference's unclamped mask,
   ``decode_attention_int4`` at F = 1024, ``int4_matmul`` at M = 4 on
   both models' projections;
14. DeepSeek-V3's multi-head latent attention: (t) ``create_engine(
   EngineSpec(cfg=<deepseek-v3-671b cut to MLA_LAYERS = 1 layer, one
   period>, arch="deepseek-v3-671b", quant="int4").resolve())`` (full
   width: d 7168, 128 heads, q_lora 1536, kv_lora 512, nope 128, rope
   64, v 128, 256 experts of d_ff 2048, top-8, one shared expert, vocab
   129280; the default budget's plan: offloaded, host, depth 1, bf16
   caches) serves (g)'s 4 prompts, ``MLA_NEW`` (8) new tokens each: per
   decode step its ms, the weight bytes (MLA, shared expert, routed
   union), the unions and the latent KV bytes in and out; exact launch
   counts (``flash_attention`` = layers x prefills at head_dim 192,
   ``int4_matmul`` = 3 x the experts loaded + 7 x layers per pass, no
   decode kernel: the MLA decode is plain PyTorch, as the reference's
   jnp); the peak beside the budget, the memory model and the resident
   bytes; then the whole path as (o)'s, with ``flash_attention`` plain
   as the third reading (``int4_matmul`` alone).  Phase 3 also holds
   and times ``flash_attention`` at (t)'s prefill (128 heads of group
   1, dh 192 with V padded from 128), ``int4_matmul`` at its MLA and
   expert shapes, and times the plain MLA decode step beside SDPA;
15. the SSM: (u) ``create_engine(EngineSpec(arch="mamba2-1.3b",
   quant="int4", max_len=512, offload=True).resolve())`` (mamba2-1.3b
   at full width, 24 of its 48 layers; the default budget's
   plan without
   ``offload`` is resident, its provenance printed; offloaded, host,
   depth 8, ``fused_int4``) serves prompts of 400, 114, 93 and 58
   tokens, 16 new each, then again with a slot preempted (the same
   tokens); exact launches (``int4_matmul`` on the five SSM projections
   of every layer and pass, no attention kernel); the decode step's ms,
   weight bytes and state/halo bytes each way, busy time by kind, the
   peak beside the budget and the memory model; a prime 397-token
   prompt (chunk 1: one chunk a token) and the 400-token one prefilled
   alone; the whole path against ``use_kernels(False)`` (1e-4 x max at
   prefill; the decode over each arm's own bf16 halos at 2e-2 x max, and
   one decode step from the same halos and states at 1e-4 x max); then
   the resident engine on the same draws
   carried to the INT4 weights against the offloaded engine, both plain
   (the first two tokens equal; the agreement after them printed); (v)
   ``create_engine(EngineSpec(arch="jamba-1.5-large-398b", cfg=<its
   pattern's positions 2-4>, quant="int4", placement="host").resolve())``
   (jamba at full width: SSM+dense, SSM+MoE, attention+dense; the default
   budget's plan, disk, printed first) serves (g)'s prompts with 4 new
   tokens: exact launches (``flash_attention`` and ``decode_attention``
   at group 8, dh 128; ``int4_matmul`` with K up to 24576), per decode
   step its ms, weight and expert bytes and the routed union, the state
   bytes, the build's seconds and peak RSS, the peak beside the memory
   model's estimate and its parts, then the whole path as (o)'s.  Phase
   3 also holds and times ``int4_matmul`` at mamba2's projections (N
   down to 64) and jamba's (K 24576), flash and decode at group 8, dh
   128, and times the plain SSM functions (``ssd_decode_step``,
   ``ssd_chunked`` at chunk 200 and chunk 1, the causal conv) beside
   their bounds;
16. the two resident-engine frontends: (w) ``create_engine(EngineSpec(
   arch="whisper-base", max_len=448).resolve())`` (whisper-base at full
   width and depth: 6 encoder and 6 decoder layers, d 512, 8 heads of
   64, 1500 frames; resident by ``offload_capability``) serves six
   prompts of 4-48 tokens, 32 new each, the first with the zero-frame
   stub and five with seeded frames: exact launches (per prefill 6
   encoder, 6 self and 6 cross ``flash_attention``; per decode step 6
   self and 6 cross ``decode_attention``), then a rerun with a slot
   preempted (the same tokens), then the whole path against
   ``use_kernels(False)`` (the encoder's output and every prefill within
   1e-4 x max, the first decode step within 2e-2 x max, each request's
   first token equal); (x) qwen2-vl-72b at full width cut to 1 layer
   (resident: the embeds frontend) serves (g)'s prompts with 8 new
   tokens: the M-RoPE angles on the card bit-equal to 1-D rope, exact
   launches, the peak device memory beside the plan's budget and the
   memory model, then the whole path as (w)'s.  Phase 3 also holds and
   times ``flash_attention`` at ``causal=False`` over the encoder's
   1500 rows and the cross attention's 48 x 1500, and
   ``decode_attention`` at group 1 over 1500 encoder rows and the
   448-row slab;
17. single-device training: (y) ``repro_torch.launch.train.main``
   trains tinyllama-1.1b at full width and depth (1.10e9 parameters,
   bf16, AdamW's f32 moments, seq 512, batch 8) for 4 steps into a fresh
   checkpoint directory, drawing seed 0's weights itself while the
   script holds nothing on the card; then again to step 6 on the same
   directory, which resumes from step 4; then 6 steps uninterrupted
   into another directory from seed 0's draws, taken once more by the
   script and handed to ``main``.  Checks: the checkpoint
   restores bit-equal to the state it saved, steps 5-6 of the resumed
   run (and 1-4 of the first) equal the uninterrupted run's within 1e-3
   relative (the embedding backward's atomics are not deterministic),
   every loss finite and step 1's in (2, 12), and no kernel launched
   (training attends through plain PyTorch).  Prints the step ms (the
   first step apart), tokens/s, the model FLOPs a step (6 N tokens, the
   remat forward's 2 N tokens beside it) and their share of the card's
   bf16 dense peak, the first call's peak device memory (less what the
   script held) beside params + grads + moments, the checkpoint's bytes
   and its save and restore seconds;
18. the sharding slice: (z) opens a world-1 NCCL process group (a
   ``FileStore`` under the temporary directory) and a (1, 1) ("data",
   "model") ``DeviceMesh`` on the card, so every sharded branch runs its
   collective body over groups of one; trains tinyllama-1.1b at full
   width and depth from (y)'s seed-0 draws (bf16 parameters under
   ``param_pspecs``, AdamW moments under ``zero_pspecs``) for
   ``SHARD_STEPS`` steps of ``make_train_step(model, dist, opt)`` and the
   same steps with ``Dist.local()`` (losses within 1e-3, grad norms
   within 1e-2, relative); saves the mesh's parameters and restores them
   under ``Dist.local()`` bit-equal, and the reverse; serves 4 prompts of
   128 tokens and ``SHARD_NEW`` decode steps in f32 with the KV over
   ``model`` against the local path, which runs ``flash_attention`` and
   ``decode_attention`` (the sharded path runs the plain ring and
   partials): equal tokens, head inputs within ``SHARD_HIDDEN_TOL`` x
   max; then the five scaled archs of the JAX package's distributed
   check (granite-8b, gemma3-4b, deepseek-v3-671b, jamba-1.5-large-398b,
   mamba2-1.3b) on the same mesh against their local plain path (loss
   within 2e-4, grad norm within 1e-3, tokens equal), which puts the MoE,
   SSM and MLA islands on the card.  Prints step ms under the mesh and
   locally, the NCCL set-up seconds and the collectives a train step
   issues, beside the card (with ``--only shard`` also one profiled step
   each way: device ms, the card's busy share, host operators);
19. the tooling slice (``--only tooling`` runs the kernel checks and
   these): (aa) tinyllama-1.1b at full width and depth with resident
   INT4 tables (``quant_weights``, drawn as packed bytes from seed 0),
   ``make_prefill_step`` on 4 x 128 tokens then 16 ``make_decode_step``
   calls against ``use_kernels(False)`` (prefill hidden states within
   1e-4 x max, tokens equal, exact launches of ``int4_matmul``,
   ``flash_attention`` and ``decode_attention``), the roofline counter's
   count of one decode step on meta tensors (``roofline.analyze_step``:
   its bound on the H100's data-sheet rates, temp bytes, the INT4
   kernel's share of the bytes) beside its profiled device ms and the
   peak memory; then the kernels' bf16 instances on the same entry
   points (the ops cast nothing): one bf16 decode step, a
   bf16 prefill and 4 decode steps, and one step over the caches packed
   as INT4 KV rows, each against ``use_kernels(False)`` (head inputs
   within 2e-2 x max, tokens equal, exact launches of the bf16
   instances) with no ``aten::to`` made by the ops in its profile;
   (ab) the dry run's three modes
   (``launch.dryrun``): ``--serving --arch tinyllama-1.1b --scaled`` on
   the card, ``--replay`` of a golden trace and one production-mesh cell
   per mixer family in ``base`` and ``w4``, each held to its expected
   status; (ac) the transfer suite on the disk tier: a 1 GiB key read
   cold by ``naive_disk_to_host``, ``blockwise_disk_to_host`` and
   ``pipelined_disk_to_device`` (GB/s each), ``host_to_device``, then
   ``sweep_block_size`` over 1-64 MB;
20. (ad) the port's examples (``--only examples`` runs the kernel checks
   and this): ``examples/quickstart_torch.py``,
   ``serve_offload_torch.py`` and ``train_100m_torch.py`` through their
   ``main`` in this process on the card, each one's result on its own
   line and its launches asserted (quickstart: exact ``int4_matmul``,
   ``flash_attention`` and ``decode_attention`` from its plan; serve:
   10 of 10 requests, exact launches of its resident plan; train:
   ``EXAMPLE_TRAIN_STEPS`` steps, no launch, a falling loss); quickstart's
   and serve's engines against ``use_kernels(False)`` on their weights
   (``whole_path_check``, ``resident_whole_path``: prefill hidden states
   within 1e-4 x max, the first decode step's within 1e-4 (f32 caches)
   or 2e-2 (bf16) x max, first tokens equal); then an
   ``OffloadedServingEngine`` built through the legacy keywords against
   ``create_engine(EngineSpec(...))``: equal plan JSON, equal tokens,
   and its whole path against ``use_kernels(False)``
   (``serving_whole_path``); the examples' and this engine's kernel
   shapes (dh 16 at GQA group 2, INT4 K 64-1024) are rows of
   ``check_flash``, ``check_decode`` and ``check_int4``;
21. print the ``kernels`` JSON line, the card, then the result line.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ATTN_ATOL = 2e-5         # tests/test_kernels.py, fp32 attentions
BF16_ATOL = 2e-2         # tests/test_kernels.py, bf16 attention
INT4_RTOL = 1e-5         # tests/test_kernels.py, fp32 int4 matmul
HIDDEN_RTOL = 1e-4       # whole path: max|kernels - plain| / max|plain|
BF16_HIDDEN_RTOL = 2e-2  # the same over bf16 caches: the plain version
                         # rounds probabilities to bf16 as the reference
                         # does, the kernels keep them f32
# the depths below are cut to hold the 1200 s limit with runs (q)-(v)
# (PERF.md §4); generate calls per run
REPEATS = {"a": 1, "b": 1, "c": 1, "d": 1}
PROFILE_GEN = 8          # tokens in the profiled run (busy share only)
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:72",
    "decode_attention": "src/repro/kernels/decode_attention.py:76",
    "int4_matmul": "src/repro/kernels/int4_matmul.py:52",
    "decode_attention_int4": "src/repro/kernels/decode_attention.py:175",
}

# main path: tinyllama-1.1b, b=4, prompt 128, gen 32, max_len 256
B, PROMPT, GEN, MAX_LEN = 4, 128, 32, 256
PAPER_REQS, PAPER_NEW = 4, 16      # run (g): requests, new tokens each
CLI_ARGV = ["--arch", "llama3.2-1b", "--offload", "--quant", "int4",
            "--kv-mode", "int4", "--depth-policy", "adaptive",
            "--requests", "8"]     # run (h)
SERVE_POS = [159, 0, 77, 131]      # ragged serving positions, one per slot
SERVE_REQS = 5                     # serving run (e): requests, all submitted,
                                   # one more than its slots (PERF.md §4
                                   # lists the earlier counts)
SERVE_NEW = (8, 24)                # their new tokens, drawn in this range
TINY_CHUNK = 32                    # run (j) on tinyllama: OnlineSLO's chunk
TRAFFIC_REQS = 4                   # run (k): arrivals
SPEC_K = 4                         # runs (m), (b'): proposals per verify
MOE_LAYERS = 2                     # run (o): Mixtral's depth cut (disk
                                   # forced: the cut store fits the host;
                                   # PERF.md §4 lists the earlier depth)
MOE_NEW = 3                        # run (o): new tokens per request (a
                                   # decode step takes ~10 s)
# run (o)'s check: the share of routed rows whose top-k may differ
# between the kernel arm and the reference arm (readings at the
# reference's expert scale: 4 of 3,776 rows on (g)'s first prompt, 1 of
# 6,752 on its first two)
MOE_FLIP_SHARE = 0.005
MOE_LM_LAYERS, MOE_LM_GEN = 1, 16  # run (p): Mixtral's depth cut, gen
# Mixtral-8x7B's expert projections (K, N) and the rows one expert gets:
# the decode capacity int(1.25 * 4 * 2 / 8) + 1 = 2, the capacities of
# (g)'s shortest and longest prompts (58 and 114 tokens: 19 and 36), and
# run (p)'s prefill, where each expert runs on the batch (4 x 128)
MIXTRAL_EXPERT = ((4096, 14336), (14336, 4096))
MIXTRAL_M = (2, 19, 36, 512)
# runs (q)-(s): Gemma 3's and Qwen3's projections (K, N) at decode, M = 4
GEMMA3_PROJ = ((2560, 2048), (2560, 1024), (2560, 10240), (2048, 2560),
               (10240, 2560))
QWEN3_PROJ = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
# runs (q), (s): Gemma 3's prompts (the window of 1024 binds in the first
# prefill; the second wraps its buffer in decode), new tokens each
FAMILY_PROMPTS, FAMILY_NEW, FAMILY_MAX_LEN = (1500, 1016, 300, 114), 16, 2048
GEMMA3_WINDOW = 1024
# depth cuts, to hold the 1200 s limit with the bf16 checks
# (PERF.md §4): (q) and (s) Gemma3-4B at 2 periods plus its 4-layer
# remainder, 16 of 34 layers (13 sliding-window, 3 global); (r) Qwen3-8B
# at 12 of 36 layers; (u) mamba2-1.3b at 24 of 48
GEMMA3_PERIODS, QWEN3_LAYERS, MAMBA2_LAYERS = 2, 12, 24
# the rolling buffers' positions in the phase-3 check: (q)'s requests a
# few steps into decode, the first past the window, the second at its end
ROLL_POS = [1499, 1023, 299, 113]
# run (t): DeepSeek-V3 at full width, depth cut to one layer (one
# period; two until runs u and v needed the time), (g)'s prompts with
# MLA_NEW new tokens each
MLA_LAYERS, MLA_NEW = 1, 8
# DeepSeek-V3's packed projections (K, N): the MLA's wq_a, wq_b, wkv_a
# and wo, then the routed and shared experts' (d, f) and (f, d); all at
# decode (M = b_max = 4), the routed experts also at their capacities:
# int(1.25 * 4 * 8 / 256) + 1 = 1 at decode, 5 at (g)'s 114-token prompt
DEEPSEEK_MLA_PROJ = ((7168, 1536), (1536, 24576), (7168, 576),
                     (16384, 7168))
DEEPSEEK_EXPERT = ((7168, 2048), (2048, 7168))
DEEPSEEK_EXPERT_M = (1, 5)
# the MLA prefill's attention (run t's longest prompt) and the plain MLA
# decode step timed in phase 3 (run t's b_max and max_len): 128 heads
# over the latent (kv_lora 512, rope 64; nope 128, v 128)
MLA_SQ, MLA_B, MLA_S = 114, 4, 256
# run (u): mamba2-1.3b at full width (24 of 48 layers), INT4: 4 prompts
# (default_rng(0)) on 4 slots, SSM_NEW new tokens each; the 400-token
# prompt takes chunk 200 (two chunks: the inter-chunk recurrence runs),
# the others one chunk each; SSM_PRIME, a prime above the chunk of 256,
# takes chunk 1 (one chunk a token) and is timed alone
SSM_PROMPTS, SSM_NEW, SSM_MAX_LEN, SSM_PRIME = (400, 114, 93, 58), 16, 512, 397
# mamba2's packed projections (K, N): z_proj and x_proj, bc_proj,
# dt_proj (N/2 = 32 packed bytes), out_proj; at decode (M = 4) and at the
# longest prefill (M = 400)
MAMBA2_PROJ = ((2048, 4096), (2048, 256), (2048, 64), (4096, 2048))
MAMBA2_M = (4, 400)
# run (v): jamba-1.5-large at full width, its pattern's positions
# JAMBA_LAYERS (SSM+dense, SSM+MoE, attention+dense: every kind of layer
# it has, one MoE; PERF.md §4 lists the earlier cut), (g)'s prompts with
# JAMBA_NEW new tokens; its projections (K, N): the SSM's z/x_proj,
# bc_proj, dt_proj, out_proj, the attention's wq/wo and wk/wv, the dense
# FFN and experts' w_gate/w_up and w_down (K = 24576); M = 4 at decode,
# the experts at their capacities: int(1.25 * 4 * 2 / 16) + 1 = 1 at
# decode, 18 and 10 at (g)'s 114- and 58-token prefills; the
# dense w_down at a whole prompt (114)
JAMBA_LAYERS, JAMBA_NEW = (2, 3, 4), 4
JAMBA_PROJ = ((8192, 16384), (8192, 256), (8192, 128), (16384, 8192),
              (8192, 8192), (8192, 1024), (8192, 24576), (24576, 8192))
JAMBA_DOWN_M = (1, 10, 18, 114)
# run (w): whisper-base at full width and depth (6 encoder and 6 decoder
# layers, d 512, 8 heads of 64, 1500 frames) on the resident engine, at
# the decoder context of the published config (openai/whisper-base
# max_target_positions = 448); six prompts (default_rng(0)), the first
# with the zero-frame stub, the others with seeded frames; a slot is
# preempted after WHISPER_PREEMPT steps in the rerun
WHISPER_FRAMES, WHISPER_MAX_LEN = 1500, 448
WHISPER_PROMPTS, WHISPER_NEW, WHISPER_PREEMPT = (4, 8, 16, 24, 32, 48), 32, 6
# run (x): qwen2-vl-72b at full width, cut in depth only to QWEN2VL_LAYERS
# layers (the 80 layers at f32 are about 286 GB, more than the card
# holds; PERF.md §4 lists the earlier depth), (g)'s prompts at its
# vocabulary with QWEN2VL_NEW new tokens
QWEN2VL_LAYERS, QWEN2VL_NEW, QWEN2VL_MAX_LEN = 1, 8, 256
# run (y): tinyllama-1.1b training through launch.train.main: TRAIN_STEPS
# steps, then resumed to TRAIN_RESUME; losses held to TRAIN_RTOL between
# the resumed and the uninterrupted run; step 1's loss inside
# TRAIN_FIRST_LOSS (about ln 32000 = 10.37 at init)
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "tinyllama-1.1b", 512, 8
TRAIN_STEPS, TRAIN_RESUME, TRAIN_RTOL = 4, 6, 1e-3
TRAIN_FIRST_LOSS = (2.0, 12.0)
# run (z): the sharded path on a (1, 1) mesh of the one card: SHARD_STEPS
# train steps each way at (y)'s shapes, prompts of SHARD_PROMPT tokens
# with SHARD_NEW decode steps in f32 (cache SHARD_PROMPT + SHARD_NEW),
# the head's inputs held to SHARD_HIDDEN_TOL x max; the scaled archs as
# the JAX package's distributed check scales them
SHARD_STEPS, SHARD_PROMPT, SHARD_NEW, SHARD_HIDDEN_TOL = 3, 128, 8, 1e-4
SHARD_ARCHS = ("granite-8b", "gemma3-4b", "deepseek-v3-671b",
               "jamba-1.5-large-398b", "mamba2-1.3b")
SHARD_SCALE = dict(d_model=64, num_heads=4, num_kv_heads=4, vocab_size=256)
# run (aa): tinyllama-1.1b with resident INT4 tables, b W4_B x W4_PROMPT
# tokens into a W4_CACHE-row cache, then W4_STEPS decode steps
W4_B, W4_PROMPT, W4_CACHE, W4_STEPS = 4, 128, 256, 16
W4_BF16_STEPS = 4        # (aa)'s bf16 prefill arms: decode steps after it
# (aa)'s bf16 prefill before bf16 wgmma (an H100 80GB HBM3 at 700 W, the
# TF32 path): device ms, the tensor-core int4_matmul's ms of it, printed
# beside this run's
AA_PREFILL_BEFORE = (4.834, 2.794)
# run (ab): one production-mesh cell per mixer family all_cells runs,
# base and w4, and the status each must have; (ac): the disk tier's key
DRYRUN_CELLS = (("tinyllama-1.1b", "decode_32k"),
                ("deepseek-v3-671b", "decode_32k"),
                ("mamba2-1.3b", "long_500k"), ("whisper-base", "decode_32k"))
DRYRUN_EXPECT = {("whisper-base", "w4"): "error"}   # KeyError 'cwq'
LINK_KEY_BYTES = 1 << 30
# run (ad): the train example's steps in the phase (its default of 300
# took 42.6 s on the card, 112 ms a step: cut to hold the 1200 s limit;
# PERF.md §4) and the legacy-keyword engine's keywords
# (tests/test_spec.py's), with the new tokens of each of its requests
EXAMPLE_TRAIN_STEPS = 100
LEGACY_KW = dict(b_max=2, max_len=64, placement="host", quant="int4",
                 depth=2)
LEGACY_NEW = 8
BF16_PEAK = 989e12       # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
# calls a timed row averages for the microsecond kernels (decode, int4 at
# M <= 16) and their plain and library versions: each traced call costs
# the host far more than the card, and the checks' time grows with them
TIMING_ITERS = 20


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls
    (CUDA events after two warm-up calls): the device time, or the host's
    launch overhead where that is longer."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# where the profiler records no device events (some of the H100
# machines give a CUPTI trace with none in it, from the first trace of
# the process on), device times fall back to CUDA events on the stream;
# ``TIMER`` says which stands behind the printed numbers
TIMER = {"device": "cupti", "empty_traces": 0, "short_events": 0,
         "median_timed": 0}


def device_events(torch, fn, attempts: int = 3, names: bool = False):
    """(start, end) in µs of every kernel and copy ``fn()`` ran on the
    card, from a ``torch.profiler`` (CUPTI) trace (with ``names``, (start,
    end, name)).  A trace that comes back empty is taken again, up to
    ``attempts`` times (once, after a call that got none); then it
    returns ``[]``, and ``TIMER`` records that the callers time with CUDA
    events instead."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts if TIMER["device"] == "cupti" else 1):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [(e.time_range.start, e.time_range.end)
               + ((e.name,) if names else ())
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            TIMER["device"] = "cupti"
            return dev
        TIMER["empty_traces"] += 1
    if TIMER["device"] == "cupti":
        log(f"the profiler recorded no device events in {attempts} traces: "
            f"device times fall back to CUDA events on the stream (host "
            f"gaps between launches included) until a trace holds some")
    TIMER["device"] = "cuda events"
    return []


def device_ms(torch, fn, iters: int) -> float:
    """Mean device time per call of ``fn``: the durations of every kernel
    and copy it ran on the card over ``iters`` calls, summed and divided
    by ``iters`` (``call_ms`` where the trace holds none).  A trace can
    miss a few of a long run's events (one held 210 of 220 casts'
    launches), and the sum then reads low: where a kernel or copy (by
    name) has fewer events than its calls a call (its events over
    ``iters``, rounded, at least 1) times ``iters``, the time is instead
    each name's median duration times its calls a call, summed.
    ``TIMER["short_events"]`` adds up the events missed and
    ``TIMER["median_timed"]`` the times taken so."""
    fn()
    torch.cuda.synchronize()
    dev = device_events(torch, lambda: [fn() for _ in range(iters)],
                        names=True)
    if not dev:
        return call_ms(torch, fn, iters)
    by_name = {}
    for s_, e, name in dev:
        by_name.setdefault(name, []).append(e - s_)
    short, median = 0, 0.0
    for d in by_name.values():
        k = max(1, round(len(d) / iters))
        short += max(0, k * iters - len(d))
        median += statistics.median(d) * k
    if not short:
        return sum(e - s_ for s_, e, _ in dev) / iters / 1e3
    TIMER["short_events"] += short
    TIMER["median_timed"] += 1
    return median / 1e3


def busy_share(ivals) -> dict:
    """Union of device intervals over the span from the first start to
    the last end (None where the trace holds no device event)."""
    if not ivals:
        return {"device_busy_s": None, "device_span_s": None,
                "device_busy_share": None}
    busy, cur = 0.0, None
    for s, e in sorted(ivals):
        if cur is None or s > cur[1]:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0]
    span = max(e for _, e in ivals) - min(s for s, _ in ivals)
    return {"device_busy_s": busy / 1e6, "device_span_s": span / 1e6,
            "device_busy_share": busy / span}


def timings(torch, kernel, plain, library, iters: int) -> dict:
    short, median = TIMER["short_events"], TIMER["median_timed"]
    out = {"ms": device_ms(torch, kernel, iters),
           "plain_ms": device_ms(torch, plain, iters),
           "library_ms": device_ms(torch, library, iters),
           "call_ms": call_ms(torch, kernel, iters)}
    return {**out, "device_timer": TIMER["device"],
            "trace_events_short": TIMER["short_events"] - short,
            "median_timed": TIMER["median_timed"] - median}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_int4(torch, rng, dev):
    """``int4_matmul`` against its plain version (rtol 1e-5, atol 1e-5 *
    max|ref|), timed at every main-path shape: decode M = 4 (the kernels
    line's head: 2048x2048), batch prefill M = 512 and serving prefill
    M = 37 and 160, each at the four projection shapes; and at the
    prefill chunks of run (j): a full chunk M = 32 and the final chunks
    M = 18 (the 8B) and 13 (tinyllama), checked as well at M = 16 and 17
    on either side of the GEMV/tensor-core switch at the 8B's shapes; and
    at the speculative verify pass of runs (m) and (b'), M = b x (k+1) =
    20, on the 8B's and tinyllama's projections; at Mixtral's expert
    shapes (run o, p); at M = 4 on Gemma 3's and Qwen3's projections
    (runs q-s); and at DeepSeek-V3's MLA and expert projections (run t:
    M = 4, the experts also at their capacities M = 1 and 5); at
    mamba2's SSM projections (runs u: N 4096, 256 and 64, at M = 4 and
    the 400-token prefill) and jamba's (run v: M = 4, and ``w_down``'s
    K = 24576 at M = 1, 10, 18 and 114); checked (untimed) at run (ad)'s
    examples' and legacy engine's projections."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.int4_matmul import SMALL_M, int4_matmul, plain
    from repro_torch.quant.int4 import dequantize_int4, quantize_int4
    verify_m = B * (SPEC_K + 1)
    label = lambda M: f"{'verify ' if M == verify_m else ''}M={M}"
    shapes = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))
    cases = [(M, K, N, 128, True if (M, K, N) == (4, 2048, 2048) else
              f"{label(M)} {K}x{N}")
             for M in (4, 512, 37, 160, 13, TINY_CHUNK, verify_m)
             for K, N in shapes]
    # the Llama-3 projections: run (g)'s llama3.1-8b (d 4096, kv 1024,
    # d_ff 14336) at decode, at its longest prefill, at (j)'s chunks
    # of 18 and 32 rows and at (m)'s verify pass, run (h)'s
    # llama3.2-1b (d 2048, kv 512, d_ff 8192) at decode, and the 8B's
    # vocabulary head as if it were packed (K 4096, N 128256)
    l8 = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
    cases += [(M, K, N, 128, f"llama3.1-8b {label(M)} {K}x{N}")
              for M in (4, 128, 18, 32, verify_m) for K, N in l8]
    cases += [(M, K, N, 128, None) for M in (SMALL_M, SMALL_M + 1)
              for K, N in l8]
    cases += [(4, K, N, 128, f"llama3.2-1b M=4 {K}x{N}")
              for K, N in ((2048, 512), (2048, 8192), (8192, 2048))]
    cases += [(4, 4096, 128256, 128, None)]
    cases += [(M, K, N, 128, f"mixtral expert M={M} {K}x{N}")
              for M in MIXTRAL_M for K, N in MIXTRAL_EXPERT]
    # runs (q)-(s): Gemma 3's and Qwen3's projections at decode
    cases += [(4, K, N, 128, f"gemma3-4b M=4 {K}x{N}")
              for K, N in GEMMA3_PROJ]
    cases += [(4, K, N, 128, f"qwen3-8b M=4 {K}x{N}") for K, N in QWEN3_PROJ]
    # run (t): DeepSeek-V3's MLA and expert projections
    cases += [(4, K, N, 128, f"deepseek-v3 M=4 {K}x{N}")
              for K, N in DEEPSEEK_MLA_PROJ + DEEPSEEK_EXPERT]
    cases += [(M, K, N, 128, f"deepseek-v3 expert M={M} {K}x{N}")
              for M in DEEPSEEK_EXPERT_M for K, N in DEEPSEEK_EXPERT]
    # runs (u) and (v): mamba2's SSM projections (N down to 64) at decode
    # and at the 400-token prefill; jamba's at decode, and its w_down
    # (K = 24576) at the experts' capacities and a whole prompt
    cases += [(M, K, N, 128, f"mamba2 M={M} {K}x{N}")
              for M in MAMBA2_M for K, N in MAMBA2_PROJ]
    cases += [(4, K, N, 128, f"jamba M=4 {K}x{N}") for K, N in JAMBA_PROJ]
    cases += [(M, 24576, 8192, 128, f"jamba w_down M={M} 24576x8192")
              for M in JAMBA_DOWN_M]
    # run (ad): quickstart's projections (d 256, 8/4 heads of dh 16,
    # d_ff 1024) at decode (M 2) and its prefill (2 x 32), and the
    # legacy-keyword engine's (d 64, 4/2 heads, d_ff 128; K 64 at group
    # 64) at one slot's prefills of 12 and 21 and at decode (M 2, and 1)
    cases += [(M, K, N, 128, None) for M in (2, 64)
              for K, N in ((256, 64), (256, 128), (256, 256), (256, 1024),
                           (128, 256), (1024, 256))]
    cases += [(M, K, N, K, None) for M in (1, 2, 12, 21)
              for K, N in ((64, 32), (64, 64), (64, 128), (128, 64))]
    cases += [(17, 2048, 64, 128, None), (16, 8192, 128, 128, None),
              (3, 24576, 256, 128, None), (33, 24576, 64, 128, None)]
    cases += [(1, 2048, 2048, 128, None), (3, 384, 256, 32, None),
              (16, 512, 384, 128, None), (512, 384, 200, 32, None),
              (3, 96, 10, 32, None), (16, 64, 6, 32, None),
              (17, 5632, 5632, 128, None), (16, 5632, 256, 128, None)]
    rows = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    for M, K, N, G, main in cases:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((K, N), generator=gen, device=dev) * 0.05
        packed, scale = quantize_int4(w, G)
        out = int4_matmul(x, packed, scale, group=G)
        ref = plain(x, packed, scale, G)
        again = int4_matmul(x, packed, scale, group=G)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = INT4_RTOL * ref.abs() + INT4_RTOL * ref.abs().max()
        ok = bool(((out - ref).abs() <= tol).all())
        row = dict(shape=f"M={M} K={K} N={N} G={G}", max_abs_err=err,
                   err_over_max=err / ref.abs().max().item(),
                   deterministic=bool(torch.equal(out, again)),
                   ok=ok and bool(torch.equal(out, again)), main=main)
        if main:
            wd = dequantize_int4(packed, scale, torch.float32, G)
            row.update(timings(
                torch, lambda: int4_matmul(x, packed, scale, group=G),
                lambda: plain(x, packed, scale, G),
                lambda: torch.matmul(x, wd), TIMING_ITERS if M <= 16 else 10))
            c = cost.int4_matmul(M, K, N, G)
            row["bound_fp32_ms"] = cost.bound_ms(c.nbytes, c.flops)[0]
            # two TF32 terms on the tensor cores above SMALL_M
            row["bound_ms"], row["bound_by"], row["bound_rate"] = \
                cost.int4_matmul_bound(M, K, N, G)
        rows.append(row)
    return rows


def one_tile_plan(h: int, hkv: int):
    """``flash_attention``'s earlier block layout, the one-tile layout:
    the most of 4, 2, 1 heads that divides the group, one row tile of 16,
    no key split."""
    return next(w for w in (4, 2, 1) if (h // hkv) % w == 0), 1, 1


def flash_under(torch, q, k, v, kw, plan):
    """One launch of the flash kernel under ``plan`` = (wh, wr, splits),
    through the kernel's C entry point (``_build.launcher``), counted
    nowhere."""
    from repro_torch.kernels.flash_attention import _launch
    out = torch.empty_like(q)
    _launch(q, k, v, out, kw["causal"], kw["window"], kw["q_offset"], plan)
    return out


def flash_plan_fields(torch, q, k, v, kw, out, timed):
    """The plan ``flash_attention`` took for this row (heads x row tiles,
    key splits, blocks), and the same inputs under the one-tile layout: bit-equal
    where the plan has no key split (a row's arithmetic does not depend
    on the block layout), else the largest difference; on a timed row,
    also the one-tile layout's device ms."""
    from repro_torch.kernels.flash_attention import flash_plan
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    wh, wr, splits, blocks = flash_plan(
        b, sq, sk, h, hkv, kw["causal"], kw["window"], kw["q_offset"],
        dh=q.shape[3], itemsize=q.element_size(),
        n_sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
    old_plan = one_tile_plan(h, hkv)
    old = flash_under(torch, q, k, v, kw, old_plan)
    torch.cuda.synchronize()
    row = {"plan": {"wh": wh, "wr": wr, "splits": splits, "blocks": blocks,
                    "warps_per_block": wh * wr},
           "one_tile_plan": {"wh": old_plan[0], "wr": 1, "splits": 1}}
    if splits == 1:
        row["bit_equal_to_one_tile_plan"] = bool(torch.equal(out, old))
    else:
        row["err_vs_one_tile_plan"] = (out.float() - old.float()).abs().max().item()
    if timed:
        row["one_tile_plan_ms"] = device_ms(
            torch, lambda: flash_under(torch, q, k, v, kw, old_plan), 20)
    return row


def check_flash(torch, rng, dev):
    """``flash_attention`` against its plain version (atol 2e-5), two
    calls bit-equal; timed at the generation prefill shape (the kernels
    line's head), at serving prefill of one slot (b = 1, sq = 37 and
    141, run (e)'s shortest-but-one and longest prompts) and at the
    llama3.2-1b draft's prefills in run (m) (sq 114 and 58, its longest
    and shortest prompts) and at Gemma 3's (head_dim 256, the window of
    1024 over 1500 and 1016 rows, and 114 rows without one), each beside
    SDPA with the same mask, at jamba's (run v: group 8, dh 128) and at
    whisper's (run w: group 1, dh 64; the encoder and the cross
    attention's prefill at ``causal=False``); checked (untimed) at run
    (ad)'s prefills (dh 16, group 2); timed at a 32-row chunk over a
    1468-token prefix (a key split across a cluster).  Every row also runs
    under the earlier one-tile layout (``one_tile_plan``, through the
    kernel's C entry point) and must be bit-equal to it where the plan
    has no key split; timed rows time that layout too.  The bound counts three TF32
    products per multiply-add on the tensor cores (495 TFLOP/s) over the
    pairs the mask attends, ``bound_fp32_ms`` the same work at fp32."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import flash_attention, plain
    # (b, sq, sk, h, hkv, dh, causal, window, q_offset, timed as)
    cases = [(B, PROMPT, PROMPT, 32, 4, 64, True, 0, 0, True),
             (2, 77, 77, 8, 2, 32, True, 0, 0, None),
             (2, 45, 65, 8, 2, 32, True, 13, 20, None),
             (1, 50, 70, 4, 4, 16, False, 0, 0, None),
             (2, 33, 33, 4, 1, 128, True, 0, 0, None),
             (2, 100, 140, 32, 4, 64, True, 17, 40, None),
             # serving prefill: one slot, the prompt's own length
             (1, 37, 37, 32, 4, 64, True, 0, 0, "serving sq=37"),
             (1, 141, 141, 32, 4, 64, True, 0, 0, "serving sq=141"),
             # Llama-3: head_dim 128 and a GQA group of 4 (run g's
             # prefill, one slot), llama3.2-1b's dh 64 (run h)
             (1, 128, 128, 32, 8, 128, True, 0, 0, "llama3.1-8b sq=128"),
             (1, 37, 37, 32, 8, 128, True, 0, 0, None),
             (4, 128, 128, 32, 8, 128, True, 0, 0, None),
             (1, 15, 15, 32, 8, 64, True, 0, 0, "llama3.2-1b sq=15"),
             # run (m): the draft's prefill of one slot, (g)'s prompts
             (1, 114, 114, 32, 8, 64, True, 0, 0, "llama3.2-1b draft sq=114"),
             (1, 58, 58, 32, 8, 64, True, 0, 0, "llama3.2-1b draft sq=58"),
             # run (j)'s prefill chunks (chunk 32 of the 8B's 114-token
             # prompt): each chunk over the prefix held so far
             (1, 32, 64, 32, 8, 128, True, 0, 32,
              "llama3.1-8b chunk sq=32 q_offset=32"),
             (1, 32, 96, 32, 8, 128, True, 0, 64,
              "llama3.1-8b chunk sq=32 q_offset=64"),
             (1, 18, 114, 32, 8, 128, True, 0, 96,
              "llama3.1-8b final chunk sq=18 q_offset=96"),
             # runs (q) and (s): Gemma 3's one-slot prefills at head_dim
             # 256, 8/4 heads; the local layers' window of 1024 binds at
             # 1500 rows; an edge at 33 rows
             (1, 1500, 1500, 8, 4, 256, True, GEMMA3_WINDOW, 0,
              "gemma3-4b sq=1500 window=1024"),
             (1, 1016, 1016, 8, 4, 256, True, GEMMA3_WINDOW, 0,
              "gemma3-4b sq=1016 window=1024"),
             (1, 114, 114, 8, 4, 256, True, 0, 0, "gemma3-4b sq=114"),
             (1, 1500, 1500, 8, 4, 256, True, 0, 0, None),
             (2, 33, 33, 8, 4, 256, True, GEMMA3_WINDOW, 0, None),
             (2, 33, 33, 16, 4, 256, True, 0, 0, None),
             # run (v): jamba's attention layer, 64/8 heads (group 8) at
             # dh 128, one slot's prefill of (g)'s longest and shortest
             # prompts
             (1, 114, 114, 64, 8, 128, True, 0, 0, "jamba sq=114 group 8"),
             (1, 58, 58, 64, 8, 128, True, 0, 0, None),
             (2, 45, 45, 64, 8, 128, True, 0, 0, None),
             # run (w): whisper-base's encoder over its 1500 frames
             # (bidirectional), the cross attention's prefill of the
             # longest prompt over them, and the decoder's causal
             # prefill: 8/8 heads (group 1) at dh 64
             (1, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, False, 0, 0,
              "whisper encoder sq=sk=1500"),
             (1, 48, WHISPER_FRAMES, 8, 8, 64, False, 0, 0,
              "whisper cross prefill sq=48 sk=1500"),
             (1, 48, 48, 8, 8, 64, True, 0, 0, "whisper decoder sq=48"),
             # a short prefill chunk over a long prefix (a key split)
             (1, 32, 1500, 32, 8, 128, True, 0, 1468,
              "llama3.1-8b chunk sq=32 q_offset=1468"),
             (2, 40, 400, 4, 4, 64, True, 200, 360, None),
             (1, 20, 600, 8, 4, 256, True, 0, 580, None),
             (2, 37, 1500, 8, 8, 64, False, 0, 0, None),
             (1, 5, 24, 8, 8, 64, False, 0, 0, None),
             # run (ad): quickstart's prefill (2 x 32, 8/4 heads of dh
             # 16), the serve example's one-slot prefills (8-20 rows) and
             # the legacy-keyword engine's (4/2 heads, 12 and 21 rows)
             (2, 32, 32, 8, 4, 16, True, 0, 0, None),
             (1, 8, 8, 8, 4, 16, True, 0, 0, None),
             (1, 12, 12, 8, 4, 16, True, 0, 0, None),
             (1, 16, 16, 8, 4, 16, True, 0, 0, None),
             (1, 20, 20, 8, 4, 16, True, 0, 0, None),
             (1, 12, 12, 4, 2, 16, True, 0, 0, None),
             (1, 21, 21, 4, 2, 16, True, 0, 0, None)]
    rows = []
    for b, sq, sk, h, hkv, dh, causal, window, q_offset, timed in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q, k, v = mk(b, sq, h, dh), mk(b, sk, hkv, dh), mk(b, sk, hkv, dh)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        ref = plain(q, k, v, **kw)
        again = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        row = dict(shape=f"b={b} sq={sq} sk={sk} h={h} hkv={hkv} dh={dh} "
                   f"causal={causal} window={window} q_offset={q_offset}",
                   max_abs_err=err, deterministic=same, main=timed,
                   **flash_plan_fields(torch, q, k, v, kw, out, timed))
        row["ok"] = (err <= ATTN_ATOL and same
                     and row.get("bit_equal_to_one_tile_plan", True))
        if timed:
            (qt, kt, vt, mask), sdpa = _sdpa_args(torch, q, k, v, causal,
                                                  window, q_offset)
            row.update(timings(
                torch, lambda: flash_attention(q, k, v, **kw),
                lambda: plain(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, **sdpa), 20))
            work = (b, sq, sk, h, hkv, dh, causal, window, q_offset)
            c = cost.flash_attention(*work)
            row["bound_ms"], row["bound_by"], row["bound_rate"] = \
                cost.flash_attention_bound(*work)
            row["bound_fp32_ms"] = cost.bound_ms(c.nbytes, c.flops)[0]
        rows.append(row)
    return rows


def _sdpa_decode(torch, q, kc, vc, pos_t):
    """One ``scaled_dot_product_attention`` call computing the decode
    step: q (b, h, dh), caches (b, S, hkv, dh), row r attending
    positions <= pos[r] (the library yardstick; the port never calls
    it)."""
    args = _sdpa_decode_args(torch, q, kc, vc, pos_t)
    return lambda: _sdpa_decode_call(*args)


def _sdpa_decode_args(torch, q, kc, vc, pos_t):
    """``scaled_dot_product_attention``'s inputs for a decode step: q (b,
    h, 1, dh), caches (b, hkv, S, dh), row r attending positions <=
    pos[r]."""
    S = kc.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :]
            <= pos_t[:, None].long())[:, None, None]
    return (q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), mask)


def _sdpa_decode_call(a, b, c, m):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(a, b, c, attn_mask=m,
                                          enable_gqa=True)


def row_independent(torch, out, call, per_row, slab_args, b: int) -> bool:
    """The decode kernels' row contract on the card: each row's output
    alone (a batch of one: ``call(*per_row(r))``) and the batch's over a
    slab lengthened past every row's positions (``call(*slab_args)``,
    rows of other values) ``torch.equal`` to the batch's ``out``."""
    alone = all(torch.equal(out[r:r + 1], call(*per_row(r)))
                for r in range(b))
    return alone and torch.equal(out, call(*slab_args))


def longer(torch, t, extra: int = 37):
    """``t`` (b, S, ...) with ``extra`` more rows of other values along
    S (its own rows reversed)."""
    return torch.cat([t, t.flip(1)[:, :extra]], 1).contiguous()


def check_decode(torch, rng, dev):
    """``decode_attention`` against its plain version (atol 2e-5 at f32,
    2e-2 over bf16 caches), two calls bit-equal, each row bit-equal alone,
    in the batch and over a longer slab (``row_independent``), and the
    same result for an int ``pos`` and a strided ``q`` where the case has
    them; timed warm and cold (``cold_ms``) at
    the generation shape (f32), the serving shape (bf16, ragged pos) and
    the llama3.2-1b draft's proposal steps in run (m) (its bf16 caches
    over the whole ``max_len`` slab, dh 64, group 4), Gemma 3's global
    slab (head_dim 256), jamba's attention layer (group 8, dh 128, run
    v), whisper's cross attention over its 1500 encoder rows and its
    448-row self-attention slab (group 1, run w) and Gemma 3's rolling
    buffers (``check_rolling_decode``) beside SDPA; checked (untimed) at
    run (ad)'s decode steps (dh 16, group 2)."""
    from repro_torch.core.kvstore import KV_LEN_BUCKET
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention import decode_attention, plain
    last = PROMPT + GEN - 2            # the last decode step's position
    S = -(-(last + 1) // KV_LEN_BUCKET) * KV_LEN_BUCKET
    # (b, S, h, hkv, dh, pos, cache dtype, timed as)
    cases = [(B, S, 32, 4, 64, [last] * B, torch.float32, "f32"),
             (B, S, 32, 4, 64, [0, 37, S - 1, 100], torch.float32, None),
             (B, 100, 32, 4, 64, [0, 50, 99, 77], torch.float32, None),
             (3, 77, 8, 2, 32, [76, 0, 40], torch.float32, None),
             (2, 64, 4, 4, 16, [63, 5], torch.float32, None),
             (2, 300, 8, 8, 128, [299, 3], torch.float32, None),
             (B, 1024, 32, 4, 64, [1023, 700, 0, 64], torch.float32, None),
             (B, S, 32, 4, 64, [0, 0, 0, 0], torch.float32, None),
             # serving with kv_mode="fp32": bf16 caches, ragged positions
             (B, S, 32, 4, 64, SERVE_POS, torch.bfloat16, "bf16"),
             (B, 100, 32, 4, 64, [0, 50, 99, 77], torch.bfloat16, None),
             (3, 77, 8, 2, 32, [76, 0, 40], torch.bfloat16, None),
             (2, 33, 32, 32, 16, [32, 0], torch.bfloat16, None),
             # Llama-3.1-8B serving (run g): dh 128, group 4, bf16 caches
             (B, S, 32, 8, 128, SERVE_POS, torch.bfloat16,
              "llama3.1-8b bf16"),
             (B, S, 32, 8, 128, [last] * B, torch.float32, None),
             # the resident engine (run i): the whole max_len slab
             (B, MAX_LEN, 32, 4, 64, SERVE_POS, torch.bfloat16,
              "resident S=256"),
             # run (m)'s draft: (g)'s prompts a few proposals in, over
             # the draft's own slab of the plan's max_len (256)
             (B, MAX_LEN, 32, 8, 64, [118, 97, 85, 62], torch.bfloat16,
              "llama3.2-1b draft S=256"),
             (B, MAX_LEN, 32, 8, 64, [129, 108, 96, 73], torch.bfloat16,
              None),
             # run (q): Gemma 3's global layers over the bucketed slab
             # (head_dim 256, group 2), the longest prompt 16 steps in
             (B, 1536, 8, 4, 256, [1515, 1031, 315, 129], torch.bfloat16,
              "gemma3-4b global bf16"),
             (B, 2048, 8, 4, 256, [2047, 0, 700, 1024], torch.float32, None),
             # run (v): jamba's attention layer (64/8 heads, group 8, dh
             # 128) over bf16 caches, (g)'s prompts a few steps in
             (B, 128, 64, 8, 128, [116, 95, 83, 60], torch.bfloat16,
              "jamba group 8 bf16"),
             (B, 256, 64, 8, 128, [255, 0, 130, 64], torch.float32, None),
             # run (w): whisper's cross attention over every one of its
             # 1500 encoder rows (an int pos of 1499) and its decoder's
             # self-attention over the 448-row slab, ragged (the first
             # four requests 16 steps in): group 1, dh 64, bf16 caches
             (B, WHISPER_FRAMES, 8, 8, 64, [WHISPER_FRAMES - 1] * B,
              torch.bfloat16, "whisper cross S=1500"),
             (B, WHISPER_MAX_LEN, 8, 8, 64, [19, 23, 31, 39],
              torch.bfloat16, "whisper self S=448"),
             (B, WHISPER_MAX_LEN, 8, 8, 64, [447, 0, 200, 31],
              torch.bfloat16, None),
             # run (ad): quickstart's decode (b 2, 8/4 heads of dh 16, f32
             # caches over 64 rows, an int pos of 32-46), the serve
             # example's (b 4 over the resident 128-row bf16 slab, ragged,
             # idle slots at 0) and the legacy-keyword engine's (b 2, 4/2
             # heads, 32 rows), each also in the other cache type
             (2, 64, 8, 4, 16, [46, 46], torch.float32, None),
             (2, 64, 8, 4, 16, [32, 32], torch.float32, None),
             (2, 64, 8, 4, 16, [46, 33], torch.bfloat16, None),
             (4, 128, 8, 4, 16, [0, 11, 13, 28], torch.bfloat16, None),
             (4, 128, 8, 4, 16, [18, 10, 12, 27], torch.bfloat16, None),
             (4, 128, 8, 4, 16, [127, 0, 64, 19], torch.float32, None),
             (2, 32, 4, 2, 16, [18, 27], torch.bfloat16, None),
             (2, 32, 4, 2, 16, [31, 12], torch.float32, None)]
    rows = []
    for b, S_, h, hkv, dh, pos, cdt, timed in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q, kc, vc = (mk(b, h, dh), mk(b, S_, hkv, dh).to(cdt),
                     mk(b, S_, hkv, dh).to(cdt))
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = decode_attention(q, kc, vc, pos_t)
        ref = plain(q, kc, vc, pos_t)
        same = torch.equal(out, decode_attention(q, kc, vc, pos_t))
        if len(set(pos)) == 1:         # an int pos, q as a strided view
            qv = mk(b, 1, h + 2, dh)[:, 0, 1:h + 1]
            qv.copy_(q)
            same &= torch.equal(out, decode_attention(qv, kc, vc, pos[0]))
        rows_ok = row_independent(
            torch, out, decode_attention,
            lambda r: (q[r:r + 1], kc[r:r + 1], vc[r:r + 1],
                       pos_t[r:r + 1]),
            (q, longer(torch, kc), longer(torch, vc), pos_t), b)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = ATTN_ATOL if cdt == torch.float32 else BF16_ATOL
        row = dict(shape=f"b={b} S={S_} h={h} hkv={hkv} dh={dh} pos={pos} "
                   f"cache={str(cdt)[6:]}", max_abs_err=err, tol=tol,
                   deterministic=bool(same), row_independent=rows_ok,
                   ok=err <= tol and bool(same) and rows_ok, main=timed)
        if timed:
            row.update(timings(
                torch, lambda: decode_attention(q, kc, vc, pos_t),
                lambda: plain(q, kc, vc, pos_t),
                _sdpa_decode(torch, q, kc.float(), vc.float(), pos_t),
                TIMING_ITERS))
            row["cold_ms"] = cold_ms(torch, decode_attention,
                                     (q, kc, vc, pos_t))
            row["library_cold_ms"] = cold_ms(
                torch, _sdpa_decode_call,
                _sdpa_decode_args(torch, q, kc.float(), vc.float(), pos_t))
            c = cost.decode_attention(b, h, hkv, dh,
                                      sum(p + 1 for p in pos),
                                      kc.element_size())
            row["bound_ms"], row["bound_by"] = cost.bound_ms(c.nbytes,
                                                             c.flops)
        rows.append(row)
    rows.append(check_rolling_decode(torch, rng, dev))
    return rows


def check_rolling_decode(torch, rng, dev):
    """Run (q)'s rolling-buffer decode step: Gemma 3's local layers
    (b 4, W = 1024, 8/4 heads, head_dim 256, bf16 buffers) at ragged
    positions past, at and below the window (``ROLL_POS``), through
    ``decode_attention`` at the positions clamped to W - 1 (what
    ``local_decode_attention`` launches), held against the reference's
    rolling-buffer attention over the unclamped slots (slot j attended
    when ``pos - ((pos - j) mod W) >= 0``; atol 2e-2 over bf16), each
    row bit-equal alone and over a longer buffer, and timed warm and cold
    beside SDPA with that mask.  The bound reads the attended slots
    once."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import attn_partials
    from repro_torch.models.common import finalize_partials
    b, W, h, hkv, dh = B, GEMMA3_WINDOW, 8, 4, 256
    mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                 dtype=torch.float32, device=dev)
    q = mk(b, h, dh)
    kc, vc = (mk(b, W, hkv, dh).to(torch.bfloat16) for _ in range(2))
    pos_t = torch.tensor(ROLL_POS, dtype=torch.int32, device=dev)
    clamped = torch.clamp(pos_t, max=W - 1)
    j = torch.arange(W, device=dev)
    p = pos_t.long()[:, None]
    valid = (p - (p - j[None]) % W) >= 0                     # (b, W)

    def plain():
        m, l, o = attn_partials(q[:, None], kc, vc, valid[:, None, :])
        return finalize_partials(m, l, o)[:, :, 0]

    out = decode_attention(q, kc, vc, clamped)
    ref = plain()
    same = torch.equal(out, decode_attention(q, kc, vc, clamped))
    rows_ok = row_independent(
        torch, out, decode_attention,
        lambda r: (q[r:r + 1], kc[r:r + 1], vc[r:r + 1], clamped[r:r + 1]),
        (q, longer(torch, kc), longer(torch, vc), clamped), b)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    row = dict(shape=f"rolling b={b} W={W} h={h} hkv={hkv} dh={dh} "
               f"pos={ROLL_POS} clamped={clamped.tolist()} cache=bfloat16",
               max_abs_err=err, tol=BF16_ATOL, deterministic=bool(same),
               row_independent=rows_ok,
               ok=err <= BF16_ATOL and bool(same) and rows_ok,
               main="gemma3-4b rolling W=1024")
    import torch.nn.functional as F
    qt, kt, vt = q[:, :, None], kc.float().transpose(1, 2), \
        vc.float().transpose(1, 2)
    mask = valid[:, None, None, :]

    def sdpa(a, k_, v_, m_):
        return F.scaled_dot_product_attention(a, k_, v_, attn_mask=m_,
                                              enable_gqa=True)

    row.update(timings(
        torch, lambda: decode_attention(q, kc, vc, clamped), plain,
        lambda: sdpa(qt, kt, vt, mask), TIMING_ITERS))
    row["cold_ms"] = cold_ms(torch, decode_attention, (q, kc, vc, clamped))
    row["library_cold_ms"] = cold_ms(torch, sdpa, (qt, kt, vt, mask))
    from repro_torch.kernels import cost
    c = cost.decode_attention(b, h, hkv, dh, int(valid.sum()), 2)
    row["bound_ms"], row["bound_by"] = cost.bound_ms(c.nbytes, c.flops)
    return row


def check_decode_int4(torch, rng, dev):
    """``decode_attention_int4`` against its plain version (atol 2e-5 at
    f32, 2e-2 with bf16 rounding), two calls bit-equal, each row
    bit-equal alone, in the batch and over a longer slab
    (``row_independent``) and, without a fresh row at f32, bit-equal to
    ``decode_attention`` over the dequantized cache (the two kernels run
    one step over one plan; the error against it is recorded beside
    tests/test_kernels.py:101's 1e-6); timed warm and cold at the serving
    and generation shapes, llama3.2-1b's and Gemma 3's global layers (F =
    1024 at head_dim 256, S = 2048)."""
    from repro_torch.core.kvstore import KV_LEN_BUCKET, PackedRows, kv_group
    from repro_torch.core.kvstore import quantize_kv_rows
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4, plain)
    S = -(-(max(SERVE_POS) + 1) // KV_LEN_BUCKET) * KV_LEN_BUCKET
    last = PROMPT + GEN - 2
    # (b, S, h, hkv, dh, pos, fresh row, cache dtype, timed as)
    cases = [(B, S, 32, 4, 64, SERVE_POS, fresh, cdt, timed)
             for fresh, cdt, timed in (
                 (True, torch.bfloat16, "serving"),
                 (True, torch.float32, "generation"),
                 (False, torch.float32, None), (False, torch.bfloat16, None))]
    cases += [(B, S, 32, 4, 64, [last] * B, True, torch.float32, None),
              (B, S, 32, 4, 64, [0, 0, 5, 1], True, torch.float32, None),
              (B, S, 32, 4, 64, [0, 0, 5, 1], False, torch.float32, None),
              (B, 100, 32, 4, 64, [99, 0, 64, 31], False, torch.float32,
               None),
              (B, 100, 32, 4, 64, [99, 0, 64, 31], True, torch.bfloat16,
               None),
              (3, 77, 6, 3, 16, [76, 0, 40], False, torch.float32, None),
              (3, 77, 6, 3, 16, [76, 0, 40], True, torch.bfloat16, None),
              (2, 64, 8, 4, 16, [63, 5], False, torch.float32, None),
              (2, 64, 8, 4, 16, [63, 5], True, torch.float32, None),
              # the row split: tiles past pos[r], pos 0 on every row, pos
              # inside the first tile, S not a multiple of the tile
              (B, 256, 32, 4, 64, [3, 40, 0, 255], False, torch.float32,
               None),
              (B, 256, 32, 4, 64, [3, 40, 0, 255], True, torch.bfloat16,
               None),
              (B, S, 32, 4, 64, [0, 0, 0, 0], False, torch.float32, None),
              (B, S, 32, 4, 64, [0, 0, 0, 0], True, torch.float32, None),
              (B, 33, 32, 4, 64, [32, 0, 31, 1], False, torch.float32, None),
              (B, 33, 32, 4, 64, [32, 0, 31, 1], True, torch.float32, None),
              (B, 1024, 32, 4, 64, [1023, 700, 0, 64], False, torch.float32,
               None),
              # llama3.2-1b (run h): F = 8 x 64, the CLI's short prompts
              (B, 32, 32, 8, 64, [22, 15, 9, 20], True, torch.bfloat16,
               "llama3.2-1b"),
              (B, 32, 32, 8, 64, [22, 15, 9, 20], False, torch.float32,
               None),
              # head_dim 128, group 4 (Llama-3.1-8B with kv_mode="int4")
              (B, S, 32, 8, 128, SERVE_POS, True, torch.bfloat16, None),
              (B, S, 32, 8, 128, SERVE_POS, False, torch.float32, None),
              # run (q): Gemma 3's global layers, F = 4 x 256, group 2,
              # over the whole slab of the plan's max_len
              (B, 2048, 8, 4, 256, [1515, 1031, 315, 129], True,
               torch.bfloat16, "gemma3-4b S=2048"),
              (B, 2048, 8, 4, 256, [2047, 0, 700, 1024], False,
               torch.float32, None)]
    rows = []
    for b, S_, h, hkv, dh, pos, fresh, cdt, timed in cases:
        F, mk = hkv * dh, (lambda *s: torch.tensor(
            rng.standard_normal(s), dtype=torch.float32, device=dev))
        g = kv_group(F)
        q = mk(b, h, dh)
        kq, ks = quantize_kv_rows(mk(b, S_, F), g)
        vq, vs = quantize_kv_rows(mk(b, S_, F), g)
        kn, vn = (mk(b, hkv, dh), mk(b, hkv, dh)) if fresh else (None, None)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        kw = dict(hkv=hkv, group=g, k_new=kn, v_new=vn, cache_dtype=cdt)
        out = decode_attention_int4(q, kq, ks, vq, vs, pos_t, **kw)
        ref = plain(q, kq, ks, vq, vs, pos_t, **kw)
        same = torch.equal(out, decode_attention_int4(q, kq, ks, vq, vs,
                                                      pos_t, **kw))

        def call(q_, kq_, ks_, vq_, vs_, p_, kn_, vn_):
            return decode_attention_int4(q_, kq_, ks_, vq_, vs_, p_,
                                         **dict(kw, k_new=kn_, v_new=vn_))

        rows_ok = row_independent(
            torch, out, call,
            lambda r: (q[r:r + 1], kq[r:r + 1], ks[r:r + 1], vq[r:r + 1],
                       vs[r:r + 1], pos_t[r:r + 1],
                       *((kn[r:r + 1], vn[r:r + 1]) if fresh
                         else (None, None))),
            (q, *(longer(torch, t) for t in (kq, ks, vq, vs)), pos_t, kn,
             vn), b)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = ATTN_ATOL if cdt == torch.float32 else BF16_ATOL
        row = dict(shape=f"b={b} S={S_} h={h} hkv={hkv} dh={dh} g={g} "
                   f"pos={pos} fresh={fresh} cache={str(cdt)[6:]}",
                   max_abs_err=err, tol=tol, deterministic=bool(same),
                   row_independent=rows_ok,
                   ok=err <= tol and bool(same) and rows_ok, main=timed)
        kd = PackedRows(kq, ks, g, torch.float32, (hkv, dh)).dequantize()
        vd = PackedRows(vq, vs, g, torch.float32, (hkv, dh)).dequantize()
        if not fresh and cdt == torch.float32:
            twin = decode_attention(q, kd, vd, pos_t)
            torch.cuda.synchronize()
            row["err_vs_decode_attention"] = (out - twin).abs().max().item()
            row["bit_equal_to_decode_attention"] = bool(torch.equal(out, twin))
            row["ok"] &= row["bit_equal_to_decode_attention"]
        if timed:
            if fresh:                    # the yardstick attends the same rows
                kd, vd = kd.clone(), vd.clone()
                rr = torch.arange(b, device=dev)
                kd[rr, pos_t.long()] = kn
                vd[rr, pos_t.long()] = vn
            row.update(timings(
                torch, lambda: decode_attention_int4(q, kq, ks, vq, vs,
                                                     pos_t, **kw),
                lambda: plain(q, kq, ks, vq, vs, pos_t, **kw),
                _sdpa_decode(torch, q, kd, vd, pos_t), TIMING_ITERS))
            row["cold_ms"] = cold_ms(
                torch, lambda *a: decode_attention_int4(*a, **kw),
                (q, kq, ks, vq, vs, pos_t))
            row["library_cold_ms"] = cold_ms(
                torch, _sdpa_decode_call,
                _sdpa_decode_args(torch, q, kd, vd, pos_t))
            hist = sum(min(p + (0 if fresh else 1), S_) for p in pos)
            c = cost.decode_attention_int4(b, h, hkv, dh, hist, g,
                                           bool(fresh))
            row["bound_ms"], row["bound_by"] = cost.bound_ms(c.nbytes,
                                                             c.flops)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 3, the bf16 instances: each against its plain version, warm and cold
# ---------------------------------------------------------------------------

L2_BYTES = 50 * 2**20    # the H100's L2: a cold row rotates past twice it
BF16_OUT_RTOL = 2.0**-8  # one bf16 rounding of an output (8 significant bits)


def bf16_ulps(torch, a, b):
    """Element-wise distance in bf16 ulps between two bf16 tensors (their
    bit patterns as sign-magnitude integers)."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def cold_sets(torch, args):
    """Copies of ``args`` (tensors cloned), enough that one pass over them
    reads more than twice the L2."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(2, 2 * L2_BYTES // max(1, nbytes) + 1)
    assert n * nbytes > 2 * L2_BYTES, (n, nbytes)
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(n)]


def cold_ms(torch, fn, args) -> float:
    """Mean device time of ``fn(*args)`` with its inputs cold in the L2:
    each call reads a copy no call since that copy's last one read."""
    sets = cold_sets(torch, args)
    turn = iter(range(1 << 30))
    return device_ms(torch, lambda: fn(*sets[next(turn) % len(sets)]),
                     len(sets))


def bf16_timings(torch, kernel, k_args, plain, library, l_args,
                 iters: int) -> dict:
    """``timings`` (warm: the same inputs call after call), then the
    kernel's and the library call's times with cold inputs."""
    row = timings(torch, lambda: kernel(*k_args), lambda: plain(*k_args),
                  lambda: library(*l_args), iters)
    short, median = TIMER["short_events"], TIMER["median_timed"]
    row["cold_ms"] = cold_ms(torch, kernel, k_args)
    row["library_cold_ms"] = cold_ms(torch, library, l_args)
    row["cold_trace_events_short"] = TIMER["short_events"] - short
    row["cold_median_timed"] = TIMER["median_timed"] - median
    return row


def check_int4_bf16(torch, rng, dev):
    """``int4_matmul``'s bf16 instance (bf16 x read and the bf16 output
    written in-kernel) against the cast recipe (x widened, the f32
    instance, the output cast back): the GEMV (M <= 16) bit-equal to it,
    the tensor-core path (bf16 wgmma on the exact nibbles: the products
    exact, the f32 sums in another order inside a k16 step) within one
    bf16 ulp of it on every element; two calls equal; and against the
    plain version (x widened, an f32 output) within one bf16 rounding of
    the output plus the f32 tolerance (rtol 2^-8 + 1e-5, atol 1e-5 x
    max); timed warm and cold beside ``torch.matmul`` at bf16 over the
    dequantized weight: decode M = 4 (the kernels line's head: 2048x2048)
    and the 8B's decode projections (the GEMV), M = 512 (run (aa)'s bf16
    prefill) and the 8B's M = 128 (the tensor-core path, two
    warpgroups); checked untimed at the other shapes of (aa), at the path
    switch and at the edges (one warpgroup, group 16 and 32, a ragged
    N)."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.int4_matmul import SMALL_M, int4_matmul, plain
    from repro_torch.quant.int4 import dequantize_int4, quantize_int4
    l8 = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
    cases = [(4, 2048, 2048, 128, True)]
    cases += [(4, K, N, 128, f"bf16 llama3.1-8b M=4 {K}x{N}") for K, N in l8]
    cases += [(512, 2048, 5632, 128, "bf16 M=512 2048x5632"),
              (128, 4096, 14336, 128, "bf16 llama3.1-8b M=128 4096x14336")]
    cases += [(M, K, N, 128, None) for M in (4, 512)
              for K, N in ((2048, 256), (5632, 2048))]
    cases += [(512, 2048, 2048, 128, None), (16, 5632, 2048, 128, None),
              (17, 2048, 5632, 128, None), (20, 2048, 2048, 128, None),
              (1, 2048, 2048, 128, None), (3, 96, 10, 32, None),
              (512, 384, 200, 32, None), (64, 1024, 200, 32, None),
              (65, 384, 256, 16, None), (128, 5632, 2048, 128, None)]
    rows = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    for M, K, N, G, main in cases:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((K, N), generator=gen, device=dev) * 0.05
        packed, scale = quantize_int4(w, G)
        out = int4_matmul(x, packed, scale, group=G)
        recipe = int4_matmul(x.float(), packed, scale,
                             group=G).to(torch.bfloat16)
        ref = plain(x, packed, scale, G)
        again = int4_matmul(x, packed, scale, group=G)
        torch.cuda.synchronize()
        d = (out.float() - ref).abs()
        tol = (BF16_OUT_RTOL + INT4_RTOL) * ref.abs() \
            + INT4_RTOL * ref.abs().max()
        same = bool(torch.equal(out, again))
        row = dict(shape=f"M={M} K={K} N={N} G={G} x=bf16",
                   max_abs_err=d.max().item(),
                   err_over_max=d.max().item() / ref.abs().max().item(),
                   deterministic=same, main=main)
        if M <= SMALL_M:       # the GEMV: the f32 arithmetic on the widened x
            recipe_ok = row["bit_equal_to_cast_recipe"] = bool(
                torch.equal(out, recipe))
        else:                  # bf16 wgmma: k16 steps, another order of sums
            ulps = bf16_ulps(torch, out, recipe)
            row["max_ulps_vs_cast_recipe"] = int(ulps.max().item())
            row["share_off_cast_recipe"] = (ulps > 0).float().mean().item()
            recipe_ok = row["within_one_ulp_of_cast_recipe"] = bool(
                ulps.max().item() <= 1)
        row["ok"] = bool((d <= tol).all()) and same and recipe_ok
        if main:
            wd = dequantize_int4(packed, scale, torch.bfloat16, G)
            row.update(bf16_timings(
                torch, lambda a, p, s_: int4_matmul(a, p, s_, group=G),
                (x, packed, scale), lambda a, p, s_: plain(a, p, s_, G),
                torch.matmul, (x, wd), TIMING_ITERS if M <= 16 else 10))
            row["bound_ms"], row["bound_by"], row["bound_rate"] = \
                cost.int4_matmul_bound(M, K, N, G, 2)
        rows.append(row)
    return rows


def _sdpa_args(torch, q, k, v, causal, window, q_offset):
    """(args, kwargs) of one ``scaled_dot_product_attention`` computing
    the same attention (SDPA's ``is_causal`` aligns the top left; a
    chunk's rows sit at q_offset and a window cuts below the diagonal, so
    those take a mask)."""
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if q_offset or window:
        qp = q_offset + torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        mask = (kp <= qp) & ((qp - kp < window) if window else True)
        return (qt, kt, vt, mask), dict(enable_gqa=True)
    return (qt, kt, vt, None), dict(is_causal=causal, enable_gqa=True)


def check_flash_bf16(torch, rng, dev):
    """``flash_attention``'s bf16 instance (both products on bf16
    ``mma.sync``, the unnormalised P rounded to bf16 as the TPU kernel
    does): within 2e-2 x max of its plain version at bf16 (which
    normalises P before rounding it, as the reference's jnp oracle), two
    calls equal, and its distance from the f32 instance on the widened
    inputs printed; timed warm and cold beside SDPA at bf16 with the same
    mask: b 4, sq 128, 32/4 heads of 64 (run (aa)'s bf16 prefill; the
    kernels line's head), Gemma 3's dh 256 with its 1024 window over 1500
    rows, whisper's encoder (``causal=False``, group 1, 1500 rows) and
    cross prefill (48 rows over 1500: a key split), prefill chunks at
    ``q_offset`` 64 and 1468 (dh 128, group 4; the second a key split) and
    dh 192 at the MLA prefill's shape (its own instance); checked untimed
    at the other main-path shapes (dh 16 to 256, jamba's group 8, windows
    with offsets).  Every row also runs under the one-tile layout and
    must be bit-equal to it where the plan has no key split.  The bound
    counts one bf16 product per multiply-add at 989 TFLOP/s over the
    pairs the mask attends."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import flash_attention, plain
    # (b, sq, sk, h, hkv, dh, causal, window, q_offset, timed as)
    cases = [(B, PROMPT, PROMPT, 32, 4, 64, True, 0, 0, True),
             (1, 1500, 1500, 8, 4, 256, True, GEMMA3_WINDOW, 0,
              "bf16 gemma3-4b sq=1500 window=1024"),
             (1, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64, False, 0, 0,
              "bf16 whisper encoder sq=sk=1500"),
             (1, 32, 96, 32, 8, 128, True, 0, 64,
              "bf16 llama3.1-8b chunk sq=32 q_offset=64"),
             (1, MLA_SQ, MLA_SQ, 128, 128, 192, True, 0, 0,
              "bf16 dh=192 sq=114 h=128/128 (the MLA prefill's shape)"),
             (1, 48, WHISPER_FRAMES, 8, 8, 64, False, 0, 0,
              "bf16 whisper cross prefill sq=48 sk=1500"),
             (1, 32, 1500, 32, 8, 128, True, 0, 1468,
              "bf16 llama3.1-8b chunk sq=32 q_offset=1468"),
             (2, 40, 400, 4, 4, 64, True, 200, 360, None),
             (1, 20, 600, 8, 4, 256, True, 0, 580, None),
             (1, 141, 141, 32, 4, 64, True, 0, 0, None),
             (1, 114, 114, 8, 4, 256, True, 0, 0, None),
             (2, 33, 33, 16, 4, 256, True, GEMMA3_WINDOW, 0, None),
             (1, 48, WHISPER_FRAMES, 8, 8, 64, False, 0, 0, None),
             (1, 114, 114, 64, 8, 128, True, 0, 0, None),
             (1, 18, 114, 32, 8, 128, True, 0, 96, None),
             (2, 45, 65, 8, 2, 32, True, 13, 20, None),
             (2, 32, 32, 8, 4, 16, True, 0, 0, None),
             (1, 5, 24, 8, 8, 64, False, 0, 0, None)]
    rows = []
    for b, sq, sk, h, hkv, dh, causal, window, q_offset, timed in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32,
                                     device=dev).to(torch.bfloat16)
        q, k, v = mk(b, sq, h, dh), mk(b, sk, hkv, dh), mk(b, sk, hkv, dh)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out = flash_attention(q, k, v, **kw)
        ref = plain(q, k, v, **kw).float()
        again = flash_attention(q, k, v, **kw)
        wide = flash_attention(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        row = dict(shape=f"b={b} sq={sq} sk={sk} h={h} hkv={hkv} dh={dh} "
                   f"causal={causal} window={window} q_offset={q_offset} "
                   f"bf16", max_abs_err=err,
                   err_over_max=err / ref.abs().max().item(),
                   err_vs_f32_instance=(out.float() - wide).abs().max().item(),
                   deterministic=same, main=timed,
                   **flash_plan_fields(torch, q, k, v, kw, out, timed))
        row["ok"] = (err <= BF16_ATOL * ref.abs().max().item() and same
                     and row.get("bit_equal_to_one_tile_plan", True))
        if timed:
            s_args, s_kw = _sdpa_args(torch, q, k, v, causal, window, q_offset)
            row.update(bf16_timings(
                torch, lambda a, b_, c: flash_attention(a, b_, c, **kw),
                (q, k, v), lambda a, b_, c: plain(a, b_, c, **kw),
                lambda a, b_, c, m: F.scaled_dot_product_attention(
                    a, b_, c, attn_mask=m, **s_kw), s_args, 20))
            work = (b, sq, sk, h, hkv, dh, causal, window, q_offset)
            row["bound_ms"], row["bound_by"], row["bound_rate"] = \
                cost.flash_attention_bound(*work, itemsize=2)
        rows.append(row)
    return rows


def check_decode_bf16(torch, rng, dev):
    """``decode_attention``'s bf16-q instance (q read and the output
    written in bf16 by the kernel; the arithmetic stays f32): bit-equal
    to the cast recipe it replaces (q widened, the f32-q instance, the
    output cast back), two calls equal, within 2e-2 x max of the plain
    version at bf16; timed warm and cold beside SDPA at bf16: run (aa)'s
    bf16 steps (b 4 over the 256-row slab, 32/4 heads of 64) as the
    kernels line's head, the serving shape (S 160, ragged), Gemma
    3's global slab (dh 256) and whisper's cross attention over 1500
    rows; checked untimed over f32 caches and at dh 16 and 128."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention import decode_attention, plain
    S = -(-(max(SERVE_POS) + 1) // 32) * 32
    bf, f32 = torch.bfloat16, torch.float32
    aa_pos = [W4_PROMPT + W4_BF16_STEPS] * W4_B
    # (b, S, h, hkv, dh, pos, cache dtype, timed as)
    cases = [(W4_B, W4_CACHE, 32, 4, 64, aa_pos, bf, True),
             (B, S, 32, 4, 64, SERVE_POS, bf, "bf16 q serving S=160"),
             (B, 1536, 8, 4, 256, [1515, 1031, 315, 129], bf,
              "bf16 q gemma3-4b global"),
             (B, WHISPER_FRAMES, 8, 8, 64, [WHISPER_FRAMES - 1] * B, bf,
              "bf16 q whisper cross S=1500"),
             (B, S, 32, 4, 64, SERVE_POS, f32, None),
             (B, S, 32, 8, 128, SERVE_POS, bf, None),
             (3, 77, 8, 2, 32, [76, 0, 40], bf, None),
             (2, 64, 8, 4, 16, [46, 33], bf, None),
             (B, MAX_LEN, 32, 8, 64, [118, 97, 85, 62], f32, None)]
    rows = []
    for b, S_, h, hkv, dh, pos, cdt, timed in cases:
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q = mk(b, h, dh).to(bf)
        kc, vc = mk(b, S_, hkv, dh).to(cdt), mk(b, S_, hkv, dh).to(cdt)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = decode_attention(q, kc, vc, pos_t)
        recipe = decode_attention(q.float(), kc, vc, pos_t).to(bf)
        ref = plain(q, kc, vc, pos_t).float()
        same = bool(torch.equal(out, decode_attention(q, kc, vc, pos_t)))
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        recipe_equal = bool(torch.equal(out, recipe))
        row = dict(shape=f"b={b} S={S_} h={h} hkv={hkv} dh={dh} pos={pos} "
                   f"q=bfloat16 cache={str(cdt)[6:]}", max_abs_err=err,
                   err_over_max=err / ref.abs().max().item(),
                   deterministic=same, bit_equal_to_cast_recipe=recipe_equal,
                   ok=(err <= BF16_ATOL * ref.abs().max().item() and same
                       and recipe_equal), main=timed)
        if timed:
            row.update(bf16_timings(
                torch, decode_attention, (q, kc, vc, pos_t), plain,
                _sdpa_decode_call,
                _sdpa_decode_args(torch, q, kc.to(bf), vc.to(bf), pos_t),
                TIMING_ITERS))
            c = cost.decode_attention(b, h, hkv, dh, sum(p + 1 for p in pos),
                                      kc.element_size(), 2)
            row["bound_ms"], row["bound_by"] = cost.bound_ms(c.nbytes,
                                                             c.flops)
        rows.append(row)
    return rows


def check_decode_int4_bf16(torch, rng, dev):
    """``decode_attention_int4``'s bf16-q instance (the repaired fault:
    its kernel arm refused a bf16 q): bit-equal to the cast recipe (q and
    the fresh rows widened, the f32 instance, the output cast back), two
    calls equal, within 2e-2 x max of the plain version at bf16; timed
    warm and cold beside SDPA at bf16 over the dequantized rows with the
    fresh row written: run (aa)'s bf16 step over packed rows (b 4, S 256,
    dh 64, bf16 fresh rows; the kernels line's head), the serving shape
    and Gemma 3's global layers (F 1024, dh 256, S 2048); checked untimed
    without a fresh row, with f32 fresh rows and over f32 rows."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels import cost
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4, plain)
    bf, f32 = torch.bfloat16, torch.float32
    S = -(-(max(SERVE_POS) + 1) // 32) * 32
    aa_pos = [W4_PROMPT + W4_BF16_STEPS] * W4_B
    # (b, S, h, hkv, dh, pos, fresh rows' dtype or None, cache, timed as)
    cases = [(W4_B, W4_CACHE, 32, 4, 64, aa_pos, bf, bf, True),
             (B, S, 32, 4, 64, SERVE_POS, bf, bf, "bf16 q serving S=160"),
             (B, 2048, 8, 4, 256, [1515, 1031, 315, 129], bf, bf,
              "bf16 q gemma3-4b S=2048"),
             (B, S, 32, 4, 64, SERVE_POS, None, bf, None),
             (B, S, 32, 4, 64, SERVE_POS, f32, f32, None),
             (B, S, 32, 4, 64, [0, 0, 5, 1], None, f32, None),
             (3, 77, 6, 3, 16, [76, 0, 40], bf, bf, None),
             (B, S, 32, 8, 128, SERVE_POS, bf, bf, None)]
    rows = []
    for b, S_, h, hkv, dh, pos, fresh, cdt, timed in cases:
        F_, mk = hkv * dh, (lambda *s: torch.tensor(
            rng.standard_normal(s), dtype=torch.float32, device=dev))
        g = kv_group(F_)
        q = mk(b, h, dh).to(bf)
        kq, ks = quantize_kv_rows(mk(b, S_, F_), g)
        vq, vs = quantize_kv_rows(mk(b, S_, F_), g)
        kn, vn = ((mk(b, hkv, dh).to(fresh), mk(b, hkv, dh).to(fresh))
                  if fresh else (None, None))
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        kw = dict(hkv=hkv, group=g, k_new=kn, v_new=vn, cache_dtype=cdt)
        out = decode_attention_int4(q, kq, ks, vq, vs, pos_t, **kw)
        wkw = dict(kw, k_new=None if kn is None else kn.float(),
                   v_new=None if vn is None else vn.float())
        recipe = decode_attention_int4(q.float(), kq, ks, vq, vs, pos_t,
                                       **wkw).to(bf)
        ref = plain(q, kq, ks, vq, vs, pos_t, **kw).float()
        same = bool(torch.equal(out, decode_attention_int4(
            q, kq, ks, vq, vs, pos_t, **kw)))
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        recipe_equal = bool(torch.equal(out, recipe))
        row = dict(shape=f"b={b} S={S_} h={h} hkv={hkv} dh={dh} g={g} "
                   f"pos={pos} q=bfloat16 fresh="
                   f"{str(fresh)[6:] if fresh else None} "
                   f"cache={str(cdt)[6:]}", max_abs_err=err,
                   err_over_max=err / ref.abs().max().item(),
                   deterministic=same, bit_equal_to_cast_recipe=recipe_equal,
                   ok=(err <= BF16_ATOL * ref.abs().max().item() and same
                       and recipe_equal), main=timed)
        if timed:
            kd, vd = (PackedRows(p_, s_, g, bf, (hkv, dh)).dequantize()
                      for p_, s_ in ((kq, ks), (vq, vs)))
            if fresh:                    # the yardstick attends the same rows
                rr = torch.arange(b, device=dev)
                kd[rr, pos_t.long()] = kn.to(bf)
                vd[rr, pos_t.long()] = vn.to(bf)
            row.update(bf16_timings(
                torch, lambda *a: decode_attention_int4(*a, **kw),
                (q, kq, ks, vq, vs, pos_t),
                lambda *a: plain(*a, **kw), _sdpa_decode_call,
                _sdpa_decode_args(torch, q, kd, vd, pos_t), TIMING_ITERS))
            hist = sum(min(p + (0 if fresh else 1), S_) for p in pos)
            c = cost.decode_attention_int4(b, h, hkv, dh, hist, g,
                                           bool(fresh), 2, 2)
            row["bound_ms"], row["bound_by"] = cost.bound_ms(c.nbytes,
                                                             c.flops)
        rows.append(row)
    return rows


def check_verify(torch, rng, dev):
    """The speculative verify pass's attention at run (m)'s shapes
    (Llama-3.1-8B, b 4, k = 4: five query positions from ragged first
    positions, S = 160): ``spec_decode_attention`` over bf16 caches (one
    ``decode_attention`` launch per query position) and its packed twin
    (``decode_attention_int4``, the earlier fresh rows packed on the card
    first), each against the same function on the plain versions (atol
    2e-2 over bf16), timed beside one SDPA call over the same rows.  The
    bound counts each live row read once.  Returns (rows for
    ``decode_attention``, rows for ``decode_attention_int4``)."""
    import torch.nn.functional as F
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels import cost, ops
    from repro_torch.models import attention as A
    b, S, s, h, hkv, dh = PAPER_REQS, 160, SPEC_K + 1, 32, 8, 128
    Fd, g = hkv * dh, kv_group(hkv * dh)
    pos = [114, 93, 81, 58]
    mk = lambda *sh: torch.tensor(rng.standard_normal(sh),
                                  dtype=torch.float32, device=dev)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    q, kn, vn = mk(b, s, h, dh), mk(b, s, hkv, dh), mk(b, s, hkv, dh)
    live = torch.arange(S, device=dev)[None, :] < pos_t[:, None].long()
    kc, vc = ((mk(b, S, hkv, dh) * live[..., None, None]).to(torch.bfloat16)
              for _ in range(2))
    packed = [PackedRows(*quantize_kv_rows(mk(b, S, Fd) * live[..., None],
                                           g), g, torch.bfloat16, (hkv, dh))
              for _ in range(2)]
    hist = sum(pos)
    flops = 4.0 * h * dh * sum(p + t + 1 for p in pos for t in range(s))
    io = 4 * (2 * q.numel() + kn.numel() + vn.numel()) + 4 * b
    mask = (torch.arange(S, device=dev)[None, None, :]
            <= (pos_t.long()[:, None] + torch.arange(s, device=dev))[
                :, :, None])[:, None]                      # (b, 1, s, S)
    qt = q.transpose(1, 2)

    def sdpa(k, v):
        kt, vt = k.float().transpose(1, 2), v.float().transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)

    def plain(fn):
        def run():
            ops.use_kernels(False)
            try:
                return fn()
            finally:
                ops.use_kernels(True)
        return run

    out_rows = []
    for name, fn, lib, nbytes in (
            ("decode_attention",
             lambda: A.spec_decode_attention(q, kc, vc, kn, vn, pos_t)[0],
             sdpa(kc, vc), io + 2 * hist * Fd * 2),
            ("decode_attention_int4",
             lambda: A.spec_decode_attention_packed(q, *packed, kn, vn,
                                                    pos_t),
             sdpa(*(p.dequantize() for p in packed)),
             io + 2 * hist * (Fd // 2 + 4 * (Fd // g)))):
        out, ref = fn(), plain(fn)()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        row = dict(shape=f"verify b={b} s={s} S={S} h={h} hkv={hkv} "
                   f"dh={dh} pos={pos} cache=bfloat16"
                   f"{' packed' if name.endswith('int4') else ''}",
                   max_abs_err=err, tol=BF16_ATOL, ok=err <= BF16_ATOL,
                   main=f"llama3.1-8b verify k={SPEC_K}",
                   launches_per_call=s)
        row.update(timings(torch, fn, plain(fn), lib, 20))
        row["bound_ms"], row["bound_by"] = cost.bound_ms(nbytes, flops)
        out_rows.append(row)
    return out_rows[:1], out_rows[1:]


# ---------------------------------------------------------------------------
# phase 4/5: the main path
# ---------------------------------------------------------------------------

def check_mla_flash(torch, rng, dev):
    """``flash_attention`` as run (t)'s MLA prefill runs it: b 1, sq
    ``MLA_SQ``, 128 heads each its own kv head (group 1: a block is one
    head x 64 rows), head_dim dn + dr = 192 (the kernel's DH 192
    instance), V zero-padded from 128 to 192 (``models.attention.
    mla_prefill_attention``), causal; against the plain version on the
    same padded tensors (atol 2e-5), bit-equal to the one-tile layout,
    and at 37 rows; timed beside the one-tile layout, the plain version
    and SDPA, which takes V at its own width of 128.
    The bound is the function's, not the padded call's: q and k read at
    dn + dr, V read and the output written at dv, and over the pairs the
    mask attends, QK^T at dn + dr plus PV at dv, as three TF32 terms."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_attention import flash_attention, plain
    h, dq, dv = 128, 192, 128
    rows = []
    for sq, main in ((MLA_SQ, f"deepseek-v3 MLA prefill sq={MLA_SQ} "
                      f"h=128/128 dh=192 (v 128 padded)"), (37, None)):
        mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                     dtype=torch.float32, device=dev)
        q, k, v = mk(1, sq, h, dq), mk(1, sq, h, dq), mk(1, sq, h, dv)
        vp = F.pad(v, (0, dq - dv))
        out = flash_attention(q, k, vp)
        ref = plain(q, k, vp)
        again = flash_attention(q, k, vp)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        same = bool(torch.equal(out, again))
        pad_zero = bool((out[..., dv:] == 0).all())
        kw = dict(causal=True, window=0, q_offset=0)
        row = dict(shape=f"b=1 sq={sq} sk={sq} h={h} hkv={h} dh={dq} "
                   f"v={dv} padded causal", max_abs_err=err,
                   deterministic=same, padded_columns_zero=pad_zero,
                   main=main, **flash_plan_fields(torch, q, k, vp, kw, out,
                                                  main))
        row["ok"] = (err <= ATTN_ATOL and same and pad_zero
                     and row.get("bit_equal_to_one_tile_plan", True))
        if main:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row.update(timings(
                torch, lambda: flash_attention(q, k, vp),
                lambda: plain(q, k, vp),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True), 20))
            nbytes = 4 * (q.numel() + k.numel() + 2 * v.numel())
            flops = 2.0 * h * cost.attended_pairs(sq, sq) * (dq + dv)
            row["bound_ms"], row["bound_by"] = cost.bound_ms(
                nbytes, 3 * flops, cost.TF32_FLOPS)
            row["bound_rate"] = "tf32 x3 terms, 495 TFLOP/s"
            row["bound_fp32_ms"] = cost.bound_ms(nbytes, flops)[0]
        rows.append(row)
    return rows


def time_mla_decode(torch, rng, dev):
    """The plain MLA decode step (``models.attention.
    mla_decode_attention``, no kernel: the reference computes it in jnp)
    at run (t)'s decode shape: b ``MLA_B``, bf16 latent caches of
    ``MLA_S`` rows, 128 heads, r 512, dr 64, ragged positions: its device
    time (profiler), its host time a call (enqueue only), its bound (the
    cache bytes over 3.35 TB/s, or the f32 operations as three TF32
    terms at 495 TFLOP/s if larger, as the fp32 attention rows count
    them; the byte bound printed beside it), and SDPA on the same
    function as MQA (q (b, 128, 1, 576), k
    (b, 1, S, 576), v (b, 1, S, 512), scale 1/sqrt(192), the positions'
    mask) over f32 copies of the caches; the largest difference between
    the two printed."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.models.attention import mla_decode_attention
    b, S, h, r, dr = MLA_B, MLA_S, 128, 512, 64
    scale = 1.0 / math.sqrt(192)
    mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                 dtype=torch.float32, device=dev)
    q_eff, q_rope = mk(b, 1, h, r), mk(b, 1, h, dr)
    c, kr = mk(b, S, r).bfloat16(), mk(b, S, dr).bfloat16()
    c_new, kr_new = mk(b, 1, r), mk(b, 1, dr)
    pos = torch.tensor([S - 1, 114, 93, 58], device=dev, dtype=torch.int32)
    fn = lambda: mla_decode_attention(q_eff, q_rope, c, kr, c_new, kr_new,
                                      pos, scale=scale)[0]
    out = fn()
    qt = torch.cat([q_eff, q_rope], -1).transpose(1, 2)     # (b, h, 1, 576)
    kt = torch.cat([c, kr], -1).float()[:, None]            # (b, 1, S, 576)
    vt = c.float()[:, None]                                 # (b, 1, S, 512)
    mask = (torch.arange(S, device=dev)[None, :]
            <= pos[:, None].long())[:, None, None]
    lib = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    diff = (lib().transpose(1, 2) - out).abs().max().item()
    iters = 50
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    nbytes = 2 * (c.numel() + kr.numel())
    flops = 2.0 * b * h * S * (r + dr) + 2.0 * b * h * S * r
    row = dict(shape=f"b={b} S={S} h={h} r={r} dr={dr} bf16 caches, ragged",
               ms=device_ms(torch, fn, iters), host_ms=host_ms,
               call_ms=call_ms(torch, fn, iters),
               library_ms=device_ms(torch, lib, iters),
               bytes_bound_ms=nbytes / cost.HBM_BPS * 1e3,
               max_abs_diff_vs_library=diff)
    row["bound_ms"], row["bound_by"] = cost.bound_ms(nbytes, 3 * flops,
                                                     cost.TF32_FLOPS)
    row["bound_rate"] = "tf32 x3 terms, 495 TFLOP/s"
    log(json.dumps({"mla_decode_plain": row}))
    return row


def make_plan(quant, pipeline, kv_mode="fp32"):
    """A tinyllama-1.1b plan for runs (a)-(f), written out field by
    field."""
    from repro_torch.serving.spec import ResolvedPlan
    return ResolvedPlan(
        arch="tinyllama-1.1b", scaled=False, engine="offloaded", b_max=B,
        max_len=MAX_LEN, seed=0, placement="host", pipeline=pipeline,
        quant=quant, kv_mode=kv_mode, fused_int4=True, moe_quant=None,
        warm=pipeline == "performance", depth=1, depth_policy="static",
        spill_cap=32, cache_on="host", disk_root="",
        block_bytes=8 * 2**20, n_io_threads=3, cold_reads=False,
        sim_bw=None, draft_arch=None, spec_k=None)


def check_launches(name, counts, expect, exact=False):
    """Fail unless every kernel in ``expect`` launched at least (or, with
    ``exact``, exactly) its expected count in run ``name``."""
    for k, n in expect.items():
        if counts[k] < n or (exact or n == 0) and counts[k] != n:
            raise RuntimeError(f"run {name}: {k} launched {counts[k]} "
                               f"times, expected {'' if exact or n == 0 else '>= '}{n}")


def generate_once(torch, ops, lm, name, prompt, expect):
    """One main-path ``generate`` on a fresh trace (the engine's trace
    otherwise accumulates across calls), its launch counts zeroed before
    and read after; fails on bad tokens or a kernel launched too
    rarely (or, where ``expect`` says 0, at all).  Returns the tokens,
    the stats, the counts and the run's trace."""
    from repro_torch.core.tasks import Trace
    lm.trace = Trace()
    torch.cuda.synchronize()
    ops.reset_launches()
    toks, stats = lm.generate(prompt, GEN)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    vocab = lm.cfg.vocab_size
    if toks.shape != (B, GEN) or not ((toks >= 0) & (toks < vocab)).all():
        raise RuntimeError(f"run {name}: bad tokens {toks.shape}")
    check_launches(name, counts, expect)
    return toks, stats, counts, lm.trace


def packed_weights(torch, weights, dev):
    """``core.convert.lm_weights`` of an f32 engine, packed as an INT4
    engine packs its draws (``PipelinedLM._unit_tensors``: every 2-D
    tensor whose first dim is a multiple of 128, at group 128, on the
    card, bit-identical to the CPU): the weights that engine would draw
    from the same seed."""
    from repro_torch.quant.int4 import quantize_int4
    emb, units, routers = weights
    out = {}
    for key, tensors in units.items():
        out[key] = {}
        for name, a in tensors.items():
            if a.ndim == 2 and a.shape[0] % 128 == 0:
                packed, scale = quantize_int4(torch.from_numpy(a).to(dev))
                out[key][name + "#q"] = packed.cpu().numpy()
                out[key][name + "#s"] = scale.cpu().numpy()
            else:
                out[key][name] = a
    return emb, out, routers


def run_main(torch, ops, name, plan, prompt, expect, weights=None,
             weights_from=None):
    """``REPEATS[name]`` runs on one engine (medians and every value of the
    end-to-end metrics), then one profiled ``PROFILE_GEN``-token run for
    the card's busy share.  The engine draws its weights, or loads
    ``weights`` (in ``core.convert.lm_weights``'s form, packed for an
    INT4 plan) taken from the run ``weights_from`` names.  Returns the engine, run 1's tokens and counts,
    the summary and the trace of the run of median total time (run (l)
    replays it)."""
    from repro_torch.serving.spec import build_lm
    t0 = time.perf_counter()
    lm = build_lm(plan, weights=weights)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    runs = [generate_once(torch, ops, lm, name, prompt, expect)
            for _ in range(REPEATS[name])]
    toks, _, counts, _ = runs[0]
    keys = ("throughput_tok_s", "decode_tok_s", "ttft_s", "total_s",
            "compute_busy")
    stats = [s for _, s, _, _ in runs]
    order = sorted(range(len(runs)), key=lambda k: stats[k]["total_s"])
    trace = runs[order[len(order) // 2]][3]
    pk = stats[0]["pipeline"]["per_kind"]
    summary = {
        "run": name, "plan": f"quant={plan.quant} kv_mode={plan.kv_mode} "
        f"pipeline={plan.pipeline} depth={plan.depth} placement="
        f"{plan.placement} cache_on={plan.cache_on}", "build_s": build_s,
        "weights": "drawn" if weights is None else weights_from,
        "repeats": REPEATS[name],
        **{k: statistics.median(s[k] for s in stats) for k in keys},
        "all": {k: [s[k] for s in stats] for k in keys},
        **{k: max(s.get(k, 0.0) for s in stats) for k in (
            "host_peak_gb", "device_peak_gb", "device_max_allocated_gb")},
        "bytes": {k: pk[k]["bytes"] for k in pk},
        "busy_s_median": {k: statistics.median(
            s["pipeline"]["per_kind"][k]["busy_s"] for s in stats)
            for k in pk},
        "launches": counts,
        "repeats_tokens_equal": all((t == toks).all() for t, *_ in runs)}
    summary["profiled_gen"] = PROFILE_GEN
    from repro_torch.core.tasks import Trace
    lm.trace = Trace()                  # keep the timed runs' traces
    summary.update(busy_share(device_events(
        torch, lambda: lm.generate(prompt, PROFILE_GEN))))
    log(json.dumps({"main_path": summary}))
    return lm, toks, counts, summary, trace


def whole_path_check(torch, ops, lm, prompt, toks_b):
    """Kernels vs use_kernels(False) on the same engine and weights."""
    seen = []
    orig = lm.finalize

    def grab(i, x):
        seen.append(x.detach().clone())
        return orig(i, x)

    lm.finalize = grab
    try:
        ops.use_kernels(True)
        tk, _ = lm.generate(prompt, 2)
        hk = list(seen)
        seen.clear()
        ops.use_kernels(False)
        tp, _ = lm.generate(prompt, 2)
        hp = list(seen)
        seen.clear()
        toks_plain, _ = lm.generate(prompt, toks_b.shape[1])
    finally:
        ops.use_kernels(True)
        lm.finalize = orig
    torch.cuda.synchronize()
    res = {}
    for name, a, b in (("prefill", hk[0], hp[0]), ("decode1", hk[1], hp[1])):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        res[name + "_rel_err"] = rel
        if not math.isfinite(rel) or not torch.isfinite(a).all():
            raise RuntimeError(f"{name}: non-finite hidden states")
    res["prefill_tokens_equal"] = bool((tk[:, 0] == tp[:, 0]).all())
    res["greedy_agreement_run_b"] = float((toks_b == toks_plain).mean())
    res["tolerance_rel"] = HIDDEN_RTOL
    log(json.dumps({"whole_path": res}))
    if res["prefill_rel_err"] > HIDDEN_RTOL:
        raise RuntimeError(f"prefill hidden states differ: {res}")
    if res["prefill_tokens_equal"] and res["decode1_rel_err"] > HIDDEN_RTOL:
        raise RuntimeError(f"decode hidden states differ: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 6: serving, create_engine(plan) -> OffloadedServingEngine
# ---------------------------------------------------------------------------

def serving_requests(n: int):
    """``n`` requests: prompt lengths in [32, 160] and max_new_tokens in
    ``SERVE_NEW``, drawn from ``default_rng(0)``."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 161, n)
    news = rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1, n)
    return [(rng.integers(0, 32000, (int(l),)).astype(np.int32), int(m))
            for l, m in zip(lens, news)]


def serve_once(torch, ops, eng, reqs, rid0: int, preempt_after=None,
               on_step=None):
    """Submit every request (``(prompt, max_new)``, or ``(prompt,
    max_new, encoder frames or None)`` for an encoder-decoder), then
    drive ``step`` until the engine is idle, timing each step; launch
    counts zeroed before and read after.
    With ``preempt_after``, the first occupied slot is preempted after
    that many steps and resumes from its spilled rows; ``on_step()``
    runs after each step, outside its time."""
    from repro_torch.serving.base import Request
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated() / 2**30
    before = dict(eng.stats)
    for i, (p, m, *enc) in enumerate(reqs):
        eng.submit(Request(rid=rid0 + i, prompt=p.copy(), max_new=m,
                           enc_embeds=enc[0] if enc else None))
    done, steps, preempted = [], [], None
    t0 = time.perf_counter()
    while not eng.idle():
        ts = time.perf_counter()
        eng.step(done)
        steps.append(time.perf_counter() - ts)
        if on_step is not None:
            on_step()
        if preempt_after is not None and len(steps) == preempt_after:
            slot = next(i for i, r in enumerate(eng.slots) if r is not None)
            preempted = eng.slots[slot].rid - rid0
            eng.preempt_slot(slot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: eng.stats[k] - before.get(k, 0) for k in (
        "prefills", "prefill_chunks", "decode_steps", "tokens_out",
        "slot_saves", "slot_restores")}
    done.sort(key=lambda r: r.rid)
    outs = {r.rid - rid0: list(r.out) for r in done}
    return dict(outs=outs, steps=steps, wall=wall, stats=stats,
                ttft_s=[r.t_first_token - r.t_arrive for r in done],
                req_tok_s=[len(r.out) / (r.t_done - r.t_arrive)
                           for r in done],
                counts=dict(ops.LAUNCHES), preempted=preempted,
                device_allocated_at_start_gb=at_start,
                device_max_allocated_gb=torch.cuda.max_memory_allocated()
                / 2**30)


def refill_watch(eng):
    """An ``on_step`` hook for ``serve_once`` and its record: ``refills``
    counts the requests that entered a slot a finished request had held
    while another slot kept the request it held before that step."""
    n = len(eng.slots)
    prev, held, rec = [None] * n, [None] * n, {"refills": 0}

    def on_step():
        now = [r.rid if r is not None else None for r in eng.slots]
        for i, rid in enumerate(now):
            if rid is not None and held[i] not in (None, rid) and any(
                    now[j] is not None and now[j] == prev[j]
                    for j in range(n) if j != i):
                rec["refills"] += 1
            if rid is not None:
                held[i] = rid
        prev[:] = now
    return on_step, rec


def run_serving(torch, ops, name, plan, reqs, decode_kernel, preempt=False,
                on_build=None, launches=None, draws=None, refill=False):
    """Build the engine with ``create_engine`` (from ``draws``, a
    ``DrawCache``, where given; ``on_build(eng)`` runs then), serve
    ``reqs`` once (and, with ``preempt``, once more with a slot
    preempted mid-run, which must give the same tokens); fails on
    bad tokens or launch counts other than flash = layers x prefill
    passes (whole prompts, or chunks under a chunked ``sched``, those
    after a prompt's first with q_offset > 0) and ``decode_kernel`` =
    global-attention layers x decode steps (sliding-window layers always
    ``decode_attention`` over their rolling buffers; the other decode
    kernel 0), and, with packed weights, int4_matmul = 7 projections x
    layers x (prefill passes + decode steps); ``launches(stats)``, where
    given, names the exact counts instead (an SSM stack's).  With
    ``refill``, fails unless a queued request entered a slot that a
    finished request freed while another slot still decoded (more
    requests than slots; ``refill_watch``).  Returns the
    engine, the counts, the summary and the
    served run (tokens, per-request latency, and a copy of its trace:
    run (l) replays it)."""
    from repro_torch.core.tasks import Trace
    from repro_torch.serving.spec import create_engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = create_engine(plan, draws=draws)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    if on_build is not None:
        on_build(eng)
    on_step, watch = refill_watch(eng)
    r = serve_once(torch, ops, eng, reqs, 0, on_step=on_step)
    if refill and not (len(reqs) > plan.b_max and watch["refills"]):
        raise RuntimeError(f"run {name}: no request entered a freed slot "
                           f"while another decoded ({len(reqs)} requests "
                           f"on {plan.b_max} slots)")
    r["trace"] = Trace.from_json(json.dumps(eng.trace.to_json()))
    report = eng.pipeline_report()
    n = plan.model_config().num_layers
    n_local = local_layers(plan.model_config())
    vocab = plan.model_config().vocab_size
    st = r["stats"]
    chunked = plan.sched != "monolithic"
    passes = st["prefill_chunks"] if chunked else st["prefills"]
    if launches is not None:
        check_launches(name, r["counts"], launches(st), exact=True)
    else:
        decode = {"decode_attention": n_local * st["decode_steps"],
                  "decode_attention_int4": 0}
        decode[decode_kernel] += (n - n_local) * st["decode_steps"]
        check_launches(name, r["counts"], {
            "flash_attention": n * passes,
            "flash_attention_q_offset": (
                n * (st["prefill_chunks"] - st["prefills"]) if chunked
                else 0),
            **decode,
            "int4_matmul": (7 * n * (passes + st["decode_steps"])
                            if plan.quant == "int4" else 0)}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != m or not all(0 <= t < vocab for t in outs[i])
            for i, (_, m) in enumerate(reqs)):
        raise RuntimeError(f"run {name}: bad tokens {outs}")
    steps_ms = sorted(1e3 * s for s in r["steps"])
    pk = report["per_kind"]
    summary = {
        "run": name, "plan": f"quant={plan.quant} kv_mode={plan.kv_mode} "
        f"pipeline={plan.pipeline} depth={plan.depth} b_max={plan.b_max} "
        f"max_len={plan.max_len} placement={plan.placement}",
        "build_s": build_s, "build_device_peak_gb": build_peak,
        "requests": len(reqs),
        "prompt_lens": [len(p) for p, _ in reqs],
        "max_new": [m for _, m in reqs], **st, "wall_s": r["wall"],
        "tok_s": st["tokens_out"] / r["wall"],
        "step_ms_median": statistics.median(steps_ms),
        "step_ms_p90": steps_ms[int(0.9 * (len(steps_ms) - 1))],
        "ttft_s": r["ttft_s"], "request_tok_s": r["req_tok_s"],
        "busy_s": {k: pk[k]["busy_s"] for k in pk},
        "bytes": {k: pk[k]["bytes"] for k in pk},
        "compute_busy": eng.trace.busy_fraction("compute"),
        "host_peak_gb": eng.host.peak_bytes / 2**30,
        "device_peak_gb": eng.device.peak_bytes / 2**30,
        "device_allocated_at_start_gb": r["device_allocated_at_start_gb"],
        "device_max_allocated_gb": r["device_max_allocated_gb"],
        "kv_dequant_bytes": eng.kvstore.dequant_bytes_total,
        "resident_gb": eng.resident_bytes / 2**30,
        "device_budget_gb": plan.device_budget / 2**30,
        "refills": watch["refills"], "launches": r["counts"]}
    if preempt:
        p = serve_once(torch, ops, eng, reqs, 100, preempt_after=6)
        summary["preempt"] = {
            "slot_request": p["preempted"], **p["stats"],
            "tokens_equal": p["outs"] == outs, "launches": p["counts"]}
        if p["stats"]["slot_restores"] != 1 or p["outs"] != outs:
            raise RuntimeError(f"run {name}: the preempted run differs: "
                               f"{summary['preempt']}")
    log(json.dumps({"serving": summary}))
    return eng, r["counts"], summary, r


def local_layers(cfg) -> int:
    """The sliding-window (``ATTN_LOCAL``) layers of ``cfg``."""
    from repro_torch.configs.base import ATTN_LOCAL
    return sum(s.mixer == ATTN_LOCAL for s in (
        *cfg.pattern * cfg.num_periods, *cfg.remainder))


def serving_whole_path(torch, ops, eng, reqs, name="serving"):
    """Kernels vs use_kernels(False) on the serving engine's weights:
    hidden states of the first prefill and the first decode step, and
    greedy-token agreement over the run; ``name`` heads the printed
    line."""
    seen = []
    orig = eng.finalize

    def grab(i, x):
        seen.append((eng._phase, x.detach().clone()))
        return orig(i, x)

    eng.finalize = grab
    try:
        ops.use_kernels(True)
        rk = serve_once(torch, ops, eng, reqs, 200)
        hk, seen[:] = list(seen), []
        ops.use_kernels(False)
        rp = serve_once(torch, ops, eng, reqs, 300)
        hp = list(seen)
    finally:
        ops.use_kernels(True)
        eng.finalize = orig
    res = {}
    for phase in ("prefill", "decode"):
        a = next(x for ph, x in hk if ph == phase)
        b = next(x for ph, x in hp if ph == phase)
        if not torch.isfinite(a).all():
            raise RuntimeError(f"serving {phase}: non-finite hidden states")
        res[phase + "_rel_err"] = ((a - b).abs().max()
                                   / b.abs().max()).item()
    pairs = [(x, y) for i in rk["outs"] for x, y in
             zip(rk["outs"][i], rp["outs"].get(i, []))]
    res["tokens_compared"] = len(pairs)
    res["greedy_agreement"] = sum(x == y for x, y in pairs) / len(pairs)
    res["first_tokens_equal"] = all(rk["outs"][i][0] == rp["outs"][i][0]
                                    for i in rk["outs"])
    res["tolerance_rel"] = {"prefill": HIDDEN_RTOL, "decode": BF16_HIDDEN_RTOL}
    log(json.dumps({f"{name}_whole_path": res}))
    if res["prefill_rel_err"] > HIDDEN_RTOL:
        raise RuntimeError(f"{name} prefill hidden states differ: {res}")
    if res["first_tokens_equal"] and res["decode_rel_err"] > BF16_HIDDEN_RTOL:
        raise RuntimeError(f"{name} decode hidden states differ: {res}")
    return res


# ---------------------------------------------------------------------------
# phases 7-9: the plan entry point, the CLI and the resident engine
# ---------------------------------------------------------------------------

def host_mem_gb() -> float:
    """The host's RAM (``MemTotal``) in GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemTotal in /proc/meminfo")


def modeled_device_bytes(plan) -> int:
    """The memory model's device footprint of the plan's window: the
    depth-0 peak plus ``depth`` in-flight layers, each at its weights
    (quant-scaled) and its KV slab — the terms behind the plan's depth
    provenance (``core.autoconfig.serving_depth_decision``)."""
    from repro_torch.core.memory_model import (estimate, quant_kv_ratio,
                                               quant_weight_ratio)
    cfg = plan.model_config()
    est0 = estimate(cfg, batch=plan.b_max, seq=plan.max_len, p=4, preload=0)
    per = (int(max(est0.w_mha, est0.w_mlp) * quant_weight_ratio(4, plan.quant))
           + int(est0.kv_cache // cfg.num_layers
                 * quant_kv_ratio(4, plan.kv_mode)))
    return max(est0.peak_prefill, est0.peak_decode) + plan.depth * per


def paper_requests(np, vocab: int):
    """Run (g)'s requests: prompts of 114, 93, 81 and 58 tokens
    (``default_rng(0)``), ``PAPER_NEW`` new tokens each."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (int(n),)).astype(np.int32), PAPER_NEW)
            for n in rng.integers(32, 129, PAPER_REQS)]


def run_paper(torch, ops, np, draws):
    """Run (g): Llama-3.1-8B, INT4 weights, through ``EngineSpec.resolve``
    and ``create_engine`` on the default budget; 4 ragged requests, then
    the whole path against ``use_kernels(False)``.  The build draws and
    packs the 8B into ``draws``, for (j), (m) and (n).  Returns the
    engine (still up: run (k) drives it), its counts and summary, and
    the served run."""
    from repro_torch.serving.spec import EngineSpec
    plan = EngineSpec(arch="llama3.1-8b", quant="int4").resolve()
    cfg = plan.model_config()
    log(f"(g) plan: {plan.summary()}")
    log(f"(g) depth: {plan.provenance['depth']}")
    log(f"(g) host RAM (MemTotal): {host_mem_gb():.1f} GiB")
    reqs = paper_requests(np, cfg.vocab_size)
    eng, counts, summary, served = run_serving(torch, ops, "g", plan, reqs,
                                               "decode_attention",
                                               draws=draws)
    short = [(p, 4) for p, _ in reqs]
    summary["profiled"] = {"requests": PAPER_REQS, "max_new": 4, **busy_share(
        device_events(torch, lambda: serve_once(torch, ops, eng, short, 400)))}
    summary.update(
        host_mem_gb=host_mem_gb(), device_budget_gb=plan.device_budget / 2**30,
        modeled_device_gb=modeled_device_bytes(plan) / 2**30,
        params=cfg.param_count(), depth=eng.sched.depth,
        plan_depth=plan.depth,
        depth_provenance=plan.provenance["depth"])
    log(json.dumps({"paper_config": summary}))
    summary["whole_path"] = serving_whole_path(torch, ops, eng,
                                               [(p, 2) for p, _ in reqs])
    return eng, counts, summary, served


def head_margin(torch, eng, x):
    """(top-1 minus top-2 logit, top-1 id, top-2 id) of an offloaded
    engine's head on the hidden state ``x`` (1, d) of one position."""
    from repro_torch.models import layers as L
    xn = L.rms_norm(x, eng.resident["final_norm"]["scale"], eng.cfg.norm_eps)
    p = eng.resident["embed"]
    w = p["emb"].T if eng.cfg.tie_embeddings else p["w_out"]
    top = torch.topk((xn @ w)[0, :eng.cfg.vocab_size], 2)
    return ((top.values[0] - top.values[1]).item(),
            int(top.indices[0]), int(top.indices[1]))


def monolithic_head(torch, eng, tokens):
    """The hidden state at the last position of ``tokens`` after a
    monolithic b=1 prefill on ``eng`` (into free slot 0; its rows are
    overwritten by the next admission), as the head receives it."""
    import numpy as np
    from repro_torch.serving.base import Request
    seen = []
    head = eng._head
    eng._head = lambda x: (seen.append(x[:, -1].detach().clone()),
                           head(x))[1]
    try:
        eng._prefill_into_slot(0, Request(
            rid=-1, prompt=np.asarray(tokens, np.int32)))
    finally:
        del eng._head
    return seen[0]


def capture_chunk_heads(heads):
    """An ``on_build`` hook for ``run_serving``: records the hidden state
    the head receives at each chunked prompt's last position (the b=1
    head calls, in admission order)."""
    def hook(eng):
        head = eng._head

        def grab(x):
            if x.shape[0] == 1:
                heads.append(x[:, -1].detach().clone())
            return head(x)
        eng._head = grab
    return hook


def chunked_vs_monolithic(torch, eng, name, reqs, outs, heads, mono_outs):
    """Run ``name``'s chunked prefill against the monolithic engine's on
    the same weights: each prompt's last-position hidden state against a
    monolithic prefill on the same engine (fails above 1e-4 x max), the
    tokens against ``mono_outs``, and at the first token where they
    part, the monolithic path's logit margin there."""
    rel = []
    for (prompt, _), h in zip(reqs, heads):
        m = monolithic_head(torch, eng, prompt)
        if not torch.isfinite(h).all():
            raise RuntimeError(f"run {name}: non-finite hidden states")
        rel.append(((h - m).abs().max() / m.abs().max()).item())
    pairs = [(x, y) for i in outs for x, y in zip(outs[i], mono_outs[i])]
    res = {"hidden_rel_err": rel, "tolerance_rel": HIDDEN_RTOL,
           "tokens_compared": len(pairs),
           "tokens_equal": sum(x == y for x, y in pairs),
           "requests_equal": sum(outs[i] == mono_outs[i] for i in outs)}
    first = next(((i, k) for i in sorted(outs) for k, (x, y) in
                  enumerate(zip(outs[i], mono_outs[i])) if x != y), None)
    if first is not None:
        i, k = first
        prefix = list(reqs[i][0]) + mono_outs[i][:k]
        res["first_divergence"] = {
            "request": i, "token": k, "chunked": outs[i][k],
            "monolithic": mono_outs[i][k],
            "monolithic_logit_margin": head_margin(
                torch, eng, monolithic_head(torch, eng, prefix))}
    log(json.dumps({"chunked_vs_monolithic": {"run": name, **res}}))
    if len(heads) != len(reqs) or max(rel) > HIDDEN_RTOL:
        raise RuntimeError(f"run {name}: chunked prefill hidden states "
                           f"differ from monolithic: {rel}")
    return res


def run_chunked(torch, ops, np, g_outs, g_depth, draws):
    """Run (j): Llama-3.1-8B, INT4 weights, ``sched="online"`` (chunks of
    32) through ``EngineSpec.resolve`` and ``create_engine`` on (g)'s
    seed, built from (g)'s ``draws``; (g)'s 4 requests; against (g)'s
    tokens; the memory report,
    also at a 3.5 GiB device budget.  Returns the engine (run (k) drives
    it), its counts and summary."""
    from repro_torch.core.offload import MemoryBudget
    from repro_torch.serving.spec import EngineSpec
    spec = EngineSpec(arch="llama3.1-8b", quant="int4", sched="online")
    plan = spec.resolve()
    cfg = plan.model_config()
    log(f"(j) plan: {plan.summary()}; prefill_chunk: "
        f"{plan.provenance['prefill_chunk']}")
    if plan.prefill_chunk != 32 or plan.depth != g_depth:
        raise RuntimeError(f"run j: unexpected plan {plan.summary()}")
    reqs = paper_requests(np, cfg.vocab_size)
    heads = []
    eng, counts, summary, served = run_serving(
        torch, ops, "j", plan, reqs, "decode_attention",
        on_build=capture_chunk_heads(heads), draws=draws)
    del eng._head
    if counts["flash_attention_q_offset"] <= 0:
        raise RuntimeError("run j: no flash_attention launch with q_offset")
    summary["vs_g"] = chunked_vs_monolithic(torch, eng, "j", reqs,
                                            served["outs"], heads, g_outs)
    b35 = MemoryBudget(device=int(3.5 * 2**30))
    plan35 = spec.resolve(b35)
    peak = summary["device_max_allocated_gb"]
    summary.update(
        modeled_device_gb=modeled_device_bytes(plan) / 2**30,
        budget_3_5gib={
            "depth": plan35.depth, "depth_provenance":
            plan35.provenance["depth"],
            "same_plan_but_budget": dataclasses.replace(
                plan35, device_budget=plan.device_budget,
                provenance=plan.provenance) == plan,
            "budget_gb": b35.device / 2**30,
            "modeled_device_gb": modeled_device_bytes(plan35) / 2**30,
            "resident_breach_gb": summary["resident_gb"] - 3.5,
            "peak_breach_gb": peak - 3.5})
    log(json.dumps({"chunked_paper_config": summary}))
    return eng, counts, summary


def run_traffic(torch, ops, name, eng, atrace, rate):
    """Run (k): ``run_trace`` drives ``eng`` through the arrival trace on
    the wall clock; TTFT and TBT percentiles from the engine's trace
    report, tok/s over the run."""
    from repro_torch.serving.workload import run_trace
    torch.cuda.synchronize()
    ops.reset_launches()
    before = dict(eng.stats)
    t0 = time.perf_counter()
    done = run_trace(eng, atrace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    lat = eng.trace.report()["latency"]
    vocab = eng.cfg.vocab_size
    n = len(atrace.arrivals)
    if len(done) != n or any(
            len(r.out) != a.max_new or not all(0 <= t < vocab for t in r.out)
            for r, a in zip(sorted(done, key=lambda r: r.rid),
                            sorted(atrace.arrivals, key=lambda a: a.rid))):
        raise RuntimeError(f"run {name}: bad requests")
    toks = sum(len(r.out) for r in done)
    summary = {
        "run": name, "sched": eng.sched_policy.name,
        "rate_req_s": rate, "requests": n,
        "prompt_lens": [len(a.prompt) for a in atrace.arrivals],
        "wall_s": wall, "tokens_out": toks, "tok_s": toks / wall,
        **{f"{k}_{q}_s": lat[k][f"{q}_s"] for k in ("ttft", "tbt")
           for q in ("p50", "p99")},
        "stats": {k: eng.stats[k] - before.get(k, 0) for k in (
            "prefills", "prefill_chunks", "decode_steps", "tokens_out")},
        "launches": counts}
    log(json.dumps({"traffic": summary}))
    return counts, summary


def run_replay(torch, recs, g_plan_depth):
    """Run (l): replay the recorded traces of runs (b), (c) and (g) on
    the virtual clock (``core.replay``): the measured steady step beside
    the replay at the recorded knobs, in sequential mode and at depths
    1-8, each over the decode steps (the first decode step dropped, as
    ``steady_step_s`` drops a run's first step); then
    ``EngineSpec.resolve(trace=<(g)'s trace>)``."""
    from repro_torch.core.replay import (ReplayKnobs, best_depth, replay,
                                         steady_step_s, step_boundaries)
    from repro_torch.serving.spec import EngineSpec
    out = {}
    for name, (trace, start) in recs.items():
        b = step_boundaries(trace)[start:]
        measured = (b[-1] - b[0]) / (len(b) - 1)
        rec = replay(trace, start_iter=start)
        seq = replay(trace, ReplayKnobs(mode="sequential"), start_iter=start)
        best, preds = best_depth(trace, depth_cap=8, start_iter=start)
        out[name] = {
            "recorded": {k: trace.meta.get(k) for k in (
                "mode", "warm", "depth", "pool_size", "quant", "kv_mode")},
            "steady_step_s_ms": 1e3 * steady_step_s(trace),
            "decode_steps": len(b), "measured_step_ms": 1e3 * measured,
            "replay_recorded_ms": 1e3 * rec.steady_step_s,
            "gap_ms": 1e3 * (measured - rec.steady_step_s),
            "replay_sequential_ms": 1e3 * seq.steady_step_s,
            "replay_depth_ms": {d: 1e3 * t for d, t in preds.items()},
            "best_depth": best}
    if "b" in out and "c" in out:
        out["b_vs_c"] = {
            "b_predicted_sequential_ms": out["b"]["replay_sequential_ms"],
            "c_measured_ms": out["c"]["measured_step_ms"],
            "c_replay_recorded_ms": out["c"]["replay_recorded_ms"]}
    plan = EngineSpec(arch="llama3.1-8b", quant="int4").resolve(
        trace=recs["g"][0])
    out["resolve_g"] = {"depth": plan.depth,
                        "provenance": plan.provenance["depth"],
                        "memory_model_depth": g_plan_depth}
    if not plan.provenance["depth"].startswith("replay:"):
        raise RuntimeError(f"run l: resolve(trace=...) did not replay: "
                           f"{plan.provenance['depth']}")
    log(json.dumps({"replay": out}))
    return out


def run_cli(torch, ops):
    """Run (h): ``launch.serve.main`` in-process at full width; the depth
    the adaptive window chose at each decode step is recorded by wrapping
    ``PipelineScheduler.set_depth`` for the call."""
    import io
    from repro_torch.core.pipeline import PipelineScheduler
    from repro_torch.launch import serve
    depths, orig = [], PipelineScheduler.set_depth

    def set_depth(self, depth):
        depths.append(orig(self, depth))
        return depths[-1]

    out = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()
    PipelineScheduler.set_depth = set_depth
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            eng = serve.main(CLI_ARGV)
    finally:
        PipelineScheduler.set_depth = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    text = out.getvalue()
    for line in text.splitlines():
        log(f"(h) {line}")
    n, st = eng.cfg.num_layers, eng.stats
    if "completed=8 " not in text or "pipeline[performance] depth=" not in text:
        raise RuntimeError(f"run h: the CLI printed {text!r}")
    check_launches("h", counts, {
        "flash_attention": n * st["prefills"],
        "decode_attention_int4": n * st["decode_steps"],
        "decode_attention": 0,
        "int4_matmul": 7 * n * (st["prefills"] + st["decode_steps"])},
        exact=True)
    if len(depths) != st["decode_steps"] or not all(1 <= d <= 8
                                                    for d in depths):
        raise RuntimeError(f"run h: depths {depths} over "
                           f"{st['decode_steps']} decode steps")
    summary = {"run": "h", "argv": CLI_ARGV, "wall_s": wall,
               "stats": st, "depth_per_step": depths, "launches": counts}
    log(json.dumps({"cli": summary}))
    return counts, summary


def logit_margin(torch, eng, tokens):
    """(top-1 minus top-2 logit, top-1 id, top-2 id) of ``eng``'s model
    (a resident engine) at the last position of ``tokens``."""
    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    t = torch.tensor(np.asarray(tokens, np.int32)[None], device=eng.dev)
    ctx = L.Ctx(cfg=eng.cfg, mode="prefill", angles=T._angles(
        eng.cfg, torch.arange(t.shape[1], device=eng.dev)))
    x, _ = T._run_stack(eng.params, L.embed_tokens(eng.params["embed"], t),
                        ctx, None, eng.cfg)
    x = L.rms_norm(x[:, -1], eng.params["final_norm"]["scale"],
                   eng.cfg.norm_eps)
    p = eng.params["embed"]
    w = p["emb"].T if eng.cfg.tie_embeddings else p["w_out"]
    top = torch.topk((x @ w)[0, :eng.cfg.vocab_size], 2)
    return ((top.values[0] - top.values[1]).item(),
            int(top.indices[0]), int(top.indices[1]))


def run_resident(torch, ops, reqs):
    """Run (i): the resident engine through ``EngineSpec.resolve`` ->
    ``create_engine``; its whole path against ``use_kernels(False)`` (the
    final hidden states of a prefill and of a decode step, caught at the
    head); its tokens against the offloaded engine's on the same weights
    (both draw them from the plan's seed)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec import EngineSpec, create_engine
    plan = EngineSpec(arch="tinyllama-1.1b").resolve()
    log(f"(i) plan: {plan.summary()}; engine: {plan.provenance['engine']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if type(eng) is not ServingEngine:
        raise RuntimeError(f"run i: built {type(eng).__name__}")
    r = serve_once(torch, ops, eng, reqs, 0)
    n, st = eng.cfg.num_layers, r["stats"]
    check_launches("i", r["counts"], {
        "flash_attention": n * st["prefills"],
        "decode_attention": n * st["decode_steps"],
        "decode_attention_int4": 0, "int4_matmul": 0}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != m for i, (_, m) in enumerate(reqs)):
        raise RuntimeError(f"run i: bad tokens {outs}")
    steps_ms = sorted(1e3 * x for x in r["steps"])
    summary = {"run": "i", "plan": plan.summary(), "build_s": build_s,
               **st, "wall_s": r["wall"], "tok_s": st["tokens_out"] / r["wall"],
               "step_ms_median": statistics.median(steps_ms),
               "step_ms_p90": steps_ms[int(0.9 * (len(steps_ms) - 1))],
               "device_max_allocated_gb": r["device_max_allocated_gb"],
               "launches": r["counts"]}
    summary["profiled"] = {"requests": B, "max_new": 8, **busy_share(
        device_events(torch, lambda: serve_once(
            torch, ops, eng, [(p, 8) for p, _ in reqs[:B]], 400)))}

    # kernels vs plain: hidden states at the head, prefill and decode
    seen, head = [], T._head

    def grab(params, x, cfg):
        seen.append(x[:, -1].detach().clone())
        return head(params, x, cfg)

    T._head = grab
    try:
        short = [(p, 2) for p, _ in reqs[:B]]
        serve_once(torch, ops, eng, short, 200)
        hk, seen[:] = list(seen), []
        ops.use_kernels(False)
        serve_once(torch, ops, eng, short, 300)
        hp = list(seen)
    finally:
        ops.use_kernels(True)
        T._head = head
    whole = {}
    for phase, a, b in (("prefill", hk[0], hp[0]),
                        ("decode", hk[B], hp[B])):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"run i {phase}: non-finite hidden states")
        whole[phase + "_rel_err"] = ((a - b).abs().max()
                                     / b.abs().max()).item()
    whole["tolerance_rel"] = {"prefill": HIDDEN_RTOL,
                              "decode": BF16_HIDDEN_RTOL}
    # the use_kernels(False) arm over all of (i)'s requests on the same
    # engine and weights: each request's first token equal, the equal
    # tokens counted; no launch in it; then the ops' own casts in a
    # profiled short serve (4 prefills, 1 decode step): none
    ops.use_kernels(False)
    try:
        rpl = serve_once(torch, ops, eng, reqs, 700)
    finally:
        ops.use_kernels(True)
    op_ = rpl["outs"]
    whole["plain_arm"] = {
        "launches": sum(rpl["counts"].values()),
        "first_tokens_equal": all(outs[i][0] == op_[i][0] for i in outs),
        "tokens_compared": sum(len(outs[i]) for i in outs),
        "tokens_equal": sum(x == y for i in outs
                            for x, y in zip(outs[i], op_[i]))}
    prof = op_casts(torch, ops, lambda: serve_once(torch, ops, eng, short,
                                                   800))
    whole["op_casts"], whole["profiled_serve_device_ms"] = \
        prof["casts"], prof["device_ms"]
    log(json.dumps({"resident_whole_path": whole}))
    if whole["prefill_rel_err"] > HIDDEN_RTOL \
            or whole["decode_rel_err"] > BF16_HIDDEN_RTOL \
            or whole["plain_arm"]["launches"] \
            or not whole["plain_arm"]["first_tokens_equal"] \
            or whole["op_casts"]:
        raise RuntimeError(f"run i: kernels differ from plain: {whole}")

    # the offloaded engine on the same weights (same seed), same requests
    oplan = EngineSpec(arch="tinyllama-1.1b", offload=True).resolve()
    oeng = create_engine(oplan)
    ro = serve_once(torch, ops, oeng, reqs, 0)
    oeng.shutdown()
    pairs = [(x, y) for i in outs for x, y in zip(outs[i], ro["outs"][i])]
    agree = {"offloaded_plan": oplan.summary(),
             "tokens_compared": len(pairs),
             "tokens_equal": sum(x == y for x, y in pairs),
             "requests_equal": sum(outs[i] == ro["outs"][i] for i in outs)}
    first = next(((i, k) for i in sorted(outs) for k, (x, y) in
                  enumerate(zip(outs[i], ro["outs"][i])) if x != y), None)
    if first is not None:
        i, k = first
        prefix = list(reqs[i][0]) + outs[i][:k]
        agree["first_divergence"] = {
            "request": i, "step": k, "resident": outs[i][k],
            "offloaded": ro["outs"][i][k],
            "resident_logit_margin": logit_margin(torch, eng, prefix)}
    summary["vs_offloaded"] = agree
    log(json.dumps({"resident": summary}))
    eng.shutdown()
    return r["counts"], summary


# ---------------------------------------------------------------------------
# speculative decoding (runs m, b') and pipeline stages (run n)
# ---------------------------------------------------------------------------

class RandomProposer:
    """A draft stand-in proposing seeded random tokens: nearly every
    proposal is rejected, so every verify pass truncates."""

    def __init__(self, vocab: int, seed: int = 0):
        import numpy as np
        self.vocab, self.rng = vocab, np.random.default_rng(seed)

    def prefill_slot(self, slot, prompt):
        pass

    def prefill_batch(self, tokens):
        pass

    def propose(self, tokens, pos, k):
        return self.rng.integers(0, self.vocab, (len(pos), k)).astype(
            "int32")


class OracleProposer(RandomProposer):
    """Proposals read from recorded token streams, so the target accepts
    every one: ``streams`` is a list of (prompt, emitted tokens); a
    serving slot finds its stream by its prompt at admission, a batch row
    ``r`` takes stream ``r``.  At a step from ``pos`` the last emitted
    token (stream index ``pos - len(prompt)``) is the verify input, so
    the next proposal is the token after it."""

    def __init__(self, streams):
        super().__init__(1)
        self.streams = [(list(map(int, p)), list(map(int, o)))
                        for p, o in streams]
        self.slot = {}

    def prefill_slot(self, slot, prompt):
        for p, out in self.streams:
            if p == list(map(int, prompt)):
                self.slot[slot] = (len(p), out)

    def prefill_batch(self, tokens):
        self.slot = {r: (len(p), out)
                     for r, (p, out) in enumerate(self.streams)}

    def propose(self, tokens, pos, k):
        import numpy as np
        out = np.zeros((len(pos), k), np.int32)
        for r, (plen, st) in self.slot.items():
            idx = int(pos[r]) - plen + 1
            for t in range(k):
                if 0 <= idx + t < len(st):
                    out[r, t] = st[idx + t]
        return out


def spec_summary(stats, steps, wall, extra=None) -> dict:
    """The speculative counters of one arm, with the draft's seconds per
    verify step (median, p90)."""
    draft = sorted(1e3 * s["draft_s"] for s in steps)
    return {"spec_steps": stats["spec_steps"],
            "accepted": stats["spec_accepted"],
            "proposed": stats["spec_proposed"],
            "accept_rate": stats["spec_accepted"]
            / max(1, stats["spec_proposed"]),
            "primed_per_step": statistics.median(s["primed"] for s in steps)
            if steps else 0,
            "draft_ms_median": statistics.median(draft) if draft else 0.0,
            "draft_ms_p90": draft[int(0.9 * (len(draft) - 1))]
            if draft else 0.0, "wall_s": wall, **(extra or {})}


def verify_whole_path(torch, ops, name, eng, run, tol):
    """Kernels vs ``use_kernels(False)`` on the speculative verify pass,
    same engine and weights: ``run()`` drives ``eng`` (an oracle draft
    attached, so both runs get the same proposals) through its first
    verify step and returns the tokens emitted before it.  The final
    hidden states of all k+1 positions of that step are held at ``tol``
    x max|plain| when both runs fed it the same tokens (as
    ``whole_path_check`` holds its decode step)."""
    seen = []
    orig = eng.finalize

    def grab(i, x):
        if (eng._phase == "decode" and isinstance(x, torch.Tensor)
                and x.shape[1] > 1):
            seen.append(x.detach().clone())
        return orig(i, x)

    eng.finalize = grab
    try:
        ops.use_kernels(True)
        first_k = run()
        hk, seen[:] = list(seen), []
        ops.use_kernels(False)
        first_p = run()
        hp = list(seen)
    finally:
        ops.use_kernels(True)
        eng.finalize = orig
    torch.cuda.synchronize()
    if not hk or not hp:
        raise RuntimeError(f"run {name}: no verify pass was run")
    a, b = hk[0], hp[0]
    if not torch.isfinite(a).all():
        raise RuntimeError(f"run {name}: non-finite verify hidden states")
    res = {"run": name, "positions": int(a.shape[1]),
           "rel_err": ((a - b).abs().max() / b.abs().max()).item(),
           "rel_err_by_position": [
               ((a[:, t] - b[:, t]).abs().max() / b.abs().max()).item()
               for t in range(a.shape[1])],
           "inputs_equal": bool(first_k == first_p), "tolerance_rel": tol}
    log(json.dumps({"verify_whole_path": res}))
    if res["inputs_equal"] and res["rel_err"] > tol:
        raise RuntimeError(f"run {name}: verify hidden states differ: {res}")
    return res


def run_spec_lm(torch, ops, name, lm, prompt, toks):
    """Run (b'): on run ``name``'s engine and weights (no new build),
    attach a seeded random proposer (rejections) and then an oracle built
    from the run's own tokens (full acceptance), ``SPEC_K`` proposals a
    step; each arm's tokens must equal the non-speculative run's, and its
    launches are exact: flash = layers, the decode kernel = layers x (the
    verify rows + the plain steps), int4_matmul = 7 x layers x passes.
    Then the verify pass against ``use_kernels(False)`` (hidden states
    at 1e-4 x max over f32 KV, 2e-2 x max over packed KV)."""
    from repro_torch.core.tasks import Trace
    decode = ("decode_attention_int4" if lm.kv_mode == "int4"
              else "decode_attention")
    n = lm.cfg.num_layers
    out = {}
    for arm, draft in (("random", RandomProposer(lm.cfg.vocab_size, 0)),
                       ("oracle", OracleProposer(zip(prompt, toks)))):
        lm.attach_draft(draft, SPEC_K)
        lm.trace = Trace()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        got, stats = lm.generate(prompt, GEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        steps = lm.trace.meta["spec_steps"]
        passes = len(lm.trace.meta["calls"])      # prefill + decode steps
        verify_rows = sum(s["k"] + 1 for s in steps)
        plain_steps = passes - 1 - len(steps)
        out[arm] = spec_summary(stats, steps, wall, {
            "tokens_equal": int((got == toks).sum()),
            "tokens": int(toks.size), "decode_tok_s": stats["decode_tok_s"],
            "verify_rows": verify_rows, "plain_steps": plain_steps,
            "launches": counts})
        if not (got == toks).all():
            raise RuntimeError(f"run {name}' {arm}: speculative tokens "
                               f"differ from the run's: {out[arm]}")
        check_launches(f"{name}' {arm}", counts, {
            "flash_attention": n, decode: n * (verify_rows + plain_steps),
            "int4_matmul": 7 * n * passes if lm.quant == "int4" else 0},
            exact=True)
    # the oracle stays attached: one verify step of SPEC_K proposals
    out["whole_path"] = verify_whole_path(
        torch, ops, name + "'", lm,
        lambda: lm.generate(prompt, SPEC_K + 2)[0][:, 0].tolist(),
        BF16_HIDDEN_RTOL if lm.kv_mode == "int4" else HIDDEN_RTOL)
    log(json.dumps({"spec_lm": {"run": name + "'", **out}}))
    return out


def spec_serve(torch, ops, eng, reqs, rid0):
    """``serve_once`` with the draft's own launches (its prefills and
    proposals) counted apart, so the rest are the target's."""
    draft = eng.draft
    mine = {k: 0 for k in ops.LAUNCHES}
    wrapped = {}
    for meth in ("prefill_slot", "propose"):
        fn = getattr(draft, meth)

        def counted(*a, _fn=fn):
            before = dict(ops.LAUNCHES)
            r = _fn(*a)
            for k in mine:
                mine[k] += ops.LAUNCHES[k] - before.get(k, 0)
            return r
        wrapped[meth] = counted
        setattr(draft, meth, counted)
    try:
        r = serve_once(torch, ops, eng, reqs, rid0)
    finally:
        for meth in wrapped:
            delattr(draft, meth)
    r["draft_launches"] = mine
    return r


def run_spec_paper(torch, ops, np, g_summary, g_outs, draws):
    """Run (m): Llama-3.1-8B, INT4 weights, with the llama3.2-1b draft
    through ``EngineSpec(..., draft_arch=...).resolve()`` and
    ``create_engine`` on (g)'s seed (from (g)'s ``draws``); (g)'s 4
    requests with the real draft
    (random weights: about no acceptance), then, on the same engine, an
    oracle proposer built from (g)'s streams (full acceptance).  Each
    arm's tokens must equal (g)'s; the target's launches are exact
    (flash = layers x prefills, decode_attention = layers x (verify rows
    + plain steps), int4_matmul = 7 x layers x passes) and the draft's
    counted apart.  Prints per arm the acceptance, step median/p90,
    tok/s beside (g)'s and the draft's time per step; and peak device
    memory beside the plan's budget, the memory model's estimate, the
    resident bytes and the draft's.  Then, with the oracle, the verify
    pass against ``use_kernels(False)``: hidden states at 2e-2 x max (bf16
    caches, as run (g)'s decode step)."""
    from repro_torch.core.draft import ResidentDraft
    from repro_torch.serving.spec import EngineSpec, create_engine
    plan = EngineSpec(arch="llama3.1-8b", quant="int4",
                      draft_arch="llama3.2-1b").resolve()
    log(f"(m) plan: {plan.summary()}; spec_k: {plan.provenance.get('spec_k')}")
    # phase 3 checks the draft's decode over a MAX_LEN slab
    if (plan.spec_k != SPEC_K or plan.depth != g_summary["plan_depth"]
            or plan.max_len != MAX_LEN):
        raise RuntimeError(f"run m: unexpected plan {plan.summary()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = create_engine(plan, draws=draws)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not isinstance(eng.draft, ResidentDraft):
        raise RuntimeError(f"run m: draft {type(eng.draft).__name__}")
    reqs = paper_requests(np, eng.cfg.vocab_size)
    n, nd = eng.cfg.num_layers, eng.draft.cfg.num_layers
    draft_gb = eng.draft.nbytes / 2**30
    summary = {"run": "m", "plan": plan.summary(), "build_s": build_s,
               "build_device_peak_gb":
               torch.cuda.max_memory_allocated() / 2**30,
               "g_tok_s": g_summary["tok_s"],
               "g_step_ms_median": g_summary["step_ms_median"]}
    arms = (("real_draft", None),
            ("oracle", OracleProposer(
                [(p, g_outs[i]) for i, (p, _) in enumerate(reqs)])))
    for rid0, (arm, proposer) in enumerate(arms):
        if proposer is not None:
            eng.attach_draft(proposer, SPEC_K)
        before = dict(eng.stats)
        mark = len(eng.trace.meta.get("spec_steps", []))
        r = spec_serve(torch, ops, eng, reqs, 100 * rid0)
        steps = eng.trace.meta["spec_steps"][mark:]
        st = {k: eng.stats[k] - before.get(k, 0) for k in (
            "spec_steps", "spec_proposed", "spec_accepted")}
        dl, c = r["draft_launches"], r["counts"]
        verify_rows = sum(s["k"] + 1 for s in steps)
        plain_steps = r["stats"]["decode_steps"] - len(steps)
        passes = r["stats"]["prefills"] + r["stats"]["decode_steps"]
        target = {k: c[k] - dl[k] for k in c}
        equal = sum(x == y for i in g_outs
                    for x, y in zip(r["outs"][i], g_outs[i]))
        steps_ms = sorted(1e3 * x for x in r["steps"])
        summary[arm] = spec_summary(st, steps, r["wall"], {
            "tokens_equal": equal,
            "tokens": sum(len(o) for o in g_outs.values()),
            "tok_s": r["stats"]["tokens_out"] / r["wall"],
            "step_ms_median": statistics.median(steps_ms),
            "step_ms_p90": steps_ms[int(0.9 * (len(steps_ms) - 1))],
            "ttft_s": r["ttft_s"], **r["stats"],
            "verify_rows": verify_rows, "plain_steps": plain_steps,
            "verify_launches": {
                "decode_attention": target["decode_attention"],
                "int4_matmul": target["int4_matmul"]
                - 7 * n * r["stats"]["prefills"]},
            "target_launches": target, "draft_launches": dl,
            "device_max_allocated_gb": r["device_max_allocated_gb"]})
        if r["outs"] != g_outs:
            raise RuntimeError(f"run m {arm}: tokens differ from (g)'s: "
                               f"{equal} of {summary[arm]['tokens']}")
        check_launches(f"m {arm}", target, {
            "flash_attention": n * r["stats"]["prefills"],
            "decode_attention": n * (verify_rows + plain_steps),
            "decode_attention_int4": 0, "int4_matmul": 7 * n * passes},
            exact=True)
        if proposer is None:
            check_launches("m draft", dl, {
                "flash_attention": nd * r["stats"]["prefills"],
                "decode_attention": nd * sum(s["k"] for s in steps),
                "decode_attention_int4": 0, "int4_matmul": 0}, exact=True)
        summary.setdefault("launches", {k: c[k] for k in c})
    if summary["oracle"]["accepted"] != summary["oracle"]["proposed"]:
        raise RuntimeError(f"run m: the oracle was not fully accepted: "
                           f"{summary['oracle']}")
    # the oracle stays attached: every request's prefill, then a verify
    # step of SPEC_K proposals (the base class caps what it emits)
    short = [(p, SPEC_K + 1) for p, _ in reqs]
    summary["whole_path"] = verify_whole_path(
        torch, ops, "m", eng, lambda: [
            o[0] for _, o in sorted(serve_once(
                torch, ops, eng, short, 400)["outs"].items())],
        BF16_HIDDEN_RTOL)
    summary["memory"] = {
        "device_max_allocated_gb": max(summary[a]["device_max_allocated_gb"]
                                       for a, _ in arms),
        "build_device_peak_gb": summary["build_device_peak_gb"],
        "device_budget_gb": plan.device_budget / 2**30,
        "modeled_device_gb": modeled_device_bytes(plan) / 2**30,
        "resident_gb": eng.resident_bytes / 2**30,
        "draft_gb": draft_gb}
    log(json.dumps({"spec_paper_config": summary}))
    eng.shutdown()
    return summary["launches"], summary


def run_staged_paper(torch, ops, np, g_summary, g_outs, draws):
    """Run (n): (g)'s spec with ``stages=2``: two stages on one card, each
    with its own stores, pool and window, built from (g)'s ``draws``;
    (g)'s requests; tokens must
    equal (g)'s (launch counts exact, as in (g)).  Prints the step
    median, each stage's weight-load busy time and ``stage_bubbles``."""
    from repro_torch.core.tasks import _merged_busy
    from repro_torch.serving.spec import EngineSpec
    plan = EngineSpec(arch="llama3.1-8b", quant="int4", stages=2).resolve()
    log(f"(n) plan: {plan.summary()}; stages: {plan.provenance['stages']}")
    reqs = paper_requests(np, plan.model_config().vocab_size)
    eng, counts, summary, served = run_serving(torch, ops, "n", plan, reqs,
                                               "decode_attention",
                                               draws=draws)
    equal = sum(x == y for i in g_outs
                for x, y in zip(served["outs"][i], g_outs[i]))
    evs = served["trace"].events()
    summary.update(
        stage_bounds=eng.stage_bounds, stage_depths=eng._stage_depths,
        stage_devices=[str(d) for d in eng.stage_devs],
        stage_plan=[dataclasses.asdict(p) for p in plan.stage_plan],
        weight_load_busy_s_by_stage={s: _merged_busy(
            (e.t_start, e.t_end) for e in evs
            if e.kind == "weight_load" and e.stage == s)
            for s in range(eng.n_stages)},
        stage_bubbles=served["trace"].report().get("stage_bubbles"),
        tokens_equal=equal, g_tok_s=g_summary["tok_s"],
        g_step_ms_median=g_summary["step_ms_median"])
    log(json.dumps({"staged_paper_config": summary}))
    eng.shutdown()
    if served["outs"] != g_outs or eng.n_stages != 2:
        raise RuntimeError(f"run n: tokens differ from (g)'s: {equal} of "
                           f"{sum(len(o) for o in g_outs.values())}")
    return counts, summary


# ---------------------------------------------------------------------------
# MoE: (o) Mixtral-8x7B serving with routed-union streaming, (p) batch
# generation on Mixtral cut to one layer
# ---------------------------------------------------------------------------

def int4_nbytes(K: int, N: int) -> int:
    """Packed bytes of one INT4 (K, N) matrix at group 128: nibbles and
    f32 scales."""
    return K * N // 2 + 4 * (K // 128) * N


def moe_store_bytes(cfg) -> int:
    """Bytes of the INT4 weight store of an MoE stack: every layer's
    experts and its attention projections (norms and routers aside)."""
    d, f, m = cfg.d_model, cfg.moe.expert_d_ff, cfg.moe
    expert = 2 * int4_nbytes(d, f) + int4_nbytes(f, d)
    attn = (2 * int4_nbytes(d, cfg.num_heads * cfg.head_dim)
            + 2 * int4_nbytes(d, cfg.num_kv_heads * cfg.head_dim))
    return cfg.num_layers * (m.num_experts * expert + attn)


def peak_rss_gb() -> float:
    """This process's peak resident set so far, in GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def run_moe_paper(torch, ops, np):
    """Run (o): Mixtral-8x7B at full width with its depth cut to
    ``MOE_LAYERS`` layers, INT4, through ``EngineSpec.resolve`` and
    ``create_engine`` on the default budget with ``placement="disk"``
    (the whole model's plan; the cut store would fit the host), the disk
    tier under a fresh temporary directory (a host budget instead when
    that disk cannot hold the store); (g)'s prompts with ``MOE_NEW`` new
    tokens each;
    per-step routed unions, exact launch counts, union-only expert
    bytes, then the whole path against ``use_kernels(False)``."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.offload import MemoryBudget
    from repro_torch.serving.spec import EngineSpec
    root = tempfile.mkdtemp(prefix="pipo_moe_")
    try:
        cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                                  num_layers=MOE_LAYERS,
                                  num_periods=MOE_LAYERS)
        spec = EngineSpec(arch="mixtral-8x7b", cfg=cfg, quant="int4",
                          placement="disk", disk_root=root)
        plan = spec.resolve()
        cfg = plan.model_config()
        need = moe_store_bytes(cfg)
        free = shutil.disk_usage(root).free
        log(f"(o) plan: {plan.summary()}")
        log(f"(o) placement: {plan.provenance['placement']}")
        log(f"(o) INT4 store {need / 1e9:.2f} GB; free under {root}: "
            f"{free / 1e9:.1f} GB; host RAM (MemTotal) "
            f"{host_mem_gb():.1f} GiB")
        if plan.placement == "disk" and free < need + 4 * 2**30:
            plan = spec.resolve(MemoryBudget(host=2 * need))
            log(f"(o) disk short: host budget {2 * need / 2**30:.1f} GiB "
                f"-> {plan.summary()}")
        summary, r, eng = serve_moe(torch, ops, np, plan)
        summary["whole_path"] = moe_whole_path(
            torch, ops, np, eng, [(r["reqs"][0][0], 2)])
        eng.shutdown()
        return summary["launches"], summary
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serve_moe(torch, ops, np, plan):
    """Build (o)'s engine, serve its requests once and check them.
    Returns the summary, the served run and the engine (still up)."""
    from repro_torch.serving.spec import create_engine
    cfg = plan.model_config()
    n, E = cfg.num_layers, cfg.moe.num_experts
    reqs = [(p, MOE_NEW) for p, _ in paper_requests(np, cfg.vocab_size)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"(o) built in {build_s:.1f} s; peak RSS {peak_rss_gb():.1f} GiB")
    moe_units = [u for u in eng.units if u.moe]
    keys = [k for u in moe_units for k in u.expert_keys]
    per = {eng.weights.nbytes(k) for k in keys}
    if len(moe_units) != n or len(keys) != n * E or len(per) != 1:
        raise RuntimeError(f"run o: {len(moe_units)} MoE units, "
                           f"{len(keys)} experts, sizes {per}")
    per_expert = per.pop()
    steps, snap = [], [dict(eng.weights.load_counts), dict(eng.stats)]

    def on_step():
        now, st = dict(eng.weights.load_counts), dict(eng.stats)
        prev, pst = snap
        steps.append({
            "prefills": st["prefills"] - pst["prefills"],
            "decode": st["decode_steps"] - pst["decode_steps"],
            "experts_per_layer": [
                sum(now.get(k, 0) - prev.get(k, 0) for k in u.expert_keys)
                for u in moe_units]})
        snap[:] = [now, st]

    n0 = len(eng.trace.events())
    r = serve_once(torch, ops, eng, reqs, 0, on_step=on_step)
    r["reqs"] = reqs
    st = r["stats"]
    passes = st["prefills"] + st["decode_steps"]
    loads = sum(sum(s["experts_per_layer"]) for s in steps)
    check_launches("o", r["counts"], {
        "flash_attention": n * st["prefills"], "flash_attention_q_offset": 0,
        "decode_attention": n * st["decode_steps"],
        "decode_attention_int4": 0,
        "int4_matmul": 3 * loads + 4 * n * passes}, exact=True)
    evs = eng.trace.events()[n0:]
    expert_bytes = sum(e.nbytes for e in evs
                       if e.kind == "weight_load" and "/exp[" in e.name)
    bank = passes * n * E * per_expert
    if expert_bytes != loads * per_expert or not expert_bytes < bank:
        raise RuntimeError(f"run o: expert bytes {expert_bytes}, loads "
                           f"{loads} x {per_expert}, bank {bank}")
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != MOE_NEW or not all(0 <= t < cfg.vocab_size
                                               for t in outs[i])
            for i in range(len(reqs))):
        raise RuntimeError(f"run o: bad tokens {outs}")
    decode_steps = [(1e3 * t, s) for t, s in zip(r["steps"], steps)
                    if s["decode"] and not s["prefills"]]
    ms = sorted(t for t, _ in decode_steps)
    unions = [u for _, s in decode_steps for u in s["experts_per_layer"]]
    base_bytes = eng.weights.nbytes(moe_units[0].key)
    report = eng.pipeline_report()
    pk = report["per_kind"]
    summary = {
        "run": "o", "plan": plan.summary(), "build_s": build_s,
        "peak_rss_gb": peak_rss_gb(), "host_mem_gb": host_mem_gb(),
        "store_gb": moe_store_bytes(cfg) / 1e9,
        "per_expert_bytes": per_expert, "unit_base_bytes": base_bytes,
        "requests": len(reqs), "prompt_lens": [len(p) for p, _ in reqs],
        "max_new": MOE_NEW, **st, "wall_s": r["wall"],
        "tok_s": st["tokens_out"] / r["wall"],
        "steps": [{"ms": 1e3 * t, **s} for t, s in zip(r["steps"], steps)],
        "decode_step_ms_median": statistics.median(ms),
        "decode_step_ms_p90": ms[int(0.9 * (len(ms) - 1))],
        "decode_union_mean": statistics.mean(unions),
        "decode_union_hist": {k: unions.count(k) for k in range(E + 1)
                              if unions.count(k)},
        "decode_step_link_gb": (statistics.mean(
            sum(s["experts_per_layer"]) for _, s in decode_steps)
            * per_expert + n * base_bytes) / 1e9,
        "expert_loads": loads, "expert_bytes": expert_bytes,
        "bank_bytes_if_whole": bank,
        "moe_stack_bytes": eng.stats["moe_stack_bytes"],
        "busy_s": {k: pk[k]["busy_s"] for k in pk},
        "bytes": {k: pk[k]["bytes"] for k in pk},
        "compute_busy": eng.trace.busy_fraction("compute"),
        "device_max_allocated_gb": r["device_max_allocated_gb"],
        "device_allocated_at_start_gb": r["device_allocated_at_start_gb"],
        "device_budget_gb": plan.device_budget / 2**30,
        "modeled_device_gb": modeled_device_bytes(plan) / 2**30,
        "resident_gb": eng.resident_bytes / 2**30,
        "launches": r["counts"]}
    log(json.dumps({"moe_serving": summary}))
    return summary, r, eng


@contextlib.contextmanager
def f32_probabilities():
    """Within it, the plain decode attention reads the cached rows
    upcast to f32, so its probabilities stay f32 where the plain version
    rounds them to the cache dtype (``attn_partials``, as the
    reference): over bf16 caches, the arithmetic the decode kernels do,
    on the same cached values.  ``ops`` reaches the plain version through
    its module on every call."""
    from repro_torch.kernels import ref
    orig = ref.decode_attention_ref
    ref.decode_attention_ref = lambda q, kc, vc, pos: orig(
        q, kc.float(), vc.float(), pos)
    try:
        yield
    finally:
        ref.decode_attention_ref = orig


def moe_whole_path(torch, ops, np, eng, reqs, run="o", third=None):
    """(o)'s kernels against use_kernels(False) on its weights: the
    hidden states of the first prefill and of the first decode step.
    The reference arm is the plain versions with the decode
    probabilities kept f32 (``f32_probabilities``), on its own routing,
    each gate's top-k ids recorded (``eng.route``).  The kernel arm
    takes those ids (its router weights from its own logits at them) and
    counts the rows where its own top-k chose other experts: routing is
    discontinuous, so a rounding difference can flip a near-tied choice,
    after which the arms compute different functions.  Check: flipped
    rows at most ``MOE_FLIP_SHARE`` of the routed rows, the prefill
    within 1e-4 x max, the decode step over the bf16 caches (each arm
    fills its own) within 2e-2 x max.  A third arm, the plain versions
    as they are (bf16-rounded probabilities) on the same held routing,
    is a reading: on weights drawn at the reference's 1/sqrt(E) that
    rounding alone moves the decode step by about 1.4e-2 x max (ROADMAP
    Queue 3 item 7).  ``third``: another ``(name, kernels, context)``
    reading in its place (run t's: the kernels with ``flash_attention``
    plain, which shows what ``int4_matmul`` alone moves).  ``run`` names
    the run in messages and its printed line (``mla_whole_path`` for
    run t's DeepSeek-V3, ``jamba_whole_path`` for run v's jamba, else
    ``moe_whole_path``)."""
    from repro_torch.models.moe import router_topk
    seen, ref_ids, flips = [], [], []
    orig = eng.finalize

    def grab(i, x):
        seen.append((eng._phase, x.detach().clone()))
        return orig(i, x)

    def record(key, logits, k):
        w, ids = router_topk(logits, k)
        ref_ids.append((key, ids))
        return w, ids

    def hold(key, logits, k):
        ref_key, ids = ref_ids[len(flips)]
        if ref_key != key:
            raise RuntimeError(f"run {run}: gate {key} where the "
                               f"reference arm ran {ref_key}")
        _, own = router_topk(logits, k)
        flips.append(int((torch.sort(own, -1)[0] != torch.sort(ids, -1)[0]
                          ).any(-1).sum()))
        return torch.softmax(logits.gather(-1, ids), -1), ids

    def arm(kernels, ctx, route, rid0):
        seen[:], flips[:] = [], []
        ops.use_kernels(kernels)
        eng.route = route
        with ctx:
            r = serve_once(torch, ops, eng, reqs, rid0)
        if route is hold and len(flips) != len(ref_ids):
            raise RuntimeError(f"run {run}: {len(flips)} gates, the "
                               f"reference arm ran {len(ref_ids)}")
        return r["outs"], {ph: next(x for p, x in seen if p == ph)
                           for ph in ("prefill", "decode")}, list(flips)

    name3, kernels3, ctx3 = third or ("plain", False,
                                      contextlib.nullcontext())
    default_route = eng.route
    eng.finalize = grab
    try:
        w_outs, w_h, _ = arm(False, f32_probabilities(), record, 200)
        arms = {"kernels": arm(True, contextlib.nullcontext(), hold, 300),
                name3: arm(kernels3, ctx3, hold, 400)}
    finally:
        ops.use_kernels(True)
        eng.finalize = orig
        eng.route = default_route

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    rows = sum(int(ids.shape[0]) for _, ids in ref_ids)
    res = {"reference": "plain versions, f32 decode probabilities, own "
           "routing", "router_calls": len(ref_ids), "routed_rows": rows,
           "flip_bound_rows": MOE_FLIP_SHARE * rows,
           "tolerance_rel": {"prefill": HIDDEN_RTOL,
                             "decode": BF16_HIDDEN_RTOL}}
    for name, (outs, h, f) in arms.items():
        if not all(torch.isfinite(x).all() for x in h.values()):
            raise RuntimeError(f"run {run} {name}: non-finite hidden "
                               f"states")
        pairs = [(x, y) for i in w_outs for x, y in
                 zip(w_outs[i], outs.get(i, []))]
        res[name] = {
            "flipped_calls": sum(n > 0 for n in f), "flipped_rows": sum(f),
            **{ph + "_rel_err": rel(h[ph], w_h[ph])
               for ph in ("prefill", "decode")},
            "tokens_compared": len(pairs),
            "greedy_agreement": sum(x == y for x, y in pairs) / len(pairs)}
    k_h, p_h = arms["kernels"][1], arms[name3][1]
    res[name3]["decode_rel_err_vs_kernels"] = rel(k_h["decode"],
                                                  p_h["decode"])
    log(json.dumps({{"t": "mla_whole_path", "v": "jamba_whole_path"}.get(
        run, "moe_whole_path"): res}))
    k = res["kernels"]
    if k["flipped_rows"] > MOE_FLIP_SHARE * rows \
            or k["prefill_rel_err"] > HIDDEN_RTOL \
            or k["decode_rel_err"] > BF16_HIDDEN_RTOL:
        raise RuntimeError(f"run {run}: the kernels differ from the plain "
                           f"versions: {res}")
    return res


def run_moe_lm(torch, ops, np):
    """Run (p): ``build_lm`` on Mixtral-8x7B at full width, depth cut to
    ``MOE_LM_LAYERS``: INT4 weights and KV, host, b 4, prompt 128,
    ``MOE_LM_GEN`` tokens; performance, then sequential on the first
    engine's weights (``core.convert.lm_weights``).  Equal tokens and
    exact launch counts required."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import lm_weights
    from repro_torch.serving.spec import EngineSpec, build_lm
    L_ = MOE_LM_LAYERS
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=L_,
                              num_periods=L_)
    plan = EngineSpec(arch="mixtral-8x7b", cfg=cfg, offload=True,
                      placement="host", b_max=B, max_len=MAX_LEN,
                      quant="int4", kv_mode="int4").resolve()
    log(f"(p) plan: {plan.summary()}")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    out = {"run": "p", "plan": plan.summary(), "layers": L_}
    toks, lm = None, None
    for arm, pipeline in (("performance", "performance"),
                          ("sequential", "sequential")):
        p = dataclasses.replace(plan, pipeline=pipeline,
                                warm=pipeline == "performance")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weights = None if lm is None else lm_weights(lm)
        lm = build_lm(p, weights=weights)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        keys = [k for k in lm.store_keys() if k.startswith("exp[")]
        before = {k: lm.weights.load_counts.get(k, 0) for k in keys}
        ops.reset_launches()
        t_, stats = lm.generate(prompt, MOE_LM_GEN)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        loads = sum(lm.weights.load_counts.get(k, 0) - before[k]
                    for k in keys)
        check_launches(f"p {arm}", counts, {
            "flash_attention": L_, "decode_attention": 0,
            "decode_attention_int4": L_ * (MOE_LM_GEN - 1),
            "int4_matmul": 4 * L_ * MOE_LM_GEN + 3 * loads}, exact=True)
        pk = stats["pipeline"]["per_kind"]
        out[arm] = {
            "build_s": build_s, "weights": "drawn" if weights is None
            else "core.convert.lm_weights of the performance engine",
            **{k: stats[k] for k in ("ttft_s", "total_s", "decode_tok_s",
                                     "throughput_tok_s", "compute_busy")},
            "expert_loads": loads,
            "busy_s": {k: pk[k]["busy_s"] for k in pk},
            "bytes": {k: pk[k]["bytes"] for k in pk},
            "launches": counts}
        if toks is None:
            toks = t_
        elif not (t_ == toks).all():
            raise RuntimeError(f"run p: sequential tokens differ from "
                               f"performance: {float((t_ == toks).mean())}")
    out["tokens_equal"] = True
    del lm
    log(json.dumps({"moe_lm": out}))
    return out["performance"]["launches"], out


# ---------------------------------------------------------------------------
# (t) DeepSeek-V3: multi-head latent attention with a 256-expert bank
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_flash(ops):
    """Within it, ``flash_attention_op`` runs the plain version while the
    other kernels stay on (``ops`` calls the wrapper through its module
    on every call)."""
    from repro_torch.kernels.ref import flash_attention_ref
    orig = ops.flash_attention
    ops.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        ops.flash_attention = orig


def run_mla_paper(torch, ops, np):
    """Run (t): DeepSeek-V3 at full width with its depth cut to
    ``MLA_LAYERS`` layers (one a period), INT4, through ``EngineSpec.
    resolve`` and ``create_engine`` on the default budget; (g)'s prompts
    with ``MLA_NEW`` new tokens each; per decode step the weight bytes
    (MLA, shared expert, routed union), the unions, the latent KV bytes;
    exact launch counts; then the whole path against
    ``use_kernels(False)`` on the first prompt."""
    from repro_torch.configs import get_config
    from repro_torch.serving.spec import EngineSpec
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              num_layers=MLA_LAYERS, num_periods=MLA_LAYERS)
    plan = EngineSpec(cfg=cfg, arch="deepseek-v3-671b",
                      quant="int4").resolve()
    log(f"(t) plan: {plan.summary()}")
    log(f"(t) provenance: {json.dumps(plan.provenance)}")
    if plan.engine != "offloaded":
        raise RuntimeError(f"run t: resolved to {plan.engine}")
    summary, r, eng = serve_mla(torch, ops, np, plan)
    summary["whole_path"] = moe_whole_path(
        torch, ops, np, eng, [(r["reqs"][0][0], 2)], run="t",
        third=("int4_matmul_only", True, plain_flash(ops)))
    eng.shutdown()
    return summary["launches"], summary


def serve_mla(torch, ops, np, plan):
    """Build (t)'s engine, serve its requests once and check them.
    Returns the summary, the served run and the engine (still up)."""
    from repro_torch.configs.base import MLA
    from repro_torch.serving.spec import create_engine
    cfg = plan.model_config()
    n, E = cfg.num_layers, cfg.moe.num_experts
    reqs = [(p, MLA_NEW) for p, _ in paper_requests(np, cfg.vocab_size)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"(t) built in {build_s:.1f} s; peak RSS {peak_rss_gb():.1f} GiB")
    units = eng.units
    keys = [k for u in units for k in u.expert_keys]
    per = {eng.weights.nbytes(k) for k in keys}
    if (len(units) != n or not all(u.moe and u.spec.mixer == MLA
                                   for u in units)
            or len(keys) != n * E or len(per) != 1):
        raise RuntimeError(f"run t: {len(units)} units, {len(keys)} "
                           f"experts, sizes {per}")
    per_expert = per.pop()

    def entry_bytes(key, shared):
        return sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                   for name, (_, shape, dt)
                   in eng.weights.manifests[key].entries.items()
                   if name.startswith("ws_") == shared)
    mla_bytes = sum(entry_bytes(u.key, False) for u in units)
    shared_bytes = sum(entry_bytes(u.key, True) for u in units)
    if mla_bytes + shared_bytes != sum(eng.weights.nbytes(u.key)
                                       for u in units):
        raise RuntimeError("run t: the unit buffers' entries do not add up")
    steps, snap = [], [dict(eng.weights.load_counts), dict(eng.stats),
                       len(eng.trace.events())]

    def on_step():
        now, st = dict(eng.weights.load_counts), dict(eng.stats)
        prev, pst, i0 = snap
        evs = eng.trace.events()
        union = [sum(now.get(k, 0) - prev.get(k, 0) for k in u.expert_keys)
                 for u in units]
        steps.append({
            "prefills": st["prefills"] - pst["prefills"],
            "decode": st["decode_steps"] - pst["decode_steps"],
            "experts_per_layer": union,
            "weight_bytes": {"mla": mla_bytes, "shared_expert": shared_bytes,
                             "routed_union": sum(union) * per_expert},
            "kv_load_bytes": sum(e.nbytes for e in evs[i0:]
                                 if e.kind == "kv_load"),
            "kv_save_bytes": sum(e.nbytes for e in evs[i0:]
                                 if e.kind == "kv_save")})
        snap[:] = [now, st, len(evs)]

    r = serve_once(torch, ops, eng, reqs, 0, on_step=on_step)
    r["reqs"] = reqs
    st = r["stats"]
    passes = st["prefills"] + st["decode_steps"]
    loads = sum(sum(s["experts_per_layer"]) for s in steps)
    # per pass and layer: wq_a, wq_b, wkv_a, wo and the shared expert's
    # three projections are packed (w_uk/w_uv are 3-D and stay f32)
    check_launches("t", r["counts"], {
        "flash_attention": n * st["prefills"], "flash_attention_q_offset": 0,
        "decode_attention": 0, "decode_attention_int4": 0,
        "int4_matmul": 3 * loads + 7 * n * passes}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != MLA_NEW or not all(0 <= t < cfg.vocab_size
                                               for t in outs[i])
            for i in range(len(reqs))):
        raise RuntimeError(f"run t: bad tokens {outs}")
    decode = [dict(ms=1e3 * t, **s) for t, s in zip(r["steps"], steps)
              if s["decode"] and not s["prefills"]]
    for d in decode:
        log(json.dumps({"t_decode_step": d}))
    ms = sorted(d["ms"] for d in decode)
    row = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    report = eng.pipeline_report()
    pk = report["per_kind"]
    summary = {
        "run": "t", "plan": plan.summary(), "build_s": build_s,
        "peak_rss_gb": peak_rss_gb(), "host_mem_gb": host_mem_gb(),
        "store_gb": (sum(eng.weights.nbytes(u.key) for u in units)
                     + len(keys) * per_expert) / 1e9,
        "per_expert_bytes": per_expert, "mla_bytes": mla_bytes,
        "shared_expert_bytes": shared_bytes,
        "latent_row_bytes": 2 * row, "requests": len(reqs),
        "prompt_lens": [len(p) for p, _ in reqs], "max_new": MLA_NEW,
        **st, "wall_s": r["wall"], "tok_s": st["tokens_out"] / r["wall"],
        "prefill_steps": [dict(ms=1e3 * t, **s)
                          for t, s in zip(r["steps"], steps)
                          if s["prefills"]],
        "decode_step_ms_median": statistics.median(ms),
        "decode_step_ms_p90": ms[int(0.9 * (len(ms) - 1))],
        "decode_union_mean": statistics.mean(
            u for d in decode for u in d["experts_per_layer"]),
        "expert_loads": loads,
        # the plain MLA decode (no kernel) runs once a layer a decode step
        "mla_decode_calls": n * st["decode_steps"],
        "busy_s": {k: pk[k]["busy_s"] for k in pk},
        "bytes": {k: pk[k]["bytes"] for k in pk},
        "compute_busy": eng.trace.busy_fraction("compute"),
        **memory_report(plan, eng, r),
        "memory_parts": memory_parts(np, plan, eng,
                                     r["device_max_allocated_gb"]),
        "launches": r["counts"]}
    log(json.dumps({"mla_serving": summary}))
    return summary, r, eng


def run_tinyllama(torch, ops, np, rng, counts, summaries, reqs, release,
                  traces, stamp):
    """Runs (a)-(f) and (j) on tinyllama-1.1b: generation, offloaded
    serving, and (e)'s requests through the online (chunked) engine.
    Records (b)'s and (c)'s traces in ``traces`` for run (l).  (e), (f)
    and (j_tiny) build from one ``DrawCache``: the first draws and packs
    tinyllama's INT4 units, the other two take them."""
    from repro_torch.serving.offload_engine import DrawCache
    # 4. the main path: batch generation (a)-(d)
    prompt = rng.integers(0, 32000, (B, PROMPT)).astype(np.int32)
    n_layers = 22
    attn_expect = {"flash_attention": n_layers,
                   "decode_attention": n_layers * (GEN - 1),
                   "decode_attention_int4": 0}
    int4_expect = {**attn_expect, "int4_matmul": 7 * n_layers * GEN}
    from repro_torch.core.convert import lm_weights
    lm, _, counts["a"], summaries["a"], _ = run_main(
        torch, ops, "a", make_plan(None, "performance"), prompt, attn_expect)
    stamp("a")
    # (b), (c) and (d) take (a)'s draws instead of drawing them again (a
    # tinyllama draw from one generator takes 24-27 s): (b) packs them
    # as its own build would, (c) and (d) load (b)'s packed weights
    weights_a = packed_weights(torch, lm_weights(lm), lm.dev)
    release(lm)
    lm, toks_b, counts["b"], summaries["b"], traces["b"] = run_main(
        torch, ops, "b", make_plan("int4", "performance"), prompt,
        int4_expect, weights_a, "run (a)'s, packed on the card")
    del weights_a
    stamp("b")

    # 5. the whole path against the plain versions, same weights
    whole_path_check(torch, ops, lm, prompt, toks_b)
    stamp("b whole path")
    # 5b. (b') speculative decoding on (b)'s engine and tokens
    summaries["b_spec"] = run_spec_lm(torch, ops, "b", lm, prompt, toks_b)
    counts["b_spec"] = summaries["b_spec"]["random"]["launches"]
    stamp("b'")
    weights_b = lm_weights(lm)
    release(lm)
    lm, _, counts["c"], summaries["c"], traces["c"] = run_main(
        torch, ops, "c", make_plan("int4", "sequential"), prompt, int4_expect,
        weights_b, "run (b)'s")
    release(lm)
    stamp("c")
    lm, toks_d, counts["d"], summaries["d"], _ = run_main(
        torch, ops, "d", make_plan("int4", "performance", "int4"), prompt,
        {**int4_expect, "decode_attention": 0,
         "decode_attention_int4": n_layers * (GEN - 1)}, weights_b,
        "run (b)'s")
    del weights_b
    # (b') on (d)'s engine: the verify pass over packed INT4 KV rows
    summaries["d_spec"] = run_spec_lm(torch, ops, "d", lm, prompt, toks_d)
    counts["d_spec"] = summaries["d_spec"]["random"]["launches"]
    release(lm)
    stamp("d, d'")
    log(json.dumps({"kv_load_bytes": {
        "b_fp32_kv": summaries["b"]["bytes"]["kv_load"],
        "d_int4_kv": summaries["d"]["bytes"]["kv_load"],
        "ratio": summaries["b"]["bytes"]["kv_load"]
        / summaries["d"]["bytes"]["kv_load"]}}))

    # 6. serving: (e) int4 KV with a preempted rerun and the whole-path
    # check, (f) fp32 KV over bf16 caches
    with DrawCache() as draws:
        eng, counts["e"], summaries["e"], served_e = run_serving(
            torch, ops, "e", make_plan("int4", "performance", "int4"), reqs,
            "decode_attention_int4", preempt=True, draws=draws, refill=True)
        serving_whole_path(torch, ops, eng, [(p, 8) for p, _ in reqs[:B]])
        eng.shutdown()
        release(eng)
        stamp("e")
        eng, counts["f"], summaries["f"], _ = run_serving(
            torch, ops, "f", make_plan("int4", "performance"), reqs[:B],
            "decode_attention", draws=draws)
        eng.shutdown()
        release(eng)
        stamp("f")

        # 6b. (j) on tinyllama: (e)'s requests through the online engine
        # (chunks of 32: final chunks of 13, 18, 1, 2, 7 tokens,
        # so most take int4_matmul's small-M path), INT4 KV in the mixed
        # steps
        heads = []
        plan = dataclasses.replace(make_plan("int4", "performance", "int4"),
                                   sched="online", prefill_chunk=TINY_CHUNK)
        eng, counts["j_tiny"], summaries["j_tiny"], served = run_serving(
            torch, ops, "j_tiny", plan, reqs, "decode_attention_int4",
            on_build=capture_chunk_heads(heads), draws=draws, refill=True)
        del eng._head
        summaries["j_tiny"]["vs_e"] = chunked_vs_monolithic(
            torch, eng, "j_tiny", reqs, served["outs"], heads,
            served_e["outs"])
        eng.shutdown()
        release(eng)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("kernels", "plan", "moe",
                                       "families", "mla", "ssm",
                                       "frontends", "train", "shard",
                                       "tooling", "examples"),
                    default=None,
                    help="stop after the kernel checks (kernels), or run "
                         "them and runs (g)-(y) only (plan), or (o) and "
                         "(p) only (moe), or (q)-(s) only (families), or "
                         "(t) only (mla), or (u) and (v) only (ssm), or "
                         "(w) and (x) only (frontends), or (y) only "
                         "(train), or (z) only (shard), or (aa)-(ac) "
                         "only (tooling), or (ad) only (examples)")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops
    dev = resolve_device("cuda")
    t_start = time.perf_counter()
    phase_s = {}

    def stamp(phase):
        """Seconds since the last stamp, under ``phase``."""
        phase_s[phase] = time.perf_counter() - t_start - sum(
            phase_s.values())

    # 1. the card
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")

    stamp("card")
    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(json.dumps({"build": {"wall_s": time.perf_counter() - t0,
                              "per_source_s": secs}}))
    for name in _build.SOURCES:
        logf = _build.build_dir() / f"{name}.log"
        fn = "?"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1] if "'" in line else line
                elif "registers" in line or "spill" in line:
                    log(f"ptxas {name} {fn}: "
                        f"{line.split(':', 1)[-1].strip()}")

    stamp("build")
    # 3. kernels vs plain versions
    rng = np.random.default_rng(0)

    def timed(phase, fn, *a):
        out = fn(*a)
        stamp(phase)
        return out
    checks = {"int4_matmul": timed("check int4_matmul", check_int4, torch,
                                   rng, dev),
              "flash_attention": (
                  timed("check flash", check_flash, torch, rng, dev)
                  + timed("check mla flash", check_mla_flash, torch, rng,
                          dev)),
              "decode_attention": timed("check decode", check_decode,
                                        torch, rng, dev),
              "decode_attention_int4": timed(
                  "check decode int4", check_decode_int4, torch, rng, dev)}
    verify, verify_int4 = timed("check verify", check_verify, torch, rng,
                                dev)
    checks["decode_attention"] += verify
    checks["decode_attention_int4"] += verify_int4
    # the bf16 instances
    checks["int4_matmul_bf16"] = timed("check int4_matmul bf16",
                                       check_int4_bf16, torch, rng, dev)
    checks["flash_attention_bf16"] = timed("check flash bf16",
                                           check_flash_bf16, torch, rng, dev)
    checks["decode_attention_bf16"] = timed("check decode bf16",
                                            check_decode_bf16, torch, rng, dev)
    checks["decode_attention_int4_bf16"] = timed(
        "check decode int4 bf16", check_decode_int4_bf16, torch, rng, dev)
    torch.cuda.synchronize()
    failed = []
    for name, rows in checks.items():
        for row in rows:
            log(json.dumps({"kernel_check": name, **row}))
            if not row["ok"]:
                failed.append(f"{name} {row['shape']}")
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{failed}")
    timed("time mla decode", time_mla_decode, torch, rng, dev)
    timed("time ssm plain", time_ssm_plain, torch, rng, dev)
    if args.only == "kernels":
        return 0

    counts, summaries = {}, {}
    reqs = serving_requests(SERVE_REQS)

    def release(lm):
        del lm
        gc.collect()
        torch.cuda.empty_cache()

    traces = {}
    if args.only == "moe":
        run_moe(torch, ops, np, counts, summaries, release, stamp)
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "families":
        run_families(torch, ops, np, counts, summaries, release, stamp)
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "mla":
        run_deepseek(torch, ops, np, counts, summaries, release, stamp)
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "ssm":
        run_ssm(torch, ops, np, counts, summaries, release, stamp)
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "frontends":
        run_frontends(torch, ops, np, counts, summaries, release, stamp)
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "train":
        counts["y"], summaries["y"], _ = run_train(torch, ops, np, card)
        stamp("y")
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "shard":
        counts["z"], summaries["z"] = run_shard(torch, ops, np, card,
                                                profile=True)
        stamp("z")
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "tooling":
        run_tooling(torch, ops, np, card, counts, summaries, stamp)
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only == "examples":
        run_examples(torch, ops, np, card, counts, summaries)
        stamp("ad")
        return finish(torch, card, checks, counts, t_start, phase_s)
    if args.only != "plan":
        run_tinyllama(torch, ops, np, rng, counts, summaries, reqs, release,
                      traces, stamp)
        gc.collect()                # the engines hold reference cycles
        torch.cuda.empty_cache()
        stamp("j_tiny")

    # 7.-9. the plan entry point: (g) the paper's Llama-3.1-8B, then (k)
    # arrival traffic through it; (j) the same model and seed with
    # chunked prefill, then (k) through it; (h) the CLI, (i) the
    # resident engine, (l) replay of the recorded traces
    # (g)'s build draws and packs the 8B once; (j), (m) and (n) take it
    from repro_torch.serving.offload_engine import DrawCache
    with DrawCache() as draws:
        eng, counts["g"], summaries["g"], served_g = run_paper(
            torch, ops, np, draws)
        stamp("g")
        traces["g"] = (served_g["trace"], summaries["g"]["prefills"])
        rate = 0.5 * PAPER_REQS / summaries["g"]["wall_s"]
        from repro_torch.serving.workload import poisson_trace
        atrace = poisson_trace(TRAFFIC_REQS, rate, seed=0,
                               vocab=eng.cfg.vocab_size,
                               prompt_len=(32, 160), max_new=PAPER_NEW)
        log(f"(k) rate {rate:.4f} req/s: half of the {PAPER_REQS} "
            f"requests over (g)'s {summaries['g']['wall_s']:.2f} s")
        counts["k_mono"], summaries["k_mono"] = run_traffic(
            torch, ops, "k_mono", eng, atrace, rate)
        stamp("k_mono")
        eng.shutdown()
        del eng                 # before (j) builds: (j)'s peak is its own
        release(None)
        eng, counts["j"], summaries["j"] = run_chunked(
            torch, ops, np, served_g["outs"], summaries["g"]["plan_depth"],
            draws)
        stamp("j")
        counts["k_online"], summaries["k_online"] = run_traffic(
            torch, ops, "k_online", eng, atrace, rate)
        stamp("k_online")
        eng.shutdown()
        del eng
        release(None)
        # (m) speculative decoding on the 8B with the llama3.2-1b draft,
        # then (n) the 8B in two pipeline stages; both against (g)'s
        # tokens
        counts["m"], summaries["m"] = run_spec_paper(
            torch, ops, np, summaries["g"], served_g["outs"], draws)
        release(None)
        stamp("m")
        counts["n"], summaries["n"] = run_staged_paper(
            torch, ops, np, summaries["g"], served_g["outs"], draws)
    release(None)
    stamp("n")
    counts["h"], summaries["h"] = run_cli(torch, ops)
    stamp("h")
    gc.collect()
    torch.cuda.empty_cache()
    counts["i"], summaries["i"] = run_resident(torch, ops, reqs)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("i")
    # (b) and (c) replay from their first decode step, (g) after its
    # four prefills
    summaries["l"] = run_replay(torch, {k: (t, 1) if k in ("b", "c") else t
                                        for k, t in traces.items()},
                                summaries["g"]["plan_depth"])
    stamp("l")
    run_moe(torch, ops, np, counts, summaries, release, stamp)
    run_families(torch, ops, np, counts, summaries, release, stamp)
    run_deepseek(torch, ops, np, counts, summaries, release, stamp)
    run_ssm(torch, ops, np, counts, summaries, release, stamp)
    run_frontends(torch, ops, np, counts, summaries, release, stamp)
    counts["y"], summaries["y"], draws = run_train(torch, ops, np, card)
    stamp("y")
    counts["z"], summaries["z"] = run_shard(torch, ops, np, card, draws)
    del draws
    stamp("z")
    gc.collect()
    torch.cuda.empty_cache()
    run_tooling(torch, ops, np, card, counts, summaries, stamp)
    gc.collect()
    torch.cuda.empty_cache()
    run_examples(torch, ops, np, card, counts, summaries)
    stamp("ad")
    return finish(torch, card, checks, counts, t_start, phase_s)


# ---------------------------------------------------------------------------
# runs (q)-(s): Gemma 3 (sliding window, head_dim 256) and Qwen3 (qk_norm)
# ---------------------------------------------------------------------------

def depth_cut(arch: str, **layers):
    """``arch``'s registry config at full width with its depth cut."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **layers)


def gemma3_cut():
    """Gemma3-4B cut to ``GEMMA3_PERIODS`` periods of its pattern (5
    sliding-window layers and a global one) and its 4-layer remainder."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-4b")
    return depth_cut("gemma3-4b", num_periods=GEMMA3_PERIODS,
                     num_layers=GEMMA3_PERIODS * len(cfg.pattern)
                     + len(cfg.remainder))


def family_requests(np, vocab: int):
    """Runs (q) and (s): prompts of ``FAMILY_PROMPTS`` random tokens
    (``default_rng(0)``), ``FAMILY_NEW`` new tokens each."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), FAMILY_NEW)
            for n in FAMILY_PROMPTS]


def memory_report(plan, eng, summary) -> dict:
    """Peak device memory of the serve beside the plan's budget, the
    memory model's estimate and the engine's resident bytes."""
    return {"device_max_allocated_gb": summary["device_max_allocated_gb"],
            "device_budget_gb": plan.device_budget / 2**30,
            "modeled_device_gb": modeled_device_bytes(plan) / 2**30,
            "resident_gb": eng.resident_bytes / 2**30}


def kv_step_bytes(eng, summary) -> dict:
    """KV bytes per decode step of the serve: the trace's KV_LOAD bytes
    (loads run only in decode) and its KV_SAVE bytes less the prefills'
    saves, over the decode steps; beside the rolling buffers' share of
    each way at the full batch."""
    ks = eng.kvstore
    units = range(len(ks))
    rolling = [j for j in units if ks.leaf_meta(j)["k"].kind == "rep"]
    prefill_save = summary["prefills"] * sum(ks.prefill_save_nbytes(j)
                                             for j in units)
    steps = max(1, summary["decode_steps"])
    return {"kv_load_bytes_per_step": summary["bytes"]["kv_load"] / steps,
            "kv_save_bytes_per_step":
            (summary["bytes"]["kv_save"] - prefill_save) / steps,
            "weight_load_bytes_per_step":
            sum(eng.weights.nbytes(u.key) for u in eng.units),
            "rolling_layers": len(rolling),
            "rolling_bytes_each_way_at_b_max":
            sum(ks.save_nbytes(j, eng.b_max) for j in rolling)}


def run_gemma3_offloaded(torch, ops, np):
    """Run (q): Gemma3-4B cut to ``gemma3_cut`` (16 of its 34 layers: 13
    sliding-window layers of 1024 and 3 global, head_dim 256, tied
    262144-row table), INT4 weights and KV, through
    ``EngineSpec.resolve`` and ``create_engine`` on the default budget;
    (q)'s four requests (prompts 1500, 1016, 300, 114:
    the window binds in the first prefill, the second wraps its buffer
    in decode), exact launches (the local layers' decode over their
    rolling buffers through ``decode_attention``, the global layers'
    through ``decode_attention_int4``), a profiled short serve for the
    card's busy share, the peak beside the budget, the KV bytes per
    step, then kernels against ``use_kernels(False)`` (prefill 1e-4,
    decode 2e-2 x max).  Returns its counts and summary."""
    from repro_torch.serving.spec import EngineSpec
    plan = EngineSpec(arch="gemma3-4b", cfg=gemma3_cut(), quant="int4",
                      kv_mode="int4", max_len=FAMILY_MAX_LEN).resolve()
    cfg = plan.model_config()
    log(f"(q) plan: {plan.summary()}")
    log(f"(q) engine: {plan.provenance['engine']}; depth: "
        f"{plan.provenance['depth']}")
    if plan.engine != "offloaded" or cfg.window != GEMMA3_WINDOW:
        raise RuntimeError(f"run q: unexpected plan {plan.summary()}")
    reqs = family_requests(np, cfg.vocab_size)
    eng, counts, summary, _ = run_serving(
        torch, ops, "q", plan, reqs, "decode_attention_int4")
    short = [(p, 4) for p, _ in reqs]
    summary["profiled"] = {"requests": len(reqs), "max_new": 4, **busy_share(
        device_events(torch, lambda: serve_once(torch, ops, eng, short,
                                                400)))}
    summary.update(memory=memory_report(plan, eng, summary),
                   kv_bytes=kv_step_bytes(eng, summary),
                   params=cfg.param_count(), depth=eng.sched.depth,
                   local_layers=local_layers(cfg))
    log(json.dumps({"gemma3_offloaded": summary}))
    summary["whole_path"] = serving_whole_path(torch, ops, eng,
                                               [(p, 2) for p, _ in reqs])
    eng.shutdown()
    return counts, summary


def run_qwen3_offloaded(torch, ops, np):
    """Run (r): Qwen3-8B (``QWEN3_LAYERS`` of its 36 layers,
    ``qk_norm``), INT4 weights, through ``EngineSpec.resolve`` and
    ``create_engine`` on the default budget (offloaded, host, depth 8,
    bf16 caches); (g)'s requests, exact launches, kernels against
    ``use_kernels(False)``; then on the same engine an oracle proposer
    from (r)'s own streams, ``SPEC_K`` a step: tokens equal to (r)'s
    (the verify pass runs ``qk_norm`` on the card), full acceptance,
    exact launches, and the verify step against ``use_kernels(False)``
    (2e-2 x max over bf16 caches); the peak beside the budget.  Returns
    its counts and summary."""
    from repro_torch.serving.spec import EngineSpec
    plan = EngineSpec(arch="qwen3-8b", cfg=depth_cut(
        "qwen3-8b", num_layers=QWEN3_LAYERS, num_periods=QWEN3_LAYERS),
        quant="int4").resolve()
    cfg = plan.model_config()
    log(f"(r) plan: {plan.summary()}; depth: {plan.provenance['depth']}")
    if plan.engine != "offloaded" or not cfg.qk_norm:
        raise RuntimeError(f"run r: unexpected plan {plan.summary()}")
    reqs = paper_requests(np, cfg.vocab_size)
    eng, counts, summary, served = run_serving(torch, ops, "r", plan, reqs,
                                               "decode_attention")
    summary.update(memory=memory_report(plan, eng, summary),
                   params=cfg.param_count(), depth=eng.sched.depth)
    log(json.dumps({"qwen3_offloaded": summary}))
    summary["whole_path"] = serving_whole_path(torch, ops, eng,
                                               [(p, 2) for p, _ in reqs])
    outs, n = served["outs"], cfg.num_layers
    eng.attach_draft(OracleProposer(
        [(p, outs[i]) for i, (p, _) in enumerate(reqs)]), SPEC_K)
    before = dict(eng.stats)
    mark = len(eng.trace.meta.get("spec_steps", []))
    r = serve_once(torch, ops, eng, reqs, 500)
    steps = eng.trace.meta["spec_steps"][mark:]
    st = {k: eng.stats[k] - before.get(k, 0) for k in (
        "spec_steps", "spec_proposed", "spec_accepted")}
    verify_rows = sum(s["k"] + 1 for s in steps)
    plain_steps = r["stats"]["decode_steps"] - len(steps)
    passes = r["stats"]["prefills"] + r["stats"]["decode_steps"]
    steps_ms = sorted(1e3 * x for x in r["steps"])
    summary["oracle"] = spec_summary(st, steps, r["wall"], {
        "tokens_equal": r["outs"] == outs,
        "tok_s": r["stats"]["tokens_out"] / r["wall"],
        "step_ms_median": statistics.median(steps_ms),
        "verify_rows": verify_rows, "plain_steps": plain_steps,
        "launches": r["counts"],
        "device_max_allocated_gb": r["device_max_allocated_gb"]})
    if r["outs"] != outs or st["spec_accepted"] != st["spec_proposed"]:
        raise RuntimeError(f"run r oracle: tokens or acceptance differ: "
                           f"{summary['oracle']}")
    check_launches("r oracle", r["counts"], {
        "flash_attention": n * r["stats"]["prefills"],
        "decode_attention": n * (verify_rows + plain_steps),
        "decode_attention_int4": 0, "int4_matmul": 7 * n * passes},
        exact=True)
    summary["verify_whole_path"] = verify_whole_path(
        torch, ops, "r", eng, lambda: [
            o[0] for _, o in sorted(serve_once(
                torch, ops, eng, [(p, SPEC_K + 1) for p, _ in reqs],
                600)["outs"].items())],
        BF16_HIDDEN_RTOL)
    log(json.dumps({"qwen3_oracle": summary["oracle"]}))
    eng.shutdown()
    return counts, summary


def run_gemma3_resident(torch, ops, np):
    """Run (s): Gemma3-4B resident: ``EngineSpec(arch="gemma3-4b",
    max_len=2048).resolve(MemoryBudget(device=40 GiB, host=64 GiB))``
    (the memory model: "W+M=30.0GiB fits device"), its f32 tree carried
    to the offloaded plan's INT4 weights on the card
    (``core.convert.quant_roundtrip_params``: what (q)'s engine streams,
    dequantized); (q)'s requests, exact launches (every layer through
    ``flash_attention`` and ``decode_attention``: the rolling buffers
    and the 2048-row slabs), then its tokens against an fp-KV offloaded
    run on the same weights (``quant="int4"``, bf16 caches, seed 0):
    the agreement, and at a first divergence the resident model's logit
    margin.  Returns its counts and summary."""
    from repro_torch.core.convert import quant_roundtrip_params
    from repro_torch.core.offload import MemoryBudget
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec import EngineSpec, create_engine
    plan = EngineSpec(arch="gemma3-4b", cfg=gemma3_cut(),
                      max_len=FAMILY_MAX_LEN).resolve(
        MemoryBudget(device=40 * 2**30, host=64 * 2**30))
    log(f"(s) plan: {plan.summary()}; engine: {plan.provenance['engine']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    if type(eng) is not ServingEngine:
        raise RuntimeError(f"run s: built {type(eng).__name__}")
    eng.params = quant_roundtrip_params(eng.cfg, eng.params)
    gc.collect()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reqs = family_requests(np, eng.cfg.vocab_size)
    r = serve_once(torch, ops, eng, reqs, 0)
    n, st = eng.cfg.num_layers, r["stats"]
    check_launches("s", r["counts"], {
        "flash_attention": n * st["prefills"],
        "decode_attention": n * st["decode_steps"],
        "decode_attention_int4": 0, "int4_matmul": 0}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != m for i, (_, m) in enumerate(reqs)):
        raise RuntimeError(f"run s: bad tokens {outs}")
    steps_ms = sorted(1e3 * x for x in r["steps"])
    summary = {"run": "s", "plan": plan.summary(), "build_s": build_s,
               "build_device_peak_gb":
               torch.cuda.max_memory_allocated() / 2**30,
               **st, "wall_s": r["wall"], "tok_s": st["tokens_out"] / r["wall"],
               "step_ms_median": statistics.median(steps_ms),
               "step_ms_p90": steps_ms[int(0.9 * (len(steps_ms) - 1))],
               "device_max_allocated_gb": r["device_max_allocated_gb"],
               "launches": r["counts"]}
    oplan = EngineSpec(arch="gemma3-4b", cfg=gemma3_cut(), quant="int4",
                       max_len=FAMILY_MAX_LEN).resolve()
    oeng = create_engine(oplan)
    ro = serve_once(torch, ops, oeng, reqs, 0)
    oeng.shutdown()
    del oeng
    pairs = [(x, y) for i in outs for x, y in zip(outs[i], ro["outs"][i])]
    agree = {"offloaded_plan": oplan.summary(),
             "tokens_compared": len(pairs),
             "tokens_equal": sum(x == y for x, y in pairs),
             "requests_equal": sum(outs[i] == ro["outs"][i] for i in outs)}
    first = next(((i, k) for i in sorted(outs) for k, (x, y) in
                  enumerate(zip(outs[i], ro["outs"][i])) if x != y), None)
    if first is not None:
        i, k = first
        prefix = list(reqs[i][0]) + outs[i][:k]
        agree["first_divergence"] = {
            "request": i, "step": k, "resident": outs[i][k],
            "offloaded": ro["outs"][i][k],
            "resident_logit_margin": logit_margin(torch, eng, prefix)}
    summary["vs_offloaded"] = agree
    # its first request against use_kernels(False) on the same engine and
    # weights (the prefill of 1500 rows through the window and the first
    # decode step), then the ops' own casts in a profiled short serve
    summary["whole_path"] = resident_whole_path(torch, ops, eng, reqs[:1],
                                                "s")
    prof = op_casts(torch, ops, lambda: serve_once(
        torch, ops, eng, [(reqs[0][0], 2)], 900))
    summary["op_casts"] = prof["casts"]
    if prof["casts"]:
        raise RuntimeError(f"run s: the ops cast {prof['casts']} times")
    log(json.dumps({"gemma3_resident": summary}))
    eng.shutdown()
    return r["counts"], summary


def run_families(torch, ops, np, counts, summaries, release, stamp):
    """Runs (q), (r) and (s), each engine released before the next."""
    counts["q"], summaries["q"] = run_gemma3_offloaded(torch, ops, np)
    release(None)
    stamp("q")
    counts["r"], summaries["r"] = run_qwen3_offloaded(torch, ops, np)
    release(None)
    stamp("r")
    counts["s"], summaries["s"] = run_gemma3_resident(torch, ops, np)
    release(None)
    stamp("s")


def run_moe(torch, ops, np, counts, summaries, release, stamp):
    """12. MoE: (o) Mixtral-8x7B serving, then (p) batch generation on
    Mixtral cut to one layer."""
    counts["o"], summaries["o"] = run_moe_paper(torch, ops, np)
    release(None)
    stamp("o")
    counts["p"], summaries["p"] = run_moe_lm(torch, ops, np)
    release(None)
    stamp("p")


def run_deepseek(torch, ops, np, counts, summaries, release, stamp):
    """Run (t): DeepSeek-V3's MLA through the offloaded engine."""
    counts["t"], summaries["t"] = run_mla_paper(torch, ops, np)
    release(None)
    stamp("t")


# ---------------------------------------------------------------------------
# runs (u)-(v): the SSM (Mamba2's SSD mixer, jamba's hybrid stack)
# ---------------------------------------------------------------------------

def ssd_flops(b, l, H, hd, G, N, cs) -> float:
    """The f32 operations ``models.ssm.ssd_chunked`` does at chunk
    ``cs``: C.B, the masked products and (C.B * L) @ (dt x) within the
    chunks; the chunk states B x dt x x x decay; the recurrence over the
    chunks; the states applied through C and the decay."""
    nc = l // cs
    intra = b * nc * (2 * G * cs * cs * N + 2 * H * cs * cs
                      + 2 * H * cs * cs * hd)
    states = 4 * b * l * H * hd * N
    scan = 2 * b * nc * H * hd * N
    out = 4 * b * l * H * hd * N
    return float(intra + states + scan + out)


def time_ssm_plain(torch, rng, dev):
    """The SSM functions, plain PyTorch on the card (the reference
    computes them in jnp; no TPU kernel): ``ssd_decode_step`` at run
    (u)'s and (v)'s decode (b 4; mamba2 64 heads of 64, jamba 128 of 128,
    d_state 128: the f32 state read and written whole), the causal conv
    at decode (a bf16 halo) and over a 400-token prefill, and
    ``ssd_chunked`` at run (u)'s 400-token prompt (chunk 200: two chunks)
    and at the prime ``SSM_PRIME`` (chunk 1: one chunk a token).  Each:
    device time (profiler), host time a call (enqueue only), CUDA-event
    time a call, calls a step, the bound (bytes over 3.35 TB/s or f32
    operations at 67 TFLOP/s) and the largest difference from the same
    call on the CPU over the largest value.  Returns the rows."""
    from repro_torch.kernels import cost
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    mk = lambda *s: torch.tensor(rng.standard_normal(s) * 0.3,
                                 dtype=torch.float32, device=dev)
    softplus = torch.nn.functional.softplus
    first = lambda out: out[0] if isinstance(out, tuple) else out
    rows = []

    def row(name, fn, args, nbytes, flops, calls, iters):
        call = lambda: fn(**args)
        out = first(call()).cpu()
        cpu = first(fn(**{k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in args.items()}))
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        host_ms = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        r = dict(shape=name, ms=device_ms(torch, call, iters),
                 host_ms=host_ms, call_ms=call_ms(torch, call, iters),
                 calls=calls, rel_diff_vs_cpu=(
                     (out - cpu).abs().max() / cpu.abs().max()).item())
        r["bound_ms"], r["bound_by"] = cost.bound_ms(nbytes, flops)
        rows.append(r)
        log(json.dumps({"ssm_plain": r}))

    for arch, H, hd, calls in (("mamba2", 64, 64, "48 a decode step (u)"),
                               ("jamba", 128, 128, "4 a decode step (v)")):
        b, N = 4, 128
        args = dict(xh=mk(b, H, hd), dt=softplus(mk(b, H)),
                    A=-torch.exp(mk(H)),
                    B=mk(b, 1, N), C=mk(b, 1, N), h=mk(b, H, hd, N))
        row(f"ssd_decode_step {arch} b={b} H={H} hd={hd} N={N}",
            S.ssd_decode_step, args, 2 * 4 * b * H * hd * N
            + 4 * (2 * b * H * hd + 2 * b * N), 6.0 * b * H * hd * N,
            calls, 50)
    ch = 2 * 2048 + 2 * 128
    w, cb = mk(4, ch), mk(ch)
    row(f"causal_conv decode mamba2 b=4 ch={ch} bf16 halo", L._causal_conv,
        dict(x=mk(4, 1, ch), w=w, b=cb, halo=mk(4, 3, ch).bfloat16()),
        4 * (2 * 4 * ch + 5 * ch) + 2 * 4 * 3 * ch, 8.0 * 4 * ch,
        "48 a decode step (u)", 50)
    row(f"causal_conv prefill mamba2 l=400 ch={ch}", L._causal_conv,
        dict(x=mk(1, 400, ch), w=w, b=cb), 4 * (2 * 400 * ch + 5 * ch),
        8.0 * 400 * ch, "48 a prefill (u)", 20)
    H, hd, N = 64, 64, 128
    for l in (400, SSM_PRIME):
        cs = L._pick_chunk(l, 256)
        args = dict(xh=mk(1, l, H, hd), dt=softplus(mk(1, l, H)),
                    A=-torch.exp(mk(H)), B=mk(1, l, 1, N), C=mk(1, l, 1, N),
                    chunk=cs)
        row(f"ssd_chunked mamba2 l={l} chunk={cs} H={H} hd={hd} N={N}",
            S.ssd_chunked, args,
            4 * (2 * l * H * hd + l * H + 2 * l * N + H * hd * N),
            ssd_flops(1, l, H, hd, 1, N, cs), "48 a prefill (u)",
            10 if cs > 1 else 3)
    return rows


def ssm_requests(np, vocab: int):
    """Run (u)'s requests: prompts of ``SSM_PROMPTS`` random tokens
    (``default_rng(0)``), ``SSM_NEW`` new tokens each."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), SSM_NEW)
            for n in SSM_PROMPTS]


def ssm_step_bytes(np, eng, summary) -> dict:
    """Per decode step of the serve: the units' weight bytes (experts
    apart), the trace's KV_LOAD bytes and its KV_SAVE bytes less the
    prefills' saves, each over the decode steps; and each way's SSM state
    and halo bytes at the full batch (every leaf moves whole)."""
    ks = eng.kvstore
    units = range(len(ks))
    prefill_save = summary["prefills"] * sum(ks.prefill_save_nbytes(j)
                                             for j in units)
    steps = max(1, summary["decode_steps"])
    leaf = lambda name: sum(
        eng.b_max * int(np.prod(m.feat)) * m.itemsize for j in units
        for n, m in ks.leaf_meta(j).items() if n == name)
    return {"weight_load_bytes_per_step":
            sum(eng.weights.nbytes(u.key) for u in eng.units),
            "kv_load_bytes_per_step": summary["bytes"]["kv_load"] / steps,
            "kv_save_bytes_per_step":
            (summary["bytes"]["kv_save"] - prefill_save) / steps,
            "state_bytes_each_way_at_b_max": leaf("state"),
            "halo_bytes_each_way_at_b_max": leaf("conv")}


def memory_parts(np, plan, eng, peak_gb: float) -> dict:
    """The memory model's device estimate and its parts (GiB) beside the
    measured peak and what the engine holds (ROADMAP Queue 3 item 16):
    the model prices the mixer as MHA wherever ``num_heads`` is set, a
    whole expert bank per window layer, and a KV term of every layer's
    K/V rows with no SSM state."""
    from repro_torch.core.memory_model import (estimate, quant_kv_ratio,
                                               quant_weight_ratio)
    cfg = plan.model_config()
    est = estimate(cfg, batch=plan.b_max, seq=plan.max_len, p=4, preload=0)
    qw = quant_weight_ratio(4, plan.quant)
    qk = quant_kv_ratio(4, plan.kv_mode)
    gib = lambda x: x / 2**30
    ks = eng.kvstore
    cache = {}
    for j in range(len(ks)):
        for m in ks.leaf_meta(j).values():
            rows = plan.max_len if m.kind == "kv" else 1
            cache[m.kind] = cache.get(m.kind, 0) + gib(
                eng.b_max * rows * int(np.prod(m.feat)) * m.itemsize)
    units = [eng.weights.nbytes(u.key) for u in eng.units]
    experts = [eng.weights.nbytes(k) for u in eng.units
               for k in u.expert_keys]
    n_moe = sum(u.moe for u in eng.units)
    return {"modeled": {
        "estimate_gb": gib(modeled_device_bytes(plan)),
        "vocab_gb": gib(est.w_embed), "mixer_gb": gib(est.w_mha * qw),
        "bank_gb": gib(est.w_mlp * qw),
        "cache_per_layer_gb": gib(est.kv_cache // cfg.num_layers * qk),
        "cache_total_gb": gib(est.kv_cache),
        "peak_prefill_gb": gib(est.peak_prefill),
        "peak_decode_gb": gib(est.peak_decode), "depth": plan.depth},
        "measured": {
            "peak_gb": peak_gb, "resident_gb": gib(eng.resident_bytes),
            "largest_unit_gb": gib(max(units)),
            "expert_gb": gib(max(experts)) if experts else 0.0,
            "bank_gb": gib(sum(experts) / n_moe) if n_moe else 0.0,
            "cache_by_kind_gb": cache},
        "device_budget_gb": gib(plan.device_budget)}


def ssm_decode_step_check(torch, ops, eng):
    """One decode step through every unit of an SSM stack (no MoE),
    kernels against ``use_kernels(False)``, both arms from the same
    loaded halos and states (the store's rows of the last serve, every
    slot) and the same tokens: the final hidden states within 1e-4 x
    max, the f32 paths' tolerance.  The whole-path reading
    (``serving_whole_path``) runs each arm from its own prefill, so its
    decode step reads halos that each arm rounded to bf16 on its own:
    values a rounding apart may land on two bf16 neighbours, as over any
    bf16 cache, and it is held at 2e-2 x max like every bf16-cache
    decode."""
    from repro_torch.models import layers as L
    x0 = eng._embed(eng.tokens[:, None].copy())
    out = {}
    for kernels in (True, False):
        ops.use_kernels(kernels)
        try:
            x = x0
            for j, u in enumerate(eng.units):
                w = eng._loaded(u.key, eng.load_weights(j), eng.dev)
                kv = eng.kvstore.load(j, eng.b_max, 1)
                x, _ = u.apply(w, x, L.Ctx(cfg=eng.cfg, mode="decode"), kv)
            out[kernels] = x.detach().clone()
        finally:
            ops.use_kernels(True)
    a, b = out[True], out[False]
    if not torch.isfinite(a).all():
        raise RuntimeError("ssm decode step: non-finite hidden states")
    res = {"rel_err": ((a - b).abs().max() / b.abs().max()).item(),
           "tolerance_rel": HIDDEN_RTOL, "units": len(eng.units)}
    log(json.dumps({"ssm_decode_step_check": res}))
    if res["rel_err"] > HIDDEN_RTOL:
        raise RuntimeError(f"ssm decode step: kernels differ from the "
                           f"plain versions: {res}")
    return res


def run_mamba2(torch, ops, np):
    """Run (u): mamba2-1.3b at full width (``MAMBA2_LAYERS`` of its 48
    SSM layers, d 2048, 64 heads of 64, d_state 128, vocab 50280, tied),
    INT4, through
    ``EngineSpec.resolve`` and ``create_engine``: the default budget
    resolves it resident (provenance printed); ``offload=True`` on the
    same seed gives the offloaded engine (host, depth 8, ``fused_int4``:
    the five SSM projections through ``int4_matmul``).  Its 4 requests
    on 4 slots, then again with a slot preempted after step 6 (the same
    tokens); exact launches (``int4_matmul`` = 5 x layers per pass, the
    SSM projections: mamba2 has no FFN; no attention kernel); the decode step's ms, its weight and state/halo
    bytes, the per-kind busy time, the peak beside the budget and the
    memory model; the prime ``SSM_PRIME`` prompt (chunk 1) and the
    400-token one (chunk 200) each prefilled alone; the whole path
    against ``use_kernels(False)`` (the prefill within 1e-4 x max, the
    decode step over each arm's own bf16 halos within 2e-2 x max) and
    one decode step from the same halos and states (within 1e-4 x max,
    ``ssm_decode_step_check``); then the resident engine on the same
    draws carried to the INT4
    weights (``core.convert.quant_roundtrip_params``) against the
    offloaded engine, both plain: the first two tokens of every request
    equal (the prefill and the first decode step read the same bf16
    halos), the agreement after them printed (the resident engine's halo
    turns f32 at its first decode step, as the reference's: ROADMAP
    Queue 3 item 18)."""
    from repro_torch.core.convert import quant_roundtrip_params
    from repro_torch.models.layers import _pick_chunk
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec import EngineSpec, create_engine
    spec = dict(arch="mamba2-1.3b", quant="int4", max_len=SSM_MAX_LEN,
                cfg=depth_cut("mamba2-1.3b", num_layers=MAMBA2_LAYERS,
                              num_periods=MAMBA2_LAYERS))
    rplan = EngineSpec(**spec).resolve()
    log(f"(u) default plan: {rplan.summary()}")
    log(f"(u) provenance: {json.dumps(rplan.provenance)}")
    plan = EngineSpec(**spec, offload=True).resolve()
    log(f"(u) plan: {plan.summary()}; engine: {plan.provenance['engine']}; "
        f"depth: {plan.provenance['depth']}")
    if rplan.engine != "resident" or (
            plan.engine, plan.placement, plan.depth, plan.fused_int4) != (
            "offloaded", "host", 8, True):
        raise RuntimeError(f"run u: unexpected plans {rplan.summary()} / "
                           f"{plan.summary()}")
    cfg = plan.model_config()
    n = cfg.num_layers
    per_layer = 5 + 3 * bool(cfg.d_ff)     # the SSM's five, a dense FFN's
    reqs = ssm_requests(np, cfg.vocab_size)
    eng, counts, summary, r = run_serving(
        torch, ops, "u", plan, reqs, None, preempt=True,
        launches=lambda st: {
            "flash_attention": 0, "flash_attention_q_offset": 0,
            "decode_attention": 0, "decode_attention_int4": 0,
            "int4_matmul": per_layer * n * (st["prefills"]
                                            + st["decode_steps"])})
    ms = sorted(1e3 * t for t in r["steps"][1:])
    summary.update(
        decode_step_ms_median=statistics.median(ms),
        decode_step_ms_p90=ms[int(0.9 * (len(ms) - 1))],
        first_step_ms=1e3 * r["steps"][0],
        chunks={len(p): _pick_chunk(len(p), cfg.ssm.chunk_size)
                for p, _ in reqs},
        memory=memory_report(plan, eng, summary),
        memory_parts=memory_parts(np, plan, eng,
                                  summary["device_max_allocated_gb"]),
        kv_bytes=ssm_step_bytes(np, eng, summary),
        params=cfg.param_count())
    alone = {}
    prime = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SSM_PRIME,)).astype(np.int32)
    from repro_torch.serving.base import Request
    for rid, (name, p) in enumerate((("prime", prime),
                                     ("longest", reqs[0][0]))):
        # the admission alone: one b=1 prefill through the pipeline
        eng.submit(Request(rid=500 + rid, prompt=p.copy(), max_new=1))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        alone[name] = {"prompt_len": len(p),
                       "chunk": _pick_chunk(len(p), cfg.ssm.chunk_size),
                       "prefill_ms": 1e3 * (time.perf_counter() - t0),
                       "int4_matmul": ops.LAUNCHES["int4_matmul"]}
        eng.run()
    summary["prefill_alone"] = alone
    log(json.dumps({"mamba2_serving": summary}))
    summary["whole_path"] = serving_whole_path(
        torch, ops, eng, [(p, 2) for p, _ in reqs], name="mamba2")
    summary["decode_step_check"] = ssm_decode_step_check(torch, ops, eng)
    # the resident engine against the offloaded one, both plain
    ops.use_kernels(False)
    try:
        ro = serve_once(torch, ops, eng, reqs, 600)
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        reng = create_engine(rplan)
        if type(reng) is not ServingEngine:
            raise RuntimeError(f"run u: built {type(reng).__name__}")
        reng.params = quant_roundtrip_params(reng.cfg, reng.params)
        gc.collect()
        rr = serve_once(torch, ops, reng, reqs, 600)
    finally:
        ops.use_kernels(True)
    outs, oouts = rr["outs"], ro["outs"]
    pairs = [(x, y) for i in outs for x, y in zip(outs[i], oouts[i])]
    agree = {"tokens_compared": len(pairs),
             "tokens_equal": sum(x == y for x, y in pairs),
             "requests_equal": sum(outs[i] == oouts[i] for i in outs),
             "first_two_equal": all(outs[i][:2] == oouts[i][:2]
                                    for i in outs),
             "resident_conv_dtype": str(reng.caches["pat"][0]["conv"].dtype)}
    first = next(((i, k) for i in sorted(outs) for k, (x, y) in
                  enumerate(zip(outs[i], oouts[i])) if x != y), None)
    if first is not None:
        i, k = first
        prefix = list(reqs[i][0]) + outs[i][:k]
        agree["first_divergence"] = {
            "request": i, "step": k, "resident": outs[i][k],
            "offloaded": oouts[i][k],
            "resident_logit_margin": logit_margin(torch, reng, prefix)}
    summary["resident_vs_offloaded"] = agree
    log(json.dumps({"mamba2_resident_vs_offloaded": agree}))
    reng.shutdown()
    if not agree["first_two_equal"]:
        raise RuntimeError(f"run u: resident and offloaded differ before "
                           f"their halos do: {agree}")
    return counts, summary


def run_jamba(torch, ops, np):
    """Run (v): jamba-1.5-large at full width (d 8192, 64/8 heads of
    128; SSM d_inner 16384, 128 heads of 128, d_state 128; 16 experts of
    d_ff 24576, top-2; vocab 65536, untied), its depth cut to its
    pattern's positions ``JAMBA_LAYERS`` (SSM+dense, SSM+MoE,
    attention+dense), INT4.  The default budget's plan (disk) is printed;
    the run forces ``placement="host"`` (run o covers the disk tier):
    offloaded, depth 1, bf16 caches, ``b_max`` 4, ``max_len`` 256.  (g)'s
    prompts with ``JAMBA_NEW`` new tokens: exact launches
    (``int4_matmul`` a pass: 5 an SSM layer, 4 an attention layer, 3 a
    dense FFN, + 3 x the experts loaded; ``flash_attention`` = the
    prefills; ``decode_attention`` = the decode steps, group 8, dh 128);
    per decode step its ms, the weight bytes (units, routed union) and
    the state/halo and KV bytes; the build's seconds and peak RSS; the
    peak beside the memory model's estimate and its parts; then the whole
    path as run (o)'s (held routing, flips at most 0.5 %)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, DENSE, MOE, SSM
    from repro_torch.serving.spec import EngineSpec, create_engine
    base = get_config("jamba-1.5-large-398b")
    layers = tuple(base.pattern[i] for i in JAMBA_LAYERS)
    cfg = dataclasses.replace(base, num_layers=len(layers), num_periods=0,
                              remainder=layers)
    spec = dict(arch="jamba-1.5-large-398b", cfg=cfg, quant="int4")
    dplan = EngineSpec(**spec).resolve()
    log(f"(v) default plan: {dplan.summary()}")
    log(f"(v) provenance: {json.dumps(dplan.provenance)}")
    plan = EngineSpec(**spec, placement="host").resolve()
    log(f"(v) plan: {plan.summary()}")
    if plan.engine != "offloaded" or plan.placement != "host":
        raise RuntimeError(f"run v: unexpected plan {plan.summary()}")
    cfg = plan.model_config()
    E = cfg.moe.num_experts
    reqs = [(p, JAMBA_NEW) for p, _ in paper_requests(np, cfg.vocab_size)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"(v) built in {build_s:.1f} s; peak RSS {peak_rss_gb():.1f} GiB")
    moe_units = [u for u in eng.units if u.moe]
    keys = [k for u in moe_units for k in u.expert_keys]
    per = {eng.weights.nbytes(k) for k in keys}
    kinds = [(u.spec.mixer, u.spec.ffn) for u in eng.units]
    n_moe = sum(s.ffn == MOE for s in layers)
    if (len(eng.units) != len(layers) or len(moe_units) != n_moe
            or len(keys) != n_moe * E or len(per) != 1):
        raise RuntimeError(f"run v: units {kinds}, {len(keys)} experts, "
                           f"sizes {per}")
    per_expert = per.pop()
    steps, snap = [], [dict(eng.weights.load_counts), dict(eng.stats),
                       len(eng.trace.events())]

    def on_step():
        now, st = dict(eng.weights.load_counts), dict(eng.stats)
        prev, pst, i0 = snap
        evs = eng.trace.events()
        steps.append({
            "prefills": st["prefills"] - pst["prefills"],
            "decode": st["decode_steps"] - pst["decode_steps"],
            "experts_per_layer": [
                sum(now.get(k, 0) - prev.get(k, 0) for k in u.expert_keys)
                for u in moe_units],
            "kv_load_bytes": sum(e.nbytes for e in evs[i0:]
                                 if e.kind == "kv_load"),
            "kv_save_bytes": sum(e.nbytes for e in evs[i0:]
                                 if e.kind == "kv_save")})
        snap[:] = [now, st, len(evs)]

    r = serve_once(torch, ops, eng, reqs, 0, on_step=on_step)
    st = r["stats"]
    passes = st["prefills"] + st["decode_steps"]
    loads = sum(sum(s["experts_per_layer"]) for s in steps)
    per_pass = sum({SSM: 5, ATTN: 4}[s.mixer] for s in layers) \
        + 3 * sum(s.ffn == DENSE for s in layers)
    check_launches("v", r["counts"], {
        "flash_attention": st["prefills"], "flash_attention_q_offset": 0,
        "decode_attention": st["decode_steps"], "decode_attention_int4": 0,
        "int4_matmul": 3 * loads + per_pass * passes}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != JAMBA_NEW or not all(0 <= t < cfg.vocab_size
                                                 for t in outs[i])
            for i in range(len(reqs))):
        raise RuntimeError(f"run v: bad tokens {outs}")
    unit_bytes = sum(eng.weights.nbytes(u.key) for u in eng.units)
    decode = [dict(ms=1e3 * t, weight_bytes=unit_bytes + sum(
        s["experts_per_layer"]) * per_expert, **s)
        for t, s in zip(r["steps"], steps) if s["decode"] and not s["prefills"]]
    for d in decode:
        log(json.dumps({"v_decode_step": d}))
    ms = sorted(d["ms"] for d in decode)
    pk = eng.pipeline_report()["per_kind"]
    summary = {
        "run": "v", "plan": plan.summary(), "default_plan": dplan.summary(),
        "units": [f"{m}+{f}" for m, f in kinds], "build_s": build_s,
        "peak_rss_gb": peak_rss_gb(), "host_mem_gb": host_mem_gb(),
        "params": cfg.param_count(),
        "store_gb": (unit_bytes + len(keys) * per_expert) / 1e9,
        "unit_bytes": {u.key: eng.weights.nbytes(u.key) for u in eng.units},
        "per_expert_bytes": per_expert, "requests": len(reqs),
        "prompt_lens": [len(p) for p, _ in reqs], "max_new": JAMBA_NEW,
        **st, "wall_s": r["wall"], "tok_s": st["tokens_out"] / r["wall"],
        "prefill_steps": [dict(ms=1e3 * t, **s)
                          for t, s in zip(r["steps"], steps)
                          if s["prefills"]],
        "decode_step_ms_median": statistics.median(ms),
        "decode_union_mean": statistics.mean(
            u for d in decode for u in d["experts_per_layer"]),
        "expert_loads": loads,
        "busy_s": {k: pk[k]["busy_s"] for k in pk},
        "bytes": {k: pk[k]["bytes"] for k in pk},
        "compute_busy": eng.trace.busy_fraction("compute"),
        "device_max_allocated_gb": r["device_max_allocated_gb"],
        "launches": r["counts"]}
    summary.update(
        memory=memory_report(plan, eng, summary),
        memory_parts=memory_parts(np, plan, eng,
                                  r["device_max_allocated_gb"]),
        kv_bytes=ssm_step_bytes(np, eng, summary))
    log(json.dumps({"jamba_serving": summary}))
    summary["whole_path"] = moe_whole_path(
        torch, ops, np, eng, [(reqs[0][0], 2)], run="v")
    eng.shutdown()
    return summary["launches"], summary


def run_ssm(torch, ops, np, counts, summaries, release, stamp):
    """Runs (u) and (v), each engine released before the next."""
    counts["u"], summaries["u"] = run_mamba2(torch, ops, np)
    release(None)
    stamp("u")
    counts["v"], summaries["v"] = run_jamba(torch, ops, np)
    release(None)
    stamp("v")


# ---------------------------------------------------------------------------
# runs (w)-(x): the two resident-engine frontends (whisper's
# encoder-decoder, qwen2-vl's M-RoPE)
# ---------------------------------------------------------------------------

def resident_whole_path(torch, ops, eng, reqs, name):
    """Kernels against ``use_kernels(False)`` on a resident engine's
    weights: each request served with 2 new tokens in both arms; the
    encoder's output (an encoder-decoder's, at each prefill) and every
    prefill's final hidden states within 1e-4 x max, the first decode
    step's (all slots full, over each arm's own bf16 caches) within 2e-2
    x max, and each request's first token equal."""
    from repro_torch.models import transformer as T
    seen = {"encoder": [], "prefill": [], "decode": []}
    head, encode = T._head, T._encode

    def grab_head(params, x, cfg):
        seen["prefill" if x.shape[1] > 1 else "decode"].append(
            x[:, -1].detach().clone())
        return head(params, x, cfg)

    def grab_encode(*args, **kw):
        out = encode(*args, **kw)
        seen["encoder"].append(out.detach().clone())
        return out

    short = [(r[0], 2) + tuple(r[2:]) for r in reqs]
    arms = {}
    T._head, T._encode = grab_head, grab_encode
    try:
        for kernels, rid0 in ((True, 500), (False, 600)):
            ops.use_kernels(kernels)
            r = serve_once(torch, ops, eng, short, rid0)
            arms[kernels] = ({k: list(v) for k, v in seen.items()},
                             r["outs"])
            for v in seen.values():
                v.clear()
    finally:
        ops.use_kernels(True)
        T._head, T._encode = head, encode
    (hk, ok), (hp, op) = arms[True], arms[False]
    res = {}
    for phase in ("encoder", "prefill", "decode"):
        pairs = list(zip(hk[phase], hp[phase]))
        if phase == "decode":
            pairs = pairs[:1]
        if not pairs:
            continue
        if any(not torch.isfinite(a).all() for a, _ in pairs):
            raise RuntimeError(f"{name} {phase}: non-finite values")
        res[phase + "_rel_err"] = max(
            ((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
    res["first_tokens_equal"] = all(ok[i][0] == op[i][0] for i in ok)
    res["tokens_equal"] = sum(x == y for i in ok
                              for x, y in zip(ok[i], op[i]))
    res["tolerance_rel"] = {"encoder": HIDDEN_RTOL, "prefill": HIDDEN_RTOL,
                            "decode": BF16_HIDDEN_RTOL}
    log(json.dumps({f"{name}_whole_path": res}))
    if not res["first_tokens_equal"] \
            or res.get("encoder_rel_err", 0.0) > HIDDEN_RTOL \
            or res["prefill_rel_err"] > HIDDEN_RTOL \
            or res["decode_rel_err"] > BF16_HIDDEN_RTOL:
        raise RuntimeError(f"run {name}: kernels differ from plain: {res}")
    return res


def resident_summary(name, plan, build_s, r) -> dict:
    steps_ms = sorted(1e3 * x for x in r["steps"])
    st = r["stats"]
    return {"run": name, "plan": plan.summary(),
            "engine_why": plan.provenance["engine"], "build_s": build_s,
            **st, "wall_s": r["wall"], "tok_s": st["tokens_out"] / r["wall"],
            "step_ms_median": statistics.median(steps_ms),
            "step_ms_p90": steps_ms[int(0.9 * (len(steps_ms) - 1))],
            "ttft_s_median": statistics.median(r["ttft_s"]),
            "device_max_allocated_gb": r["device_max_allocated_gb"],
            "launches": r["counts"]}


def run_whisper(torch, ops, np):
    """Run (w): whisper-base at full width and depth through
    ``create_engine(EngineSpec(arch="whisper-base",
    max_len=WHISPER_MAX_LEN).resolve())`` (resident by
    ``offload_capability``): six requests on 4 slots, the first with the
    zero-frame stub, the others with seeded (1500, 512) frames; exact
    launches (per prefill 6 encoder, 6 self and 6 cross
    ``flash_attention``; per decode step 6 self and 6 cross
    ``decode_attention``); a rerun with a slot preempted after
    ``WHISPER_PREEMPT`` steps, the same tokens; then the whole path
    against ``use_kernels(False)``."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec import EngineSpec, create_engine
    plan = EngineSpec(arch="whisper-base",
                      max_len=WHISPER_MAX_LEN).resolve()
    log(f"(w) plan: {plan.summary()}; engine: {plan.provenance['engine']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if type(eng) is not ServingEngine:
        raise RuntimeError(f"run w: built {type(eng).__name__}")
    cfg = eng.cfg
    rng = np.random.default_rng(0)
    reqs = []
    for i, n in enumerate(WHISPER_PROMPTS):
        prompt = rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
        frames = (rng.standard_normal((cfg.encoder_seq_len, cfg.d_model))
                  .astype(np.float32) if i else None)
        reqs.append((prompt, WHISPER_NEW, frames))
    r = serve_once(torch, ops, eng, reqs, 0)
    n_enc, n, st = cfg.num_encoder_layers, cfg.num_layers, r["stats"]
    check_launches("w", r["counts"], {
        "flash_attention": (n_enc + 2 * n) * st["prefills"],
        "decode_attention": 2 * n * st["decode_steps"],
        "decode_attention_int4": 0, "int4_matmul": 0}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != WHISPER_NEW for i in outs) or any(
            not 0 <= t < cfg.vocab_size for o in outs.values() for t in o):
        raise RuntimeError(f"run w: bad tokens {outs}")
    summary = resident_summary("w", plan, build_s, r)
    rp = serve_once(torch, ops, eng, reqs, 100,
                    preempt_after=WHISPER_PREEMPT)
    summary["preempted"] = {"request": rp["preempted"],
                            "tokens_equal": rp["outs"] == outs,
                            "slot_restores": rp["stats"]["slot_restores"]}
    if rp["outs"] != outs or rp["stats"]["slot_restores"] != 1:
        raise RuntimeError(f"run w: the preempted rerun differs: "
                           f"{summary['preempted']}")
    summary["whole_path"] = resident_whole_path(torch, ops, eng, reqs, "w")
    summary["stub_vs_frames"] = {"stub_request_tokens": outs[0][:8],
                                 "frames_request_tokens": outs[1][:8]}
    log(json.dumps({"whisper": summary}))
    eng.shutdown()
    return r["counts"], summary


def run_qwen2vl(torch, ops, np):
    """Run (x): qwen2-vl-72b at full width, cut in depth to
    ``QWEN2VL_LAYERS`` layers, through ``create_engine`` (resident by
    ``offload_capability``: the embeds frontend, token prompts through
    the shared table); (g)'s four prompts at its vocabulary,
    ``QWEN2VL_NEW`` new tokens each; the M-RoPE angles on the card
    bit-equal to 1-D rope at equal components; exact launches (per
    prefill one ``flash_attention`` a layer, per decode step one
    ``decode_attention`` a layer); the peak device memory beside the
    plan's budget and the memory model's estimate; then the whole path
    against ``use_kernels(False)``."""
    from repro_torch.configs import get_config
    from repro_torch.core.memory_model import estimate
    from repro_torch.models import transformer as T
    from repro_torch.models.rope import rope_angles
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.spec import EngineSpec, create_engine
    cfg = dataclasses.replace(get_config("qwen2-vl-72b"),
                              num_layers=QWEN2VL_LAYERS,
                              num_periods=QWEN2VL_LAYERS)
    plan = EngineSpec(arch="qwen2-vl-72b", cfg=cfg,
                      max_len=QWEN2VL_MAX_LEN).resolve()
    log(f"(x) plan: {plan.summary()}; engine: {plan.provenance['engine']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = create_engine(plan)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if type(eng) is not ServingEngine:
        raise RuntimeError(f"run x: built {type(eng).__name__}")
    # M-RoPE on the card: a prompt's positions and ragged decode ones
    pos = torch.arange(QWEN2VL_MAX_LEN, device=eng.dev)
    ragged = torch.tensor([[113], [92], [80], [57]], device=eng.dev)
    mrope = {}
    for label, p_ in (("prompt", pos), ("ragged", ragged)):
        a3 = T._angles(cfg, p_)
        a1 = rope_angles(p_, cfg.head_dim, cfg.rope_theta)
        mrope[label] = {"shape": list(a3.shape), "device": str(a3.device),
                        "bit_equal_1d": bool(torch.equal(a3, a1)),
                        "max_abs_diff": (a3 - a1).abs().max().item()}
    log(json.dumps({"mrope_angles_on_card": mrope}))
    if not all(v["bit_equal_1d"] for v in mrope.values()):
        raise RuntimeError(f"run x: M-RoPE differs from 1-D rope: {mrope}")
    reqs = [(p, QWEN2VL_NEW) for p, _ in paper_requests(np, cfg.vocab_size)]
    r = serve_once(torch, ops, eng, reqs, 0)
    n, st = cfg.num_layers, r["stats"]
    check_launches("x", r["counts"], {
        "flash_attention": n * st["prefills"],
        "decode_attention": n * st["decode_steps"],
        "decode_attention_int4": 0, "int4_matmul": 0}, exact=True)
    outs = r["outs"]
    if sorted(outs) != list(range(len(reqs))) or any(
            len(outs[i]) != QWEN2VL_NEW for i in outs) or any(
            not 0 <= t < cfg.vocab_size for o in outs.values() for t in o):
        raise RuntimeError(f"run x: bad tokens {outs}")
    summary = resident_summary("x", plan, build_s, r)
    est = estimate(cfg, batch=plan.b_max, seq=plan.max_len, p=4, preload=0)
    params_n = sum(t.numel() for t in tree_leaves(eng.params))
    summary["memory"] = {
        "device_max_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
        "device_budget_gb": plan.device_budget / 2**30,
        "modeled_weights_gb": est.weights / 2**30,
        "modeled_w_plus_m_gb": (est.weights + max(est.peak_prefill,
                                                  est.peak_decode)) / 2**30,
        "parameters": params_n, "parameter_gb": 4 * params_n / 2**30,
        "peak_rss_gb": peak_rss_gb()}
    summary["whole_path"] = resident_whole_path(torch, ops, eng, reqs, "x")
    log(json.dumps({"qwen2_vl": summary}))
    eng.shutdown()
    return r["counts"], summary


def tree_leaves(tree):
    """Every tensor of a nested dict/tuple parameter tree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def run_frontends(torch, ops, np, counts, summaries, release, stamp):
    """Runs (w) and (x), each engine released before the next."""
    counts["w"], summaries["w"] = run_whisper(torch, ops, np)
    release(None)
    stamp("w")
    counts["x"], summaries["x"] = run_qwen2vl(torch, ops, np)
    release(None)
    stamp("x")


# ---------------------------------------------------------------------------
# run (y): single-device training
# ---------------------------------------------------------------------------

def run_train(torch, ops, np, card):
    """Run (y): tinyllama-1.1b trained through ``launch.train.main`` on
    the card (its own seed-0 draws, the script holding nothing on the
    card, so the peak is the entry point's), a resume, then an
    uninterrupted run from seed 0's draws taken once more and reused;
    the checks and numbers of step 17.  Returns (launch counts,
    summary, seed 0's draws on the card for run (z))."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.tree import flatten_with_path, leaves
    cfg = get_config(TRAIN_ARCH)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    root = Path(tempfile.mkdtemp(prefix="pipo_train_"))

    def argv(steps, d):
        return ["--arch", TRAIN_ARCH, "--steps", str(steps), "--seq",
                str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--ckpt",
                str(root / d), "--device", "cuda"]
    before = dict(ops.LAUNCHES)
    failed = []
    try:
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train.main(argv(TRAIN_STEPS, "run"))
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ckpt = root / "run" / f"step_{TRAIN_STEPS}"
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
        saved = {"params": first.pop("params"),
                 "opt": first.pop("opt_state")}
        n = sum(t.numel() for t in leaves(saved["params"]))
        pbytes = sum(t.numel() * t.element_size()
                     for t in leaves(saved["params"]))
        state_bytes = 2 * pbytes + 8 * n      # params, grads, f32 m and v
        t0 = time.perf_counter()
        back, _ = restore_checkpoint(str(root / "run"), TRAIN_STEPS, saved)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        unequal = [path for (path, a), b in zip(flatten_with_path(saved),
                                                 leaves(back))
                   if a.dtype != b.dtype or a.device != b.device
                   or not torch.equal(a, b)]
        del saved, back
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        init = build_model(cfg).init(0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = train.main(argv(TRAIN_RESUME, "run"), init_params=init)
        resumed_s = time.perf_counter() - t0
        del resumed["params"], resumed["opt_state"]
        shutil.rmtree(root / "run")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        whole = train.main(argv(TRAIN_RESUME, "whole"), init_params=init)
        whole_s = time.perf_counter() - t0
        del whole["params"], whole["opt_state"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.tree import tree_map
    breakdown = train_breakdown(torch, build_model(cfg), tree_map(
        lambda t: t.detach().clone(), init))
    gc.collect()
    torch.cuda.empty_cache()
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]
    resume_rel = rel(resumed["losses"], whole["losses"][TRAIN_STEPS:])
    first_rel = rel(first["losses"], whole["losses"][:TRAIN_STEPS])
    losses = first["losses"] + resumed["losses"] + whole["losses"]
    if unequal:
        failed.append(f"restored leaves differ from the saved: {unequal[:5]}")
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"losses not finite: {losses}")
    if not TRAIN_FIRST_LOSS[0] < first["losses"][0] < TRAIN_FIRST_LOSS[1]:
        failed.append(f"step 1's loss {first['losses'][0]} outside "
                      f"{TRAIN_FIRST_LOSS}")
    if (resumed["restore_s"] is None or resumed["final_step"] != TRAIN_RESUME
            or len(resumed["losses"]) != TRAIN_RESUME - TRAIN_STEPS):
        failed.append("the second call did not resume from step "
                      f"{TRAIN_STEPS}: {resumed['final_step']}, "
                      f"{resumed['losses']}")
    if max(resume_rel + first_rel) > TRAIN_RTOL:
        failed.append(f"resumed/first losses differ from the uninterrupted "
                      f"run's: {resume_rel} {first_rel}")
    if any(launched.values()):
        failed.append(f"training launched kernels: {launched}")
    step_s = whole["step_s"][1:]
    med = statistics.median(step_s)
    model_flops, remat_flops = 6 * n * tokens, 2 * n * tokens
    summary = {
        "run": "y", "arch": TRAIN_ARCH, "card": card, "params": n,
        "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "tokens_per_step": tokens,
        "draw_s": draw_s,
        "losses": {"first": first["losses"], "resumed": resumed["losses"],
                   "uninterrupted": whole["losses"]},
        "resume_rel": resume_rel, "first_rel": first_rel,
        "restored_bit_equal": not unequal,
        "step_ms": {"first_step": [first["step_s"][0] * 1e3,
                                   whole["step_s"][0] * 1e3],
                    "median": med * 1e3,
                    "steps": [t * 1e3 for t in step_s],
                    "first_call_rest": [t * 1e3 for t in
                                        first["step_s"][1:]]},
        "tokens_per_s": tokens / med,
        "flops_per_step": {"model_6NT": model_flops,
                           "remat_forward_2NT": remat_flops,
                           "total": model_flops + remat_flops,
                           "attention": "not counted"},
        "bf16_peak_share": {"model": model_flops / med / BF16_PEAK,
                            "with_remat": (model_flops + remat_flops)
                            / med / BF16_PEAK},
        "peak_device_gib": (peak - held) / 2**30,
        "script_held_gib": held / 2**30,
        "state_gib": state_bytes / 2**30,
        "checkpoint": {"bytes": ckpt_bytes,
                       "save": first["ckpt_s"],
                       "restore_s": restore_s,
                       "runner_restore_s": resumed["restore_s"]},
        "call_s": {"first": first_s, "resumed": resumed_s,
                   "uninterrupted": whole_s},
        "breakdown": breakdown, "launches": launched, "failed": failed,
    }
    log(json.dumps({"train": summary}))
    log(f"(y) {TRAIN_ARCH} train on {card}: {med * 1e3:.1f} ms a step "
        f"(first {first['step_s'][0] * 1e3:.0f} ms), "
        f"{tokens / med:.0f} tok/s, "
        f"{summary['bf16_peak_share']['model']:.3f} of the bf16 peak "
        f"(6NT), peak {(peak - held) / 2**30:.2f} GiB vs state "
        f"{state_bytes / 2**30:.2f} GiB, checkpoint "
        f"{ckpt_bytes / 1e9:.2f} GB")
    if failed:
        raise RuntimeError(f"run (y) failed: {failed}")
    return launched, summary, init


def train_breakdown(torch, model, params):
    """Where a (y) step goes, on the draws ``params`` (updated in place)
    and step 0's batch: the forward alone (no grad, no remat), the
    forward and backward with remat (``value_and_grad``), the in-place
    AdamW update, each timed by the host around a synchronized call
    (the calls of ``launch.train.main`` before it ran the same shapes);
    then one whole step under ``torch.profiler``: the card's busy share
    and the kernels that took the most device time."""
    from repro_torch.data import DataConfig, DataPipeline, SyntheticSource
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import AdamW, apply_updates
    dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      vocab_size=model.cfg.vocab_size)
    batch = DataPipeline(SyntheticSource(dcfg), dcfg).batch_at(0)
    batch.pop("step")
    opt = AdamW()
    state = opt.init(params)
    step = make_train_step(model, opt)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    tb = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    with torch.no_grad():
        _, fwd_ms = timed(lambda: model.train_loss(params, tb, remat=False))
    (_, grads), fb_ms = timed(lambda: value_and_grad(model, params, batch))

    def update():
        upd, _, _ = opt.update(grads, state, params)
        apply_updates(params, upd)
    _, opt_ms = timed(update)
    del grads
    out = {"forward_ms": fwd_ms, "forward_backward_remat_ms": fb_ms,
           "adamw_ms": opt_ms,
           "profiled_step": profiled(torch, lambda: step(params, state,
                                                         batch))}
    log(json.dumps({"train_breakdown": out}))
    return out


@contextlib.contextmanager
def labelled(torch, sites, label: str):
    """For the block's duration, wrap each ``(module, name)`` function of
    ``sites`` in ``torch.profiler.record_function(label)``, so that a
    profile can tell which operators it called itself."""
    saved = [(m, a, getattr(m, a)) for m, a in sites]

    def wrap(fn):
        def labelled_fn(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return labelled_fn
    for m, a, fn in saved:
        setattr(m, a, wrap(fn))
    try:
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def cast_events(events, label: str, inner: str):
    """The ``aten::to`` events called by a function ``labelled`` with
    ``label`` itself: their nearest ``aten::`` or labelled ancestor is
    ``label`` (not ``inner``, the label of the functions it calls)."""
    out = []
    for e in events:
        if e.name != "aten::to":
            continue
        p = e.cpu_parent
        while p is not None and not (p.name in (label, inner)
                                     or p.name.startswith("aten::")):
            p = p.cpu_parent
        if p is not None and p.name == label:
            out.append(e)
    return out


def subtree_device_ms(e) -> float:
    """Device ms of the kernels an operator and its callees launched."""
    own = getattr(e, "self_device_time_total", None)
    if own is None:
        own = e.self_cuda_time_total
    return own / 1e3 + sum(subtree_device_ms(c) for c in e.cpu_children)


def profiled(torch, fn, casts_of=None) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's busy share
    over its span, its device ms and kernels, the host's operator count
    (``aten::`` calls, the collectives' ``c10d::`` ones apart) and the
    eight kernels that took the most device time.  With ``casts_of``, a
    pair of ``labelled`` labels (the ops', the kernel wrappers'), also
    the ``aten::to`` calls the ops made themselves (``casts``), those
    whose launches the trace holds (``casts_timed``: a long run's trace
    can miss a few) and their device ms (``casts_ms``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in (casts_of or ())]
    host = [e.name for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    counts = {"aten_ops": sum(n.startswith("aten::") for n in host),
              "c10d_ops": sum(n.startswith("c10d::") for n in host)}
    casts = {}
    if casts_of is not None:
        ms = [subtree_device_ms(e) for e in cast_events(events, *casts_of)]
        casts = {"casts": len(ms), "casts_timed": sum(t > 0 for t in ms),
                 "casts_ms": sum(ms)}
    if not dev:                 # CUDA events around one more call
        TIMER["empty_traces"] += 1
        TIMER["device"] = "cuda events"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return {**busy_share([]), "device_ms": start.elapsed_time(end),
                "kernels": None, **counts, "top_ms": [],
                "timer": "cuda events", **casts}
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {**busy_share([(e.time_range.start, e.time_range.end)
                          for e in dev]),
            "device_ms": sum(by_name.values()), "kernels": len(dev),
            **counts, "top_ms": [[n[:80], ms] for n, ms in top],
            "timer": "cupti", **casts}


# ---------------------------------------------------------------------------
# run (z): the sharding slice on a (1, 1) mesh of the card
# ---------------------------------------------------------------------------

def head_inputs(L):
    """Patch ``layers.lm_head_argmax`` to record each call's input (the
    normed last rows, (b, 1, d)); returns (records, restore)."""
    rec, orig = [], L.lm_head_argmax

    def wrapped(p, x, ctx):
        rec.append(x.detach().float().clone())
        return orig(p, x, ctx)
    L.lm_head_argmax = wrapped

    def restore():
        L.lm_head_argmax = orig
    return rec, restore


def shard_serve(torch, model, params, toks, dist, L):
    """Prefill ``toks`` then SHARD_NEW greedy decode steps under ``dist``
    (None: the local path); (tokens (b, 1 + SHARD_NEW), head inputs)."""
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    rec, restore = head_inputs(L)
    try:
        with torch.no_grad():
            cache_len = SHARD_PROMPT + SHARD_NEW
            tok, caches = model.prefill(params, {"tokens": toks}, dist,
                                        cache_len)
            out = [whole(tok)]
            for k in range(SHARD_NEW):
                tok, caches = model.decode_step(
                    params, {"token": out[-1][:, None],
                             "pos": SHARD_PROMPT + k}, caches, dist)
                out.append(whole(tok))
        torch.cuda.synchronize()
    finally:
        restore()
    return torch.stack(out, 1), rec


def shard_scaled(torch, ops, np, dist):
    """The five scaled archs on ``dist``'s mesh against their local plain
    path: loss and grad norm of one batch (b 4, s 32, f32), prefill and
    one decode step's tokens."""
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.launch import sharding as S
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model import build_model
    from repro_torch.optim import global_norm
    out, failed = {}, []
    rng = np.random.default_rng(1)
    for arch in SHARD_ARCHS:
        cfg = scaled_down(get_config(arch), **SHARD_SCALE)
        model = build_model(cfg)
        params = model.init(0, device="cuda", dtype=torch.float32)
        placed = S.place(params, S.param_pspecs(cfg, dist), dist.mesh)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                                     .astype(np.int32)).cuda()
                 for k in ("labels", "tokens")}
        t0 = time.perf_counter()
        was = ops.kernels_enabled()
        ops.use_kernels(False)
        try:
            loss_l, g_l = value_and_grad(model, params, batch)
            loss_m, g_m = value_and_grad(model, placed, batch, dist=dist)
            gn_l, gn_m = float(global_norm(g_l)), float(global_norm(g_m))
            with torch.no_grad():
                toks = {"tokens": batch["tokens"]}
                t_l, c_l = model.prefill(params, toks, 36)
                d_l, _ = model.decode_step(params, {"token": t_l[:, None],
                                                    "pos": 32}, c_l)
                t_m, c_m = model.prefill(placed, toks, dist, 36)
                t_m = t_m.full_tensor()
                d_m, _ = model.decode_step(placed, {"token": t_m[:, None],
                                                    "pos": 32}, c_m, dist)
                d_m = d_m.full_tensor()
        finally:
            ops.use_kernels(was)
        torch.cuda.synchronize()
        r = {"loss": [float(loss_l), float(loss_m)],
             "loss_rel": abs(float(loss_m) - float(loss_l)) / abs(float(loss_l)),
             "grad_norm": [gn_l, gn_m], "gn_rel": abs(gn_m - gn_l) / gn_l,
             "prefill_equal": bool(torch.equal(t_l, t_m)),
             "decode_equal": bool(torch.equal(d_l, d_m)),
             "s": time.perf_counter() - t0}
        out[arch] = r
        if (r["loss_rel"] > 2e-4 or r["gn_rel"] > 1e-3
                or not (r["prefill_equal"] and r["decode_equal"])):
            failed.append(f"{arch}: {r}")
        del params, placed, g_l, g_m
    return out, failed


def run_shard(torch, ops, np, card, init=None, profile=False):
    """Run (z), step 18: the sharded path on a world-1 NCCL group and a
    (1, 1) mesh against the local path.  ``init``: (y)'s seed-0 draws on
    the card (drawn here when None).  ``profile``: one more step each
    way under ``torch.profiler`` (``profiled``; about 10 s of tracing,
    so only ``--only shard`` takes it).  Returns (launch counts,
    summary)."""
    import shutil
    import tempfile
    import torch.distributed as tdist
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, DataPipeline, SyntheticSource
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import common as C
    from repro_torch.models import layers as L
    from repro_torch.models.common import Dist
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    t_run = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    draw_s = None
    if init is None:
        t0 = time.perf_counter()
        init = model.init(0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
    root = Path(tempfile.mkdtemp(prefix="pipo_shard_"))
    before = dict(ops.LAUNCHES)
    failed = []
    clone = lambda tree: tree_map(lambda t: t.detach().clone(), tree)
    t0 = time.perf_counter()
    tdist.init_process_group("nccl", store=tdist.FileStore(
        str(root / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_test_mesh(model=1, data=1, device="cuda")
        dist = S.make_dist(mesh)
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - t0

        # -- train: SHARD_STEPS steps under the mesh, then locally --------
        opt = AdamW()
        pspecs, ospecs = S.param_pspecs(cfg, dist), S.zero_pspecs(cfg, dist)
        dcfg = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                          vocab_size=cfg.vocab_size)
        data = DataPipeline(SyntheticSource(dcfg), dcfg)
        batches = [{k: v for k, v in data.batch_at(i).items() if k != "step"}
                   for i in range(SHARD_STEPS)]

        def train(params, state, step_fn):
            res, ms = [], []
            for b in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                params, state, m = step_fn(params, state, b)
                res.append((float(m["loss"]), float(m["grad_norm"])))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            return params, state, res, ms
        pm = S.place(init, pspecs, mesh)
        sm = opt.init(pm)
        for k in ("m", "v"):
            sm[k] = S.redistribute(sm[k], ospecs[k], mesh)
        C.COLLECTIVES.clear()
        pm, sm, mesh_res, mesh_ms = train(pm, sm, make_train_step(
            model, dist, opt))
        per_step = {k: v / SHARD_STEPS for k, v in C.COLLECTIVES.items()}
        # one more mesh step under the profiler: the card's share of the
        # mesh's extra step time, and the host's operators
        mesh_prof = profile and profiled(torch, lambda: make_train_step(
            model, dist, opt)(pm, sm, batches[0]))
        del sm
        pl = clone(init)
        sl = opt.init(pl)
        pl, sl, loc_res, loc_ms = train(pl, sl, make_train_step(model, opt))
        local_prof = profile and profiled(torch, lambda: make_train_step(
            model, opt)(clone(pl), sl, batches[0]))
        del sl
        loss_rel = [abs(a[0] - b[0]) / abs(b[0])
                    for a, b in zip(mesh_res, loc_res)]
        gn_rel = [abs(a[1] - b[1]) / abs(b[1])
                  for a, b in zip(mesh_res, loc_res)]
        if max(loss_rel) > 1e-3 or max(gn_rel) > 1e-2:
            failed.append(f"train: losses {mesh_res} vs {loc_res}")

        # -- checkpoints: the mesh's under Dist.local(), and the reverse --
        t0 = time.perf_counter()
        save_checkpoint(str(root / "mesh"), SHARD_STEPS, {"params": pm})
        back, _ = restore_checkpoint(str(root / "mesh"), SHARD_STEPS,
                                     {"params": pl})
        whole = S.unplace(pm)
        bad = [p for (p, a), b in zip(flatten_with_path(whole),
                                      leaves(back["params"]))
               if a.dtype != b.dtype or not torch.equal(a, b)]
        del back, whole
        save_checkpoint(str(root / "local"), SHARD_STEPS, {"params": pl})
        back, _ = restore_checkpoint(str(root / "local"), SHARD_STEPS,
                                     {"params": pm})
        bad += [p for (p, a), b in zip(flatten_with_path(pl),
                                       leaves(back["params"]))
                if not hasattr(b, "placements") or a.dtype != b.dtype
                or not torch.equal(a, b.to_local())]
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
        if bad:
            failed.append(f"checkpoint leaves differ: {bad[:5]}")
        del back, pm, pl
        gc.collect()
        torch.cuda.empty_cache()

        # -- serve in f32: the local path's kernels vs the plain islands --
        pf = tree_map(lambda t: t.float(), init)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, SHARD_PROMPT)).astype(np.int32)).cuda()
        dkv = Dist(mesh=mesh, data_axes=("data",), model_axis="model",
                   kv_axes=("model",))
        launched0 = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        tok_l, hid_l = shard_serve(torch, model, pf, toks, None, L)
        serve_local_s = time.perf_counter() - t0
        serve_launch = {k: ops.LAUNCHES[k] - launched0[k] for k in launched0}
        pfm = S.place(pf, pspecs, mesh)
        del pf
        t0 = time.perf_counter()
        tok_m, hid_m = shard_serve(torch, model, pfm, toks, dkv, L)
        serve_mesh_s = time.perf_counter() - t0
        del pfm
        errs = [float((a - b).abs().max()) / float(a.abs().max())
                for a, b in zip(hid_l, hid_m)]
        if not torch.equal(tok_l, tok_m):
            failed.append(f"serve tokens differ: {tok_l.tolist()} vs "
                          f"{tok_m.tolist()}")
        if len(errs) != 1 + SHARD_NEW or max(errs) > SHARD_HIDDEN_TOL:
            failed.append(f"head inputs differ: {errs}")
        if not (serve_launch["flash_attention"] and
                serve_launch["decode_attention"]):
            failed.append(f"the local serve launched {serve_launch}")
        gc.collect()
        torch.cuda.empty_cache()

        # -- the scaled archs: MoE, SSM and MLA islands on the card ------
        t0 = time.perf_counter()
        scaled, bad = shard_scaled(torch, ops, np, dist)
        scaled_s = time.perf_counter() - t0
        failed += bad
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    summary = {
        "run": "z", "arch": TRAIN_ARCH, "card": card, "mesh": {"data": 1,
                                                               "model": 1},
        "nccl_init_s": nccl_s, "draw_s": draw_s,
        "train": {"mesh": mesh_res, "local": loc_res, "loss_rel": loss_rel,
                  "grad_norm_rel": gn_rel, "mesh_step_ms": mesh_ms,
                  "local_step_ms": loc_ms,
                  "collectives_per_step": per_step,
                  "profiled_step": {"mesh": mesh_prof or None,
                                    "local": local_prof or None}},
        "checkpoint_s": ckpt_s,
        "serve": {"tokens_equal": bool(torch.equal(tok_l, tok_m)),
                  "head_input_rel": errs, "local_s": serve_local_s,
                  "mesh_s": serve_mesh_s, "local_launches": serve_launch},
        "scaled": scaled, "scaled_s": scaled_s,
        "wall_s": time.perf_counter() - t_run, "launches": launched,
        "failed": failed}
    log(json.dumps({"shard": summary}))
    log(f"(z) {TRAIN_ARCH} on a (1, 1) mesh, {card}: "
        f"{statistics.median(mesh_ms[1:]):.1f} ms a step under the mesh vs "
        f"{statistics.median(loc_ms[1:]):.1f} locally (first "
        f"{mesh_ms[0]:.0f}/{loc_ms[0]:.0f}), NCCL set-up {nccl_s:.2f} s, "
        f"{sum(per_step.values()):.0f} collectives a train step "
        f"{per_step}; "
        + (f"a profiled step: device {mesh_prof['device_ms']:.1f} ms, "
           f"{mesh_prof['aten_ops']} aten ops under the mesh vs "
           f"{local_prof['device_ms']:.1f} ms, {local_prof['aten_ops']} "
           f"locally; " if profile else "")
        + f"serve head inputs within {max(errs):.2e} x max, "
        f"(z) {summary['wall_s']:.1f} s")
    if failed:
        raise RuntimeError(f"run (z) failed: {failed}")
    return launched, summary


# ---------------------------------------------------------------------------
# runs (aa)-(ac): the tooling slice
# ---------------------------------------------------------------------------

def w4_serve(torch, model, params, toks, caches_out=None, steps=W4_STEPS):
    """Prefill ``toks`` (b, W4_PROMPT) into a W4_CACHE-row cache, then
    ``steps`` greedy decode steps, through ``launch.steps``; (tokens (b,
    1 + steps), the head inputs: the prefill's, then each step's)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    rec, restore = head_inputs(L)
    try:
        tok, caches = make_prefill_step(model, W4_CACHE)(params,
                                                         {"tokens": toks})
        out = [tok]
        step = make_decode_step(model)
        for k in range(steps):
            tok, caches = step(params, {"token": out[-1][:, None],
                                        "pos": W4_PROMPT + k}, caches)
            out.append(tok)
        torch.cuda.synchronize()
    finally:
        restore()
    if caches_out is not None:
        caches_out.append(caches)
    return torch.stack(out, 1), rec


def run_w4(torch, ops, np, card):
    """Run (aa): tinyllama-1.1b at full width and depth with resident
    INT4 tables (``quant_weights``: ``wq``, ``wk``, ``wv``, ``wo``,
    ``w_gate``, ``w_up``, ``w_down`` packed, drawn from seed 0 as packed
    bytes), f32 activations, ``Dist.local()``: ``make_prefill_step`` on
    b 4 x 128 tokens, then 16 ``make_decode_step`` calls, against the
    same on ``use_kernels(False)`` (hidden states at the prefill within
    1e-4 x max, tokens equal) with exact launches: ``int4_matmul`` at
    each packed projection the reference runs (the dense feed-forward is
    skipped in both packages: ROADMAP Queue 3 item 24), ``flash_attention``
    a layer at the prefill, ``decode_attention`` a layer a step.  Then
    the roofline counter's count of one decode step on meta tensors
    beside its profiled device ms and the peak memory.  Then the bf16
    instances at full width: one bf16 decode step, a bf16 prefill
    and ``W4_BF16_STEPS`` decode steps, and one step over the caches
    packed as INT4 KV rows (``pack_kv``), each against
    ``use_kernels(False)`` (head inputs within 2e-2 x max, tokens equal,
    exact launches of each bf16 instance), with its profile's device ms
    and the ``aten::to`` calls the ops made (none).
    Returns (launch counts, summary)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.roofline import HW, analyze_step, roofline_report
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              quant_weights=True)
    model = build_model(cfg)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    host = T.init_params(cfg, 0)
    params = T.to_device(host, dev)
    del host
    build_s = time.perf_counter() - t0
    packed = sorted(n[:-2] for n in L.layer_table(cfg, cfg.pattern[0])
                    if n.endswith("#q"))
    # the projections that run: the attention's (the reference's dense
    # feed-forward looks for an unpacked w_gate and is skipped)
    ran = [n for n in packed if not n.startswith("w_")]
    g = np.random.default_rng(0)
    toks = torch.tensor(g.integers(0, cfg.vocab_size, (W4_B, W4_PROMPT)),
                        device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    caches = []
    with torch.no_grad():
        out, (head, *_) = w4_serve(torch, model, params, toks, caches)
    serve_s = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    forwards = 1 + W4_STEPS
    expect = {"int4_matmul": len(ran) * cfg.num_layers * forwards,
              "flash_attention": cfg.num_layers,
              "decode_attention": cfg.num_layers * W4_STEPS,
              "decode_attention_int4": 0}
    check_launches("aa", counts, expect, exact=True)
    ops.use_kernels(False)
    try:
        with torch.no_grad():
            plain_out, (plain_head, *_) = w4_serve(torch, model, params,
                                                   toks)
    finally:
        ops.use_kernels(True)
    rel_f32 = ((head - plain_head).abs().max()
               / plain_head.abs().max()).item()
    same = bool(torch.equal(out, plain_out))
    if rel_f32 > HIDDEN_RTOL or not same:
        raise RuntimeError(f"(aa): prefill hidden states {rel_f32:.3e} x max "
                           f"(tol {HIDDEN_RTOL}), tokens equal {same}")
    # one more decode step: the counter on meta tensors, the card's
    # profile
    step = make_decode_step(model)
    pos = W4_PROMPT + W4_STEPS
    batch = {"token": out[:, -1:].contiguous(), "pos": pos}
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    from repro_torch.tree import tree_map
    acc = analyze_step(step, tree_map(meta, params),
                       {"token": meta(batch["token"]), "pos": pos},
                       tree_map(meta, caches[0]))
    rep = roofline_report({k: v for k, v in acc.items()
                           if k not in ("out", "kernels")}, HW())
    prof = profiled(torch, lambda: step(params, batch, caches[0]))
    count = {"t_bound_s": rep["t_bound_s"], "bottleneck": rep["bottleneck"],
             "flops": acc["flops"], "hbm_bytes": acc["hbm_bytes"],
             "temp_bytes": acc["temp_bytes"], "arg_bytes": acc["arg_bytes"],
             "int4_matmul_bytes_share": acc["kernels"]["int4_matmul"][
                 "bytes"] / acc["hbm_bytes"],
             "kernels_counted": {k: v["count"]
                                 for k, v in acc["kernels"].items()}}
    # one bf16 decode step (the packed tables keep their uint8 and f32):
    # the ops hand bf16 straight to the kernels' bf16 instances (the
    # ops' former cast path took 220 casts, 0.399 ms of 2.622 on the H100)
    def bf16(tree, name=None):
        if isinstance(tree, dict):
            return {k: bf16(v, k) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(bf16(v, name) for v in tree)
        return tree if T.keeps_dtype(name) else tree.to(torch.bfloat16)
    params_bf = bf16(params)
    caches_bf = tree_map(lambda t: t.to(torch.bfloat16), caches[0])
    n, proj = cfg.num_layers, len(ran) * cfg.num_layers
    bf_arm = {}
    for on in (True, False):    # the same step (it rewrites row ``pos``)
        rec, restore = head_inputs(L)
        ops.use_kernels(on)
        ops.reset_launches()
        try:
            with torch.no_grad():
                tok_bf, _ = step(params_bf, batch, caches_bf)
            torch.cuda.synchronize()
        finally:
            ops.use_kernels(True)
            restore()
        bf_arm[on] = (tok_bf, rec[0], dict(ops.LAUNCHES))
    bf_launches = bf_arm[True][2]
    bf_expect = {"int4_matmul": proj, "int4_matmul_bf16": proj,
                 "flash_attention": 0, "decode_attention": n,
                 "decode_attention_bf16": n, "decode_attention_int4": 0}
    check_launches("aa bf16", bf_launches, bf_expect, exact=True)
    bf_rel = ((bf_arm[True][1] - bf_arm[False][1]).abs().max()
              / bf_arm[False][1].abs().max()).item()
    bf_same = bool(torch.equal(bf_arm[True][0], bf_arm[False][0]))
    if bf_rel > BF16_HIDDEN_RTOL or not bf_same:
        raise RuntimeError(f"(aa) bf16 step: head inputs {bf_rel:.3e} x "
                           f"max (tol {BF16_HIDDEN_RTOL}), tokens equal "
                           f"{bf_same}")
    # the step's own profile: device ms, and the ``aten::to`` calls the
    # ops make themselves (told apart by labels on the ops and on the
    # kernel wrappers they call): none since the bf16 instances
    prof_bf = op_casts(torch, ops, lambda: step(params_bf, batch,
                                                caches_bf))
    # the bf16 instances on the prefill and over packed INT4 KV rows:
    # ``make_prefill_step`` at bf16 (flash and int4_matmul's tensor-core
    # path) and W4_BF16_STEPS decode steps, then one step over the
    # kernel arm's caches packed as the KV store's rows (PackedRows: the
    # layer's decode goes through decode_attention_int4 with bf16 q and
    # fresh rows), each against use_kernels(False)
    pf_arm = {}
    for on in (True, False):
        ops.use_kernels(on)
        ops.reset_launches()
        cs = []
        try:
            with torch.no_grad():
                t16, h16 = w4_serve(torch, model, params_bf, toks, cs,
                                    steps=W4_BF16_STEPS)
        finally:
            ops.use_kernels(True)
        pf_arm[on] = (t16, h16, dict(ops.LAUNCHES), cs[0])
    pf_expect = {"flash_attention": n, "flash_attention_bf16": n,
                 "decode_attention": n * W4_BF16_STEPS,
                 "decode_attention_bf16": n * W4_BF16_STEPS,
                 "int4_matmul": proj * (1 + W4_BF16_STEPS),
                 "int4_matmul_bf16": proj * (1 + W4_BF16_STEPS),
                 "decode_attention_int4": 0}
    check_launches("aa bf16 prefill", pf_arm[True][2], pf_expect, exact=True)
    if any(pf_arm[False][2].values()):
        raise RuntimeError(f"(aa) bf16 prefill: the plain arm launched "
                           f"{pf_arm[False][2]}")
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    pf_rel = [rel(a, b) for a, b in zip(pf_arm[True][1][:2],
                                        pf_arm[False][1][:2])]
    pf_first = bool(torch.equal(pf_arm[True][0][:, 0], pf_arm[False][0][:, 0]))
    pf_tokens = int((pf_arm[True][0] == pf_arm[False][0]).sum())
    if max(pf_rel) > BF16_HIDDEN_RTOL or not pf_first:
        raise RuntimeError(f"(aa) bf16 prefill: head inputs {pf_rel} x max "
                           f"(prefill, first step; tol {BF16_HIDDEN_RTOL}), "
                           f"first tokens equal {pf_first}")
    prof_pf = op_casts(torch, ops, lambda: make_prefill_step(
        model, W4_CACHE)(params_bf, {"tokens": toks}))
    # the tensor-core int4_matmul's share of the prefill (its one kernel
    # name, int4_tc_bf16_kernel<TM>, among the profile's top kernels)
    pf_int4_ms = sum(ms for name, ms in prof_pf["top_ms"] if "int4" in name)
    packed_caches = pack_kv(torch, pf_arm[True][3])
    batch16 = {"token": pf_arm[True][0][:, -1:].contiguous(),
               "pos": W4_PROMPT + W4_BF16_STEPS}
    pk_arm = {}
    for on in (True, False):
        rec, restore = head_inputs(L)
        ops.use_kernels(on)
        ops.reset_launches()
        try:
            with torch.no_grad():
                tok_pk, _ = step(params_bf, batch16, packed_caches)
            torch.cuda.synchronize()
        finally:
            ops.use_kernels(True)
            restore()
        pk_arm[on] = (tok_pk, rec[0], dict(ops.LAUNCHES))
    pk_expect = {"decode_attention_int4": n, "decode_attention_int4_bf16": n,
                 "int4_matmul": proj, "int4_matmul_bf16": proj,
                 "decode_attention": 0, "flash_attention": 0}
    check_launches("aa bf16 packed", pk_arm[True][2], pk_expect, exact=True)
    pk_rel = rel(pk_arm[True][1], pk_arm[False][1])
    pk_same = bool(torch.equal(pk_arm[True][0], pk_arm[False][0]))
    if pk_rel > BF16_HIDDEN_RTOL or not pk_same:
        raise RuntimeError(f"(aa) bf16 step over packed rows: head inputs "
                           f"{pk_rel:.3e} x max (tol {BF16_HIDDEN_RTOL}), "
                           f"tokens equal {pk_same}")
    prof_pk = op_casts(torch, ops, lambda: step(params_bf, batch16,
                                                packed_caches))
    casts = {"step": prof_bf["casts"], "prefill": prof_pf["casts"],
             "packed_step": prof_pk["casts"]}
    if any(casts.values()):
        raise RuntimeError(f"(aa) bf16: the ops cast ({casts}); the bf16 "
                           f"instances take bf16 as it is")
    bf16_counts = {k: bf_arm[True][2][k] + pf_arm[True][2][k]
                   + pk_arm[True][2][k] for k in ops.LAUNCHES}
    del params_bf, caches_bf, caches, packed_caches, pf_arm
    summary = {"card": card, "build_s": build_s, "serve_s": serve_s,
               "launches": counts, "expect": expect,
               "prefill_hidden_rel": rel_f32, "tokens_equal": same,
               "peak_gib": peak / 2**30, "step_device_ms": prof["device_ms"],
               "step_busy_share": prof["device_busy_share"],
               "step_top_ms": prof["top_ms"][:4], "counted": count,
               "bf16_step_device_ms": prof_bf["device_ms"],
               "bf16_step_device_ms_former_cast_path": 2.622,
               "bf16_step_op_casts": casts,
               "bf16_step_top_ms": prof_bf["top_ms"][:4],
               "bf16_head_rel_vs_plain": bf_rel,
               "bf16_tokens_equal": bf_same,
               "bf16_launches": bf_launches,
               "bf16_prefill": {"head_rel_vs_plain": pf_rel,
                                "first_tokens_equal": pf_first,
                                "tokens_equal": pf_tokens,
                                "tokens": W4_B * (1 + W4_BF16_STEPS),
                                "prefill_device_ms": prof_pf["device_ms"],
                                "prefill_device_ms_before": AA_PREFILL_BEFORE[0],
                                "int4_matmul_ms": pf_int4_ms,
                                "int4_matmul_ms_before": AA_PREFILL_BEFORE[1],
                                "top_ms": prof_pf["top_ms"][:4]},
               "bf16_packed_step": {"head_rel_vs_plain": pk_rel,
                                    "tokens_equal": pk_same,
                                    "device_ms": prof_pk["device_ms"],
                                    "top_ms": prof_pk["top_ms"][:4]},
               "bf16_launches_total": bf16_counts}
    log(json.dumps({"w4_run_aa": summary}))
    log(f"(aa) bf16 decode step, {card}: {prof_bf['device_ms']:.3f} ms of "
        f"device time (through the ops' former cast path: 2.622 ms, of it "
        f"0.399 ms in 220 casts), {casts['step']} op-made casts; bf16 "
        f"prefill head inputs within {max(pf_rel):.3e} x max, "
        f"{pf_tokens} of {W4_B * (1 + W4_BF16_STEPS)} "
        f"tokens equal; packed-row step {pk_rel:.3e} x max; the bf16 "
        f"prefill {prof_pf['device_ms']:.3f} ms of device time, "
        f"int4_matmul {pf_int4_ms:.3f} ms of it (on the TF32 path: "
        f"{AA_PREFILL_BEFORE[0]} / {AA_PREFILL_BEFORE[1]} ms)")
    del params
    return counts, summary


def op_casts(torch, ops, fn) -> dict:
    """``profiled(fn)`` with the kernel ops and their wrappers labelled,
    so that ``casts`` counts the ``aten::to`` calls the ops make
    themselves (none since the bf16 instances)."""
    from repro_torch.models import layers as L
    with labelled(torch, [(L, "int4_matmul_op"), (L, "flash_attention_op"),
                          (ops, "flash_attention_op"),
                          (ops, "decode_attention_op"),
                          (ops, "decode_attention_int4_op")], "kernel op"), \
            labelled(torch, [(ops, "int4_matmul"), (ops, "flash_attention"),
                             (ops, "decode_attention"),
                             (ops, "decode_attention_int4")],
                     "kernel wrapper"):
        return profiled(torch, fn, casts_of=("kernel op", "kernel wrapper"))


def pack_kv(torch, caches):
    """A resident cache tree with every attention layer's K and V slabs
    ((periods, b, S, hkv, dh)) packed as the KV store's rows: a list over
    the periods of ``PackedRows`` at the slab's dtype, which the decode
    step attends through ``decode_attention_int4``."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows

    def pack(c):
        P, b, S, hkv, dh = c.shape
        g = kv_group(hkv * dh)
        return [PackedRows(*quantize_kv_rows(c[p].reshape(b, S, hkv * dh), g),
                           g, c.dtype, (hkv, dh)) for p in range(P)]
    return {"pat": tuple({k: pack(t) if k in ("k", "v") else t
                          for k, t in d.items()} for d in caches["pat"]),
            "rem": caches["rem"]}


def run_dryrun_modes(torch):
    """Run (ab): the dry run's three modes through
    ``repro_torch.launch.dryrun``: ``--serving --arch tinyllama-1.1b
    --scaled`` on the card (the plan lines and one request served),
    ``--replay`` of a golden fixture, and one production-mesh cell per
    mixer family (``DRYRUN_CELLS``) in ``base`` and ``w4``, traced on
    meta tensors, each printed as the reference prints it and held to
    its expected status.  Returns the summary."""
    import io
    import tempfile
    from repro_torch.launch import dryrun as D
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        D.main(["--serving", "--arch", "tinyllama-1.1b", "--scaled"])
    serving_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"(ab) {line}")
    if not any(ln.startswith("[SMOKE] tinyllama-1.1b") for ln in lines):
        raise RuntimeError("(ab) --serving served no request")
    buf = io.StringIO()
    fixture = ROOT / "tests" / "fixtures" / "trace_warm_d1.json"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        D.main(["--replay", str(fixture)])
    replay_s = time.perf_counter() - t0
    replay_lines = buf.getvalue().splitlines()
    for line in replay_lines:
        log(f"(ab) {line}")
    if len(replay_lines) != 14:
        raise RuntimeError(f"(ab) --replay printed {len(replay_lines)} "
                           f"lines")
    rows, bad = [], []
    with tempfile.TemporaryDirectory(prefix="pipo_dryrun_") as out:
        for variant in ("base", "w4"):
            for arch, shape in DRYRUN_CELLS:
                row = D.run_cell(arch, shape, False, Path(out), variant)
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    D.print_row(row)
                log(f"(ab) {variant:4s} {buf.getvalue().rstrip()}")
                want = DRYRUN_EXPECT.get((arch, variant), "ok")
                if row["status"] != want:
                    bad.append((arch, shape, variant, row["status"],
                                row.get("error")))
                rows.append({k: row.get(k) for k in (
                    "arch", "shape", "variant", "status", "trace_s",
                    "bytes_per_device", "bottleneck", "t_bound_s",
                    "roofline_fraction", "error")})
    if bad:
        raise RuntimeError(f"(ab) cells with another status: {bad}")
    summary = {"serving_s": serving_s, "replay_s": replay_s,
               "cells": rows}
    log(json.dumps({"dryrun_run_ab": summary}))
    return summary


def run_link_probe(np):
    """Run (ac): the transfer suite on the card's disk tier: one
    ``LINK_KEY_BYTES`` key in a fresh ``DiskStore`` under the temporary
    directory, read cold (``DiskStore.drop_cache`` before each) by
    ``naive_disk_to_host``, ``blockwise_disk_to_host`` (3 threads) and
    ``pipelined_disk_to_device`` (to the card), each in GB/s and checked
    bit-equal to what was written, then ``sweep_block_size`` over 1-64
    MB (the reference's sizes, one read each, the page cache as the
    reads leave it).  Returns the summary."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core.offload import DiskStore
    from repro_torch.core import transfer as X
    root = tempfile.mkdtemp(prefix="pipo_link_")
    try:
        disk = DiskStore(root)
        data = np.frombuffer(np.random.default_rng(0).bytes(LINK_KEY_BYTES),
                             np.uint8).copy()
        t0 = time.perf_counter()
        disk.put("w", data)
        write_s = time.perf_counter() - t0
        out = {"key_bytes": LINK_KEY_BYTES, "write_s": write_s}
        for name, fn in (
                ("naive_disk_to_host", lambda: X.naive_disk_to_host(
                    disk, "w")),
                ("blockwise_disk_to_host", lambda: X.blockwise_disk_to_host(
                    disk, "w", n_threads=3)),
                ("pipelined_disk_to_device",
                 lambda: X.pipelined_disk_to_device(disk, "w", n_threads=3,
                                                    device="cuda"))):
            cold = disk.drop_cache("w")
            t0 = time.perf_counter()
            got = fn()
            if isinstance(got, torch.Tensor):
                torch.cuda.synchronize()
            s = time.perf_counter() - t0
            same = np.array_equal(got.cpu().numpy() if isinstance(
                got, torch.Tensor) else got, data)
            if not same:
                raise RuntimeError(f"(ac) {name} read other bytes")
            out[name] = {"gb_s": LINK_KEY_BYTES / s / 1e9, "s": s,
                         "cold": cold}
            del got
        t0 = time.perf_counter()
        dev = X.host_to_device(data, device="cuda")
        out["host_to_device"] = {"gb_s": LINK_KEY_BYTES / (
            time.perf_counter() - t0) / 1e9, "includes_pin": True}
        del dev
        out["sweep_block_size"] = [
            {"block_mb": bs / 2**20, "gb_s": bw / 1e9}
            for bs, bw in X.sweep_block_size(disk, "w", repeats=1)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(json.dumps({"link_probe_run_ac": out}))
    return out


def run_tooling(torch, ops, np, card, counts, summaries, stamp):
    """Runs (aa)-(ac), each its own phase."""
    counts["aa"], summaries["aa"] = run_w4(torch, ops, np, card)
    # the bf16 instances' home run: (aa)'s bf16 prefill, decode steps and
    # packed-row step, kernel arms only
    counts["aa_bf16"] = summaries["aa"]["bf16_launches_total"]
    gc.collect()
    torch.cuda.empty_cache()
    stamp("aa")
    summaries["ab"] = run_dryrun_modes(torch)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("ab")
    summaries["ac"] = run_link_probe(np)
    stamp("ac")


# ---------------------------------------------------------------------------
# run (ad): the port's examples on the card
# ---------------------------------------------------------------------------

def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not yet run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(torch, ops, name: str, argv):
    """One example's ``main(argv)`` on the card, its launch counts zeroed
    before and read after; returns (its result, the counts, seconds)."""
    main = load_example(name).main
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES), time.perf_counter() - t0


def run_examples(torch, ops, np, card, counts, summaries):
    """Run (ad): the three examples in this process, then one engine
    built through the legacy keywords against the spec path."""
    import shutil
    import tempfile
    import warnings
    t_phase = time.perf_counter()
    zero = {k: 0 for k in ops.LAUNCHES}
    # quickstart: 2 prompts of 32, 16 tokens: 1 prefill and 15 decode
    # passes through every layer's 4 + 3 packed projections
    out, c, sec = run_example(torch, ops, "quickstart_torch", [])
    n, gen = out["num_layers"], out["tokens"].shape[1]
    toks = out["tokens"]
    if toks.shape != (2, 16) or not ((toks >= 0) & (toks < 2048)).all():
        raise RuntimeError(f"run ad: quickstart tokens {toks.shape}")
    if (out["placement"], out["plan"].quant, out["depth"]) != (
            "device", "int4", 8):
        raise RuntimeError(f"run ad: quickstart plan {out['plan'].summary()}")
    check_launches("ad_quickstart", c, {
        **zero, "int4_matmul": 7 * n * gen, "flash_attention": n,
        "decode_attention": n * (gen - 1)}, exact=True)
    counts["ad_quickstart"] = c
    # the whole path at the example's shapes (dh 16, GQA group 2, K 128-
    # 1024) against use_kernels(False) on its engine and weights
    whole = whole_path_check(torch, ops, out["lm"], out["prompt"], toks)
    if not whole["prefill_tokens_equal"]:
        raise RuntimeError(f"run ad: quickstart first tokens differ: {whole}")
    summaries["ad_quickstart"] = {
        "s": sec, "plan": out["plan"].summary(),
        "tokens0": toks[0].tolist(), "launches": c, "whole_path": whole,
        **{k: out[k] for k in ("placement", "reason", "pipeline", "depth",
                               "use_int4_kernel", "throughput_tok_s",
                               "ttft_s", "compute_busy", "device_peak_gb")}}
    log(json.dumps({"example": "quickstart_torch",
                    **summaries["ad_quickstart"]}))
    # serve_offload: 10 ragged requests on the resident plan
    out, c, sec = run_example(torch, ops, "serve_offload_torch", [])
    st, n = out["stats"], out["num_layers"]
    if out["completed"] != 10 or out["host_kv_bytes"] <= 0:
        raise RuntimeError(f"run ad: serve_offload completed "
                           f"{out['completed']}/10, host KV bytes "
                           f"{out['host_kv_bytes']}")
    check_launches("ad_serve", c, {
        **zero, "flash_attention": n * st["prefills"],
        "decode_attention": n * st["decode_steps"]}, exact=True)
    counts["ad_serve"] = c
    whole = resident_whole_path(torch, ops, out["eng"], out["reqs"],
                                "ad_serve")
    out["eng"].shutdown()
    summaries["ad_serve"] = {
        "s": sec, "plan": out["plan"].summary(), "launches": c,
        "whole_path": whole,
        **{k: out[k] for k in ("completed", "stats", "tokens_out", "tok_s",
                               "ttft_p50_s", "ttft_p95_s",
                               "host_kv_bytes")}}
    log(json.dumps({"example": "serve_offload_torch",
                    **summaries["ad_serve"]}))
    # train_100m: lm-100m from seed 0 into a fresh checkpoint directory
    ckpt = tempfile.mkdtemp(prefix="train100m_torch_")
    try:
        out, c, sec = run_example(
            torch, ops, "train_100m_torch",
            ["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = out["losses"]
    if (out["final_step"] != EXAMPLE_TRAIN_STEPS
            or len(losses) != EXAMPLE_TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        raise RuntimeError(f"run ad: train_100m step {out['final_step']}, "
                           f"losses {losses[:2]} .. {losses[-2:]}")
    check_launches("ad_train", c, zero, exact=True)
    counts["ad_train"] = c
    summaries["ad_train"] = {
        "s": sec, "steps": out["final_step"], "params": out["params"],
        "loss_first": losses[0], "loss_mid": losses[len(losses) // 2],
        "loss_last": losses[-1], "tok_s": out["tok_s"],
        "timing": out["timing"], "launches": c}
    log(json.dumps({"example": "train_100m_torch", **summaries["ad_train"]}))
    gc.collect()
    torch.cuda.empty_cache()
    # the legacy keywords against the spec path: plan JSON and tokens
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.serving import spec as S
    from repro_torch.serving.offload_engine import OffloadedServingEngine
    cfg = scaled_down(get_config("tinyllama-1.1b"))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, (12 + 9 * i,)).astype(np.int32),
             LEGACY_NEW) for i in range(2)]
    t0 = time.perf_counter()
    S.reset_deprecation_warnings()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", DeprecationWarning)
        leg = OffloadedServingEngine(cfg, **LEGACY_KW)
    ref = S.create_engine(S.EngineSpec(arch=cfg.name, cfg=cfg, offload=True,
                                       fused_int4=True, **LEGACY_KW))
    if not any(issubclass(w.category, DeprecationWarning) for w in caught):
        raise RuntimeError("run ad: the legacy keywords did not warn")
    if (leg.plan.to_json() != ref.plan.to_json() or leg.plan != ref.plan
            or leg.dev.type != "cuda"):
        raise RuntimeError(f"run ad: legacy plan {leg.plan.summary()} != "
                           f"{ref.plan.summary()}")
    r_leg = serve_once(torch, ops, leg, reqs, 0)
    r_ref = serve_once(torch, ops, ref, reqs, 0)
    whole = serving_whole_path(torch, ops, leg, reqs, "ad_legacy")
    leg.shutdown()
    ref.shutdown()
    if r_leg["outs"] != r_ref["outs"] or sorted(r_leg["outs"]) != [0, 1] \
            or any(len(o) != LEGACY_NEW for o in r_leg["outs"].values()):
        raise RuntimeError(f"run ad: legacy tokens {r_leg['outs']} != "
                           f"{r_ref['outs']}")
    st, n = r_leg["stats"], cfg.num_layers
    check_launches("ad_legacy", r_leg["counts"], {
        **zero, "flash_attention": n * st["prefills"],
        "decode_attention": n * st["decode_steps"],
        "int4_matmul": 7 * n * (st["prefills"] + st["decode_steps"])},
        exact=True)
    counts["ad_legacy"] = r_leg["counts"]
    summaries["ad_legacy"] = {
        "s": time.perf_counter() - t0, "plan": leg.plan.summary(),
        "tokens_equal": True, "requests": len(reqs), **st,
        "launches": r_leg["counts"], "whole_path": whole}
    log(json.dumps({"example": "legacy_kwargs", **summaries["ad_legacy"]}))
    summaries["ad"] = {"s": time.perf_counter() - t_phase, "card": card,
                       **{k: summaries[f"ad_{k}"]["s"] for k in (
                           "quickstart", "serve", "train", "legacy")}}
    log(json.dumps({"examples_phase": summaries["ad"]}))


def finish(torch, card, checks, counts, t_start, phase_s) -> int:
    """14. The kernels line (each kernel's launches in the run its timed
    shape comes from, and per run), the card and the result line."""
    home = {"flash_attention": "b", "decode_attention": "b",
            "int4_matmul": "b", "decode_attention_int4": "e",
            # the bf16 instances' launches: run (aa)'s bf16 arms
            "flash_attention_bf16": "aa_bf16",
            "decode_attention_bf16": "aa_bf16",
            "int4_matmul_bf16": "aa_bf16",
            "decode_attention_int4_bf16": "aa_bf16"}
    kernels = []
    for name, rows in checks.items():
        m = next(r for r in rows if r["main"])
        base = name.removesuffix("_bf16")
        entry = {
            "name": name, "route": "cuda",
            "instance": "bf16" if name != base else "f32",
            "source": f"src/repro_torch/csrc/{base}.cu",
            "replaces": REPLACES[base],
            "launches": counts[home[name]][name] if home[name] in counts
            else max(c[name] for c in counts.values()),
            "launches_run": home[name] if home[name] in counts else None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "call_ms": m["call_ms"],
            "parity": "ok", "shape": m["shape"],
            "device_timer": m.get("device_timer", TIMER["device"]),
            "launches_by_run": {k: c[name] for k, c in counts.items()}}
        if name == "flash_attention":
            entry["q_offset_launches_by_run"] = {
                k: c["flash_attention_q_offset"] for k, c in counts.items()}
        entry.update({k: m[k] for k in ("bound_rate", "bound_fp32_ms",
                                        "cold_ms", "library_cold_ms",
                                        "median_timed", "cold_median_timed",
                                        "plan", "one_tile_plan_ms")
                      if k in m})
        variants = [r for r in rows
                    if isinstance(r["main"], str) and r is not m]
        for v in variants:
            entry[v["main"]] = {k: v[k] for k in (
                "shape", "ms", "cold_ms", "plain_ms", "library_ms",
                "library_cold_ms", "call_ms", "bound_ms", "bound_by",
                "bound_rate", "bound_fp32_ms", "max_abs_err", "median_timed",
                "cold_median_timed", "plan", "one_tile_plan_ms",
                "max_ulps_vs_cast_recipe") if k in v}
        kernels.append(entry)
    torch.cuda.synchronize()
    log(json.dumps({"wall_s": {"total": time.perf_counter() - t_start,
                               "by_phase": phase_s},
                    "device_timer": TIMER}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
