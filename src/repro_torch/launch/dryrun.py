"""Multi-pod dry run of the port: trace every (architecture x input
shape) cell on the production meshes and record per-device memory,
operations, HBM and link bytes and the roofline bound on the H100
(``roofline.analysis.HW``).

The meshes are ``launch.mesh.AbstractMesh``es (``PRODUCTION``: (16, 16)
and, with ``--multi-pod``, (2, 16, 16)): no process group and no card.
Each argument is one device's block, laid out by the spec trees
(``launch.sharding``), as an ``AbstractDTensor`` over a meta tensor, and
the step (``make_train_step`` with AdamW, or Adafactor above 60e9
parameters; ``make_prefill_step``; ``make_decode_step``) runs once on
them under the counters of ``roofline.analysis.analyze_step``: one
rank's program, whose collectives record their bytes.  Nothing needs
512 devices to exist.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k [--multi-pod] [--variant w4] [--out experiments/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Serving-plan dry run (``--serving``): resolve an ``EngineSpec`` per arch
against the consumer-device budget and print the plan (engine,
placement, depth, each with its provenance) without building anything;
with one ``--arch`` and ``--scaled`` it also builds the engine through
``create_engine(plan)`` on ``--device`` (the card unless the caller asks
for the CPU) and serves one request:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --serving --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --serving \\
      --arch tinyllama-1.1b --scaled --device cpu

Trace-replay what-if sweep (``--replay``): predicted step time and link
bytes per (depth, quant, kv-mode) point from a recorded trace
(``core.replay``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --replay tests/fixtures/trace_warm_d1.json

The rows and lines are the JAX package's (``src/repro/launch/dryrun.py``),
with the H100's link keys (``nvlink_bytes``/``ib_bytes``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (ASSIGNED, get_config, get_shape,
                                 shape_applicable)
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import PRODUCTION, AbstractMesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.models.common import AbstractDTensor, Dist
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.adafactor import Adafactor
from repro_torch.roofline.analysis import (HW, analyze_step, model_flops,
                                           roofline_report)
from repro_torch.tree import tree_map

ADAFACTOR_ABOVE = 60e9    # parameters: fp32 Adam moments do not fit a pod


def _enc_pad(cfg, mesh) -> int:
    """Encoder frames padded to a multiple of the model axis (whisper)."""
    if not cfg.enc_dec:
        return 0
    m = mesh.shape["model"]
    return ((cfg.encoder_seq_len + m - 1) // m) * m


def block(t: torch.Tensor, spec, dist: Dist) -> AbstractDTensor:
    """The block of the meta tensor ``t`` (the whole value's shape and
    dtype) that one device holds under ``spec``."""
    spec = tuple(spec) + (None,) * (t.ndim - len(tuple(spec)))
    local = [n // dist.size(s) if s else n for n, s in zip(t.shape, spec)]
    return AbstractDTensor(torch.empty(local, dtype=t.dtype, device="meta"),
                           dist.mesh, dist.placements(spec, t.ndim), t.shape)


def _blocks(tree, specs, dist):
    return tree_map(lambda t, sp: block(t, sp, dist), tree, specs)


def cell_args(arch: str, shape_name: str, multi_pod: bool,
              variant: str = "base"):
    """(cfg, shape, step, args) of one cell: the step function and its
    arguments as one device's blocks (``AbstractDTensor``s): parameters,
    optimizer state and batch (train); parameters and batch (prefill);
    parameters, batch and caches (decode, a 0-d position)."""
    cfg = get_config(arch)
    if variant == "w4":
        # PIPO's INT4 weights at pod scale: packed bytes cross HBM
        cfg = dataclasses.replace(cfg, quant_weights=True)
    shape = get_shape(shape_name)
    mesh = AbstractMesh(*PRODUCTION[multi_pod])
    dist = S.make_dist(mesh, shape)
    model = build_model(cfg)
    enc_pad = _enc_pad(cfg, mesh)
    params = _blocks(T.param_struct(cfg), S.param_pspecs(cfg, dist), dist)
    batch = _blocks(model.input_struct(shape, enc_pad),
                    S.batch_pspecs(cfg, shape, dist, enc_pad), dist)
    if shape.kind == "train":
        if cfg.param_count() > ADAFACTOR_ABOVE:
            opt = Adafactor()
            ostate = _blocks(S.adafactor_struct(cfg, opt),
                             S.adafactor_pspecs(cfg, dist, opt), dist)
        else:
            opt = AdamW()
            ostate = _blocks(S.opt_struct(cfg), S.zero_pspecs(cfg, dist),
                             dist)
        return cfg, shape, make_train_step(model, dist, opt), (
            params, ostate, batch)
    if shape.kind == "prefill":
        return cfg, shape, make_prefill_step(model, dist, shape.seq_len), (
            params, batch)
    struct, _ = model.cache_struct(shape.global_batch, shape.seq_len,
                                   enc_pad or None)
    struct = {grp: tuple({n: torch.empty(s, dtype=dt, device="meta")
                          for n, (s, dt) in t.items()} for t in struct[grp])
              for grp in ("pat", "rem")}
    caches = _blocks(struct, S.cache_pspecs(cfg, dist, shape.global_batch,
                                            shape.seq_len, enc_pad or None),
                     dist)
    step = make_decode_step(model, dist)
    # the traced step reads the position as a number: the last slot, so
    # every cached row is live (the reference's traced ``pos``)
    last = shape.seq_len - 1
    return cfg, shape, lambda p, b, c: step(p, {**b, "pos": last}, c), (
        params, batch, caches)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             variant: str = "base", hw: HW = HW()) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "variant": variant}
    fname = f"{arch}_{shape_name}_{mesh_tag}_{variant}.json"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        row.update(status="skip", reason=why)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / fname).write_text(json.dumps(row, indent=1))
        return row
    t0 = time.time()
    try:
        cfg, shape, step, args = cell_args(arch, shape_name, multi_pod,
                                           variant)
        acc = analyze_step(step, *args, hw=hw)
    except Exception as e:
        row.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        return row
    n_dev = 512 if multi_pod else 256
    acc.pop("out")
    kernels = acc.pop("kernels")
    rep = roofline_report(acc, hw)
    mf = model_flops(cfg, shape)
    flops_total = acc["flops"] * n_dev
    row.update(
        status="ok",
        trace_s=round(time.time() - t0, 1),
        devices=n_dev,
        bytes_per_device=(acc["temp_bytes"] + acc["arg_bytes"]
                          + acc["out_bytes"] - acc["alias_bytes"]),
        **{k: acc[k] for k in ("temp_bytes", "arg_bytes", "out_bytes",
                               "alias_bytes")},
        model_flops_total=mf,
        flops_per_dev=acc["flops"],
        flops_useful_ratio=(mf / flops_total) if flops_total else 0.0,
        **{k: rep[k] for k in ("t_compute_s", "t_memory_s",
                               "t_collective_s", "bottleneck", "t_bound_s",
                               "hbm_bytes", "nvlink_bytes", "ib_bytes",
                               "coll_count")},
        coll_breakdown={k: v for k, v in acc.items()
                        if k.startswith("coll_") and k != "coll_count"},
        kernels=kernels,
    )
    # how close the dominant term is to the sum of the three (perfect
    # overlap would reach the bound)
    tot = rep["t_compute_s"] + rep["t_memory_s"] + rep["t_collective_s"]
    row["roofline_fraction"] = rep["t_bound_s"] / tot if tot else 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / fname).write_text(json.dumps(row, indent=1, default=str))
    return row


def replay_dryrun(path: str):
    """Offline what-if table over a recorded trace (``--replay``): the
    ``Trace.to_json`` dump swept through ``core.replay`` over preload
    depth x weight/KV precision, printing the predicted steady step
    time and per-step link volume of every point."""
    from repro_torch.core.replay import ReplayKnobs, replay
    from repro_torch.core.tasks import Trace

    tr = Trace.from_json(Path(path).read_text())
    m = tr.meta
    bw = m.get("sim_bw")
    print(f"[TRACE] {path}: arch={m.get('arch', '?')} "
          f"mode={m.get('mode', '?')} warm={m.get('warm', '?')} "
          f"depth={m.get('depth', '?')} quant={m.get('quant') or 'fp32'} "
          f"kv={m.get('kv_mode') or 'fp32'} "
          f"sim_bw={f'{bw / 1e9:.2f}GB/s' if bw else 'n/a'} "
          f"events={len(tr.events())}")
    base = replay(tr).steady_step_s          # knobs exactly as recorded
    print(f"{'depth':>5s} {'weights':>8s} {'kv':>5s} {'step_ms':>8s} "
          f"{'link_MB/step':>12s} {'vs_recorded':>11s}")
    for depth in (1, 2, 3, 4):
        for wq, kv in ((None, None), ("int4", None), ("int4", "int4")):
            res = replay(tr, ReplayKnobs(depth=depth, quant=wq, kv_mode=kv))
            b = res.bytes_by_kind
            link_mb = (b["weight_load"] + b["kv_load"] + b["kv_save"]) \
                / max(1, len(res.step_times_s)) / 2**20
            print(f"{depth:5d} {wq or 'rec':>8s} {kv or 'rec':>5s} "
                  f"{res.steady_step_s * 1e3:8.2f} {link_mb:12.2f} "
                  f"{base / max(1e-12, res.steady_step_s):10.2f}x")


def serving_dryrun(arch, scaled: bool, run_all: bool, stages=None,
                   device="cuda"):
    """One plan row per arch (engine, placement, depth and provenance;
    with ``stages`` a [STG] row per pipeline stage); with one arch and
    ``scaled`` the engine built through ``create_engine(plan)`` on
    ``device`` serves one request."""
    import numpy as np

    from repro_torch.configs import list_archs
    from repro_torch.serving.spec import EngineSpec, create_engine

    archs = sorted(list_archs()) if run_all or arch is None else [arch]
    plans = []
    for a in archs:
        plan = EngineSpec(arch=a, scaled=scaled, b_max=4, max_len=256,
                          stages=stages).resolve()
        plans.append(plan)
        stg = f" stages={plan.stages}" if plan.stages > 1 else ""
        print(f"[PLAN] {a:26s} engine={plan.engine:9s} "
              f"placement={plan.placement:6s} depth={plan.depth} "
              f"quant={plan.quant or 'fp32'} "
              f"kv={plan.kv_mode or 'n/a'}{stg}")
        for sp in plan.stage_plan:
            print(f"  [STG] stage {sp.stage}: layers "
                  f"[{sp.layer_lo}, {sp.layer_hi}) depth={sp.depth} "
                  f"device_budget={sp.device_budget / 2**30:.2f}GiB")
        for fld, why in sorted(plan.provenance.items()):
            print(f"        {fld:12s} {why}")
    if len(plans) == 1 and scaled:
        plan = plans[0]
        eng = create_engine(plan, device=device)
        from repro_torch.serving.base import Request
        prompt = np.random.default_rng(0).integers(
            0, eng.cfg.vocab_size, (8,)).astype(np.int32)
        eng.submit(Request(rid=0, prompt=prompt, max_new=4))
        done = eng.run()
        eng.shutdown()
        print(f"[SMOKE] {plan.arch}: engine={type(eng).__name__} "
              f"served 1 request, {len(done[0].out)} tokens")


def print_row(row: dict):
    arch, shape = row["arch"], row["shape"]
    if row["status"] == "ok":
        print(f"[OK ] {arch:26s} {shape:12s} {row['mesh']:10s} "
              f"trace={row['trace_s']:6.1f}s "
              f"mem/dev={row['bytes_per_device']/2**30:6.2f}GiB "
              f"bound={row['bottleneck']:10s} t={row['t_bound_s']:.4f}s "
              f"frac={row['roofline_fraction']:.2f}")
    elif row["status"] == "skip":
        print(f"[SKIP] {arch:26s} {shape:12s} {row['reason']}")
    else:
        print(f"[ERR ] {arch:26s} {shape:12s} {row['error']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="base", choices=("base", "w4"))
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--serving", action="store_true",
                    help="resolve EngineSpec serving plans (per arch) "
                         "instead of tracing mesh cells; with a single "
                         "--arch and --scaled also builds the engine via "
                         "create_engine(plan) and serves one request")
    ap.add_argument("--scaled", action="store_true",
                    help="(--serving) resolve/build the scaled smoke "
                         "config instead of the full-size one")
    ap.add_argument("--stages", type=int, default=None, metavar="N",
                    help="(--serving) resolve with N pipeline-parallel "
                         "stages: one [STG] line per stage")
    ap.add_argument("--device", default="cuda",
                    help="(--serving --scaled) where the engine runs: "
                         "cuda (default) or cpu")
    ap.add_argument("--replay", metavar="TRACE_JSON", default=None,
                    help="offline knob sweep over a recorded trace "
                         "(Trace.to_json dump): predicted steady step "
                         "time + link bytes per (depth, quant, kv-mode) "
                         "point via core.replay")
    args = ap.parse_args(argv)

    if args.replay:
        replay_dryrun(args.replay)
        return
    if args.serving:
        serving_dryrun(args.arch, args.scaled, args.all, stages=args.stages,
                       device=args.device)
        return

    if args.all:
        cells = [(a, s) for a in sorted(ASSIGNED) for s in (
            "train_4k", "prefill_32k", "decode_32k", "long_500k")]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]
    n_err = 0
    for arch, shape in cells:
        row = run_cell(arch, shape, args.multi_pod, Path(args.out),
                       args.variant)
        print_row(row)
        n_err += row["status"] == "error"
    if n_err:
        raise SystemExit(f"{n_err} cells failed")


if __name__ == "__main__":
    main()
