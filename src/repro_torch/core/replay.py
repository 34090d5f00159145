"""Trace-replay cost model: deterministic what-if analysis on recorded
pipelines (the JAX package's ``core/replay.py``, ported: FlexInfer/
PipeMax-style plan selection by estimation, no hardware in the loop).

A recorded ``Trace`` already carries everything a cost model needs: the
per-task durations, payload bytes, and extents of every weight load, KV
transfer, and layer compute, plus the scheduling context the scheduler
stamps in ``trace.meta`` (mode, warm, depth, pool size, per-call
iteration counts, sim link, quant modes).  ``replay()`` re-runs that
recording through the REAL ``PipelineScheduler`` on a fresh
``VirtualPool`` — same Algorithm-1 code path, virtual timeline — with a
cost function derived from the recording, so "what would this run look
like at depth 3 / INT4 KV / half the link?" is answered in milliseconds:

  * unchanged knobs reproduce the recorded step times bit-for-bit
    (regression-tested against the committed golden fixtures);
  * ``sim_bw`` re-prices every transfer as
    ``overhead + bytes / bw`` (overhead = recorded time above the
    recorded link's byte cost); the virtual makespan is monotone in
    per-task durations, so a slower hypothetical link can never predict
    a faster step;
  * ``quant`` / ``kv_mode`` scale payload bytes by the §3.5 memory
    model's packing ratios (``quant_weight_ratio`` / ``quant_kv_ratio``)
    before pricing them;
  * ``depth`` / ``pool_size`` / ``mode`` / ``warm`` re-schedule the same
    recorded work under a different window.

``best_depth()`` sweeps the window and returns the simulated-argmin
depth — ``serving.spec.EngineSpec.resolve(budget, trace=...)`` uses it
(via ``core.autoconfig.replay_depth_decision``) to pick the measured
best configuration instead of the closed-form heuristic, recording
``replay`` as the depth's provenance source.

On a recording taken on the card, a task's duration is its interval on
the host clock (a transfer ends when its stream synchronized, a compute
unit when the card reached its timing event); the host time between
tasks is in no task, so a replay at the recorded knobs predicts the
step the tasks alone would take, not the measured step.

Known limits: expert loads submitted from inside MoE compute callbacks
carry engine-specific names the replayer cannot re-schedule — their time
stays inside the recorded compute durations, so dense stacks replay
exactly while MoE stacks replay with expert streaming folded into
compute.  Adaptive-depth recordings replay at the window's initial
depth (resizes are not in the schema).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.memory_model import quant_kv_ratio, quant_weight_ratio
from repro_torch.core.pipeline import (PipelineScheduler, StagedScheduler,
                                       VirtualPool)
from repro_torch.core.tasks import TaskType, Trace, VirtualClock

__all__ = ["ReplayError", "ReplayKnobs", "TraceProfile", "ReplayResult",
           "replay", "best_depth", "best_stage_depth", "step_boundaries",
           "step_times", "steady_step_s", "replay_traffic"]

_W_RE = re.compile(r"^w\[(\d+)\]$")
_PAIR_RE = re.compile(r"^(kv|sv|c)\[(\d+),(\d+)\]$")


class ReplayError(ValueError):
    """The trace cannot be replayed (no parseable scheduler events, or
    the requested iteration window is empty)."""


def _parse(name: str) -> Optional[Tuple[str, Optional[int], int]]:
    """(kind, iteration, layer) from a scheduler task name; None for
    names the scheduler didn't mint (e.g. MoE expert loads submitted
    from inside compute callbacks)."""
    m = _W_RE.match(name)
    if m:
        return "w", None, int(m.group(1))
    m = _PAIR_RE.match(name)
    if m:
        return m.group(1), int(m.group(2)), int(m.group(3))
    return None


# ---------------------------------------------------------------------------
# step timing helpers (shared by recorded and replayed traces)
# ---------------------------------------------------------------------------


def step_boundaries(trace: Trace) -> List[float]:
    """End-of-iteration timestamps: the t_end of each iteration's tail
    compute ``c[i, n-1]``, in iteration order.  A step's duration is the
    gap between consecutive boundaries."""
    tails: Dict[int, float] = {}
    n = 0
    for e in trace.events():
        p = _parse(e.name)
        if p is not None and p[0] == "c":
            n = max(n, p[2] + 1)
    if n == 0:
        return []
    for e in trace.events():
        p = _parse(e.name)
        if p is not None and p[0] == "c" and p[2] == n - 1:
            tails[p[1]] = e.t_end
    return [tails[i] for i in sorted(tails)]


def step_times(trace: Trace) -> List[float]:
    """Per-iteration step durations; the first is measured from the
    earliest event start (pipeline fill included)."""
    b = step_boundaries(trace)
    if not b:
        return []
    evs = trace.events()
    t0 = min(e.t_start for e in evs) if evs else 0.0
    return [b[0] - t0] + [b[k] - b[k - 1] for k in range(1, len(b))]


def steady_step_s(trace: Trace) -> float:
    """Steady-state seconds per iteration: boundary-to-boundary mean with
    the first (fill-dominated) step dropped; single-step traces fall back
    to that step."""
    b = step_boundaries(trace)
    if not b:
        return 0.0
    if len(b) == 1:
        return step_times(trace)[0]
    return (b[-1] - b[0]) / (len(b) - 1)


# ---------------------------------------------------------------------------
# TraceProfile — what the recording says about the workload
# ---------------------------------------------------------------------------


def _mean(vals) -> float:
    vals = list(vals)
    return sum(vals) / len(vals) if vals else 0.0


@dataclass
class TraceProfile:
    """Per-task durations/bytes recovered from a recording, iteration
    indices renumbered to 0..len(iters)-1 (``start_iter``/``stop_iter``
    slice a steady-state window out of a longer serving trace)."""

    n_units: int
    iters: List[int]                       # renumbered iteration ids
    calls: List[int]                       # generate() iteration counts
    mode: str
    warm: bool
    depth: int
    pool_size: int
    stages: int                            # pipeline-parallel stage count
    stage_units: Optional[List[tuple]]     # [(lo, hi)] when stages > 1
    stage_depths: Optional[List[int]]      # per-stage window when recorded
    sim_bw: Optional[float]
    quant: Optional[str]
    kv_mode: Optional[str]
    mha_layers: frozenset
    compute_s: Dict[Tuple[int, int], float]
    compute_mean: Dict[int, float]
    weight_s: Dict[int, float]             # mean duration per layer
    weight_b: Dict[int, float]             # mean bytes per layer
    kv_s: Dict[Tuple[int, int], float]
    kv_b: Dict[Tuple[int, int], float]
    kv_ext: Dict[Tuple[int, int], Optional[tuple]]
    kv_mean_s: Dict[int, float]
    kv_mean_b: Dict[int, float]
    sv_s: Dict[Tuple[int, int], float]
    sv_b: Dict[Tuple[int, int], float]
    sv_mean_s: Dict[int, float]
    sv_mean_b: Dict[int, float]

    @classmethod
    def from_trace(cls, trace: Trace, start_iter: Optional[int] = None,
                   stop_iter: Optional[int] = None) -> "TraceProfile":
        meta = trace.meta
        parsed = []
        n_units = int(meta.get("n_units") or 0)
        for e in trace.events():
            p = _parse(e.name)
            if p is None:
                continue
            parsed.append((p, e))
            n_units = max(n_units, p[2] + 1)
        if not any(p[0] == "c" for p, _ in parsed):
            raise ReplayError("trace has no scheduler compute events "
                              "(c[i,j]) to replay")

        def in_window(i):
            return ((start_iter is None or i >= start_iter)
                    and (stop_iter is None or i < stop_iter))

        iters = sorted({p[1] for p, _ in parsed
                        if p[0] == "c" and in_window(p[1])})
        if not iters:
            raise ReplayError(f"no compute events in iteration window "
                              f"[{start_iter}, {stop_iter})")
        base = iters[0]

        compute_s: Dict[Tuple[int, int], float] = {}
        w_s: Dict[int, list] = {}
        w_b: Dict[int, list] = {}
        kv_s: Dict[Tuple[int, int], float] = {}
        kv_b: Dict[Tuple[int, int], float] = {}
        kv_ext: Dict[Tuple[int, int], Optional[tuple]] = {}
        sv_s: Dict[Tuple[int, int], float] = {}
        sv_b: Dict[Tuple[int, int], float] = {}
        for (kind, i, j), e in parsed:
            dur = e.t_end - e.t_start
            if kind == "w":
                # weight loads carry no iteration index; layer cost is
                # steady (same bytes every pass), so pool all of them
                w_s.setdefault(j, []).append(dur)
                w_b.setdefault(j, []).append(e.nbytes)
            elif i is None or not in_window(i):
                continue
            elif kind == "c":
                compute_s[(i - base, j)] = dur
            elif kind == "kv":
                kv_s[(i - base, j)] = dur
                kv_b[(i - base, j)] = e.nbytes
                kv_ext[(i - base, j)] = e.extent
            else:  # sv
                sv_s[(i - base, j)] = dur
                sv_b[(i - base, j)] = e.nbytes

        by_layer = lambda d: {
            j: _mean(v for (ii, jj), v in d.items() if jj == j)
            for j in {jj for _, jj in d}}
        # slice the recorded call partition to the window: each call's
        # overlap with [base, base+len(iters)) becomes a replay call
        rec_calls = list(meta.get("calls") or [])
        calls, c0 = [], 0
        for c in rec_calls:
            lo, hi = max(c0, base), min(c0 + c, base + len(iters))
            if hi > lo:
                calls.append(hi - lo)
            c0 += c
        if sum(calls) != len(iters):
            calls = [len(iters)]           # untagged trace: one call

        su = meta.get("stage_units")
        return cls(
            n_units=n_units, iters=list(range(len(iters))), calls=calls,
            mode=meta.get("mode") or "performance",
            warm=bool(meta.get("warm", False)),
            depth=int(meta.get("depth") or 1),
            pool_size=int(meta.get("pool_size") or 3),
            stages=int(meta.get("stages") or 1),
            stage_units=None if su is None else [tuple(u) for u in su],
            stage_depths=(None if meta.get("stage_depths") is None
                          else [int(d) for d in meta["stage_depths"]]),
            sim_bw=meta.get("sim_bw"), quant=meta.get("quant"),
            kv_mode=meta.get("kv_mode"),
            mha_layers=frozenset({j for _, j in kv_s}
                                 | {j for _, j in sv_s}),
            compute_s=compute_s, compute_mean=by_layer(compute_s),
            weight_s={j: _mean(v) for j, v in w_s.items()},
            weight_b={j: _mean(v) for j, v in w_b.items()},
            kv_s=kv_s, kv_b=kv_b, kv_ext=kv_ext,
            kv_mean_s=by_layer(kv_s), kv_mean_b=by_layer(kv_b),
            sv_s=sv_s, sv_b=sv_b,
            sv_mean_s=by_layer(sv_s), sv_mean_b=by_layer(sv_b))


# ---------------------------------------------------------------------------
# ReplayKnobs — the hypothetical configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReplayKnobs:
    """What-if overrides; every ``None`` field keeps the recorded value.
    ``quant``/``kv_mode`` accept ``"fp32"`` to explicitly mean
    unquantized (distinct from None = as recorded)."""

    depth: Optional[int] = None
    mode: Optional[str] = None
    warm: Optional[bool] = None
    pool_size: Optional[int] = None
    sim_bw: Optional[float] = None
    quant: Optional[str] = None
    kv_mode: Optional[str] = None
    stages: Optional[int] = None           # pipeline-parallel re-staging


def _pack_ratio(ratio_fn, new: Optional[str], rec: Optional[str]) -> float:
    """Byte multiplier recorded -> hypothetical precision (p cancels in
    the ratio of §3.5 packing ratios)."""
    if new is None or new == rec:
        return 1.0
    return ratio_fn(4, new) / ratio_fn(4, rec)


def _transfer_s(t_rec: float, b_rec: float, b_new: float,
                bw_rec: Optional[float], bw_new: Optional[float]) -> float:
    """Hypothetical transfer duration.  With a link model (recorded or
    requested bandwidth) the cost is fixed overhead + bytes/bw, the
    overhead being whatever the recorded duration spent above the
    recorded link's byte cost; without one, the recorded duration scales
    by the byte ratio.  Monotone: slower bw / more bytes never shrinks
    the result."""
    if bw_new is None:
        bw_new = bw_rec
    if not bw_new or b_new <= 0 or b_rec <= 0:
        if b_rec > 0:
            return t_rec * (b_new / b_rec)
        return t_rec
    overhead = max(0.0, t_rec - b_rec / bw_rec) if bw_rec else 0.0
    return overhead + b_new / bw_new


class _ReplayModel:
    """Scheduler callbacks with no side effects: bytes come from the
    profile scaled to the hypothetical precisions; durations are priced
    by the pool's cost_fn (same lookup tables)."""

    def __init__(self, prof: TraceProfile, rw: float, rkv: float):
        self.prof = prof
        self.rw = rw
        self.rkv = rkv

    def is_mha(self, j):
        return j in self.prof.mha_layers

    def load_weights(self, j):
        return ("w", j)

    def release_weights(self, j, handle):
        pass

    def load_kv(self, i, j):
        return ("kv", i, j)

    def save_kv(self, i, j, kv):
        pass

    def compute(self, i, j, x, w, kv):
        return x, ("kv" if self.is_mha(j) else None)

    def finalize(self, i, x):
        return x

    # byte-accounting hooks (scaled to the hypothetical precision)
    def weight_nbytes(self, j):
        return int(round(self.prof.weight_b.get(j, 0.0) * self.rw))

    def kv_nbytes(self, i, j):
        p = self.prof
        return int(round(p.kv_b.get((i, j), p.kv_mean_b.get(j, 0.0))
                         * self.rkv))

    def kv_extent(self, i, j):
        return self.prof.kv_ext.get((i, j))

    def kv_save_nbytes(self, i, j):
        p = self.prof
        return int(round(p.sv_b.get((i, j), p.sv_mean_b.get(j, 0.0))
                         * self.rkv))


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


@dataclass
class ReplayResult:
    """One simulated run: the predicted trace plus the derived step/byte
    figures (``trace.meta`` carries the knobs it was simulated under, so
    a result is itself replayable)."""

    trace: Trace
    profile: TraceProfile
    step_times_s: List[float]
    steady_step_s: float
    span_s: float
    bytes_by_kind: Dict[str, int]
    report: Dict[str, Any] = field(default_factory=dict)


def replay(trace: Trace, knobs: Optional[ReplayKnobs] = None, *,
           start_iter: Optional[int] = None,
           stop_iter: Optional[int] = None) -> ReplayResult:
    """Re-run a recorded trace through the real scheduler on a virtual
    pool under hypothetical knobs; deterministic, model-free, O(events).
    ``start_iter``/``stop_iter`` slice a steady window out of a longer
    recording (e.g. the timed decode steps of a serving run) before
    replaying it."""
    k = knobs or ReplayKnobs()
    prof = TraceProfile.from_trace(trace, start_iter, stop_iter)
    mode = k.mode or prof.mode
    warm = prof.warm if k.warm is None else bool(k.warm)
    depth = prof.depth if k.depth is None else int(k.depth)
    depth = PipelineScheduler.clamp_depth(mode, prof.n_units, depth)
    if k.pool_size is not None:
        pool_size = int(k.pool_size)
    elif k.depth is None:
        pool_size = prof.pool_size
    else:
        # a hypothetical window gets the pool an engine would build for it
        pool_size = PipelineScheduler.pool_size(depth)
    sim_bw = prof.sim_bw if k.sim_bw is None else float(k.sim_bw)
    quant = prof.quant if k.quant is None else k.quant
    kv_mode = prof.kv_mode if k.kv_mode is None else k.kv_mode
    stages = prof.stages if k.stages is None else int(k.stages)
    stages = max(1, min(stages, prof.n_units))
    rw = _pack_ratio(quant_weight_ratio, k.quant, prof.quant)
    rkv = _pack_ratio(quant_kv_ratio, k.kv_mode, prof.kv_mode)

    model = _ReplayModel(prof, rw, rkv)

    def cost(task) -> float:
        p = _parse(task.name)
        if p is None:
            return 0.0
        kind, i, j = p
        if kind == "c":
            return prof.compute_s.get((i, j), prof.compute_mean.get(j, 0.0))
        if kind == "w":
            return _transfer_s(prof.weight_s.get(j, 0.0),
                               prof.weight_b.get(j, 0.0),
                               model.weight_nbytes(j), prof.sim_bw, sim_bw)
        if kind == "kv":
            t_rec = prof.kv_s.get((i, j), prof.kv_mean_s.get(j, 0.0))
            b_rec = prof.kv_b.get((i, j), prof.kv_mean_b.get(j, 0.0))
            return _transfer_s(t_rec, b_rec, model.kv_nbytes(i, j),
                               prof.sim_bw, sim_bw)
        t_rec = prof.sv_s.get((i, j), prof.sv_mean_s.get(j, 0.0))
        b_rec = prof.sv_b.get((i, j), prof.sv_mean_b.get(j, 0.0))
        return _transfer_s(t_rec, b_rec, model.kv_save_nbytes(i, j),
                           prof.sim_bw, sim_bw)

    if stages > 1:
        # stage-aware re-scheduling: rebuild the staged run — per-stage
        # virtual pools (own clock + transfer slots each, the per-stage
        # link) over ONE shared trace, exactly the topology the recorder
        # used, so unchanged knobs reproduce the recording bit-for-bit
        # and a single-stage recording can be re-staged hypothetically.
        if stages == prof.stages and prof.stage_units:
            units = [tuple(u) for u in prof.stage_units]
        else:
            bounds = [round(s * prof.n_units / stages)
                      for s in range(stages + 1)]
            units = [(bounds[s], bounds[s + 1]) for s in range(stages)]
        if (k.depth is None and stages == prof.stages
                and prof.stage_depths):
            depths = list(prof.stage_depths)
        else:
            depths = [depth] * stages
        out_trace = Trace(clock=VirtualClock())
        pools = [VirtualPool(max(1, pool_size), trace=out_trace,
                             cost_fn=cost, clock=VirtualClock())
                 for _ in range(stages)]
        sched = StagedScheduler(units, mode, pools=pools, trace=out_trace,
                                warm=warm, depths=depths)
        for iters in prof.calls:
            sched.generate(model, lambda i: 0, iters)
        sched.shutdown()
        out = out_trace
    else:
        pool = VirtualPool(max(1, pool_size), cost_fn=cost)
        sched = PipelineScheduler(prof.n_units, mode, pool=pool,
                                  trace=pool.trace, warm=warm, depth=depth)
        for iters in prof.calls:
            sched.generate(model, lambda i: 0, iters)
        sched.shutdown()
        out = pool.trace
    out.meta.update(sim_bw=sim_bw, quant=quant, kv_mode=kv_mode,
                    replayed=True)
    return ReplayResult(
        trace=out, profile=prof, step_times_s=step_times(out),
        steady_step_s=steady_step_s(out), span_s=out.span(),
        bytes_by_kind={t.value: out.bytes_moved(t.value)
                       for t in TaskType},
        report=out.report())


def replay_traffic(trace: Trace, *, sched: Optional[str] = None,
                   chunk: Optional[int] = None,
                   b_max: Optional[int] = None,
                   costs: Optional[dict] = None):
    """What-if re-run of a recorded traffic simulation: a
    ``serving.workload.TrafficSim`` trace carries its arrival schedule
    and knobs in ``meta["traffic"]``, so the same traffic replays under
    a different scheduling policy / chunk cap / slot count / cost model
    in milliseconds — "would OnlineSLO at chunk 16 have met the p99 SLO
    on yesterday's traffic?" without the engine.  Every ``None`` keeps
    the recorded value; ``costs`` keys override individual
    ``SimCosts`` fields.  Returns a ``workload.SimResult`` (itself
    replayable)."""
    from repro_torch.serving.workload import (ArrivalTrace, SimCosts,
                                              TrafficSim)
    rec = trace.meta.get("traffic")
    if not rec:
        raise ReplayError("trace has no meta['traffic'] block "
                          "(not a TrafficSim recording)")
    c = dict(rec.get("costs") or {})
    c.update(costs or {})
    sim = TrafficSim(
        ArrivalTrace.from_json(rec["arrivals"]),
        b_max=int(rec["b_max"] if b_max is None else b_max),
        sched=str(rec["sched"] if sched is None else sched),
        chunk=int(rec["chunk"] if chunk is None else chunk),
        costs=SimCosts(**c))
    return sim.run()


def best_depth(trace: Trace, *, depth_cap: int = 8,
               knobs: Optional[ReplayKnobs] = None,
               start_iter: Optional[int] = None,
               stop_iter: Optional[int] = None
               ) -> Tuple[int, Dict[int, float]]:
    """Simulated-argmin preload depth: replay the recording at every
    depth in 1..depth_cap (each with the pool an engine would build for
    that window) and return (best depth, {depth: predicted steady s per
    step}).  Ties break toward the shallower window — less residency for
    the same predicted step."""
    import dataclasses
    base = knobs or ReplayKnobs()
    preds: Dict[int, float] = {}
    for d in range(1, max(1, int(depth_cap)) + 1):
        res = replay(trace, dataclasses.replace(base, depth=d),
                     start_iter=start_iter, stop_iter=stop_iter)
        preds[d] = res.steady_step_s
    best = min(preds, key=lambda d: (preds[d], d))
    return best, preds


def best_stage_depth(trace: Trace, *, stage_cap: int = 4,
                     depth_cap: int = 8,
                     knobs: Optional[ReplayKnobs] = None,
                     start_iter: Optional[int] = None,
                     stop_iter: Optional[int] = None
                     ) -> Tuple[Tuple[int, int], Dict[Tuple[int, int],
                                                      float]]:
    """Joint simulated argmin over ``(stages, depth)``: replay the
    recording at every staging x window combination (each stage with the
    pool an engine would build for that window) and return
    ``((stages, depth), {(stages, depth): predicted steady s/step})``.
    Ties break toward fewer stages, then the shallower window — less
    hardware and less residency for the same predicted step.  Stage
    counts beyond the unit count are skipped (a stage must own at least
    one unit)."""
    import dataclasses
    base = knobs or ReplayKnobs()
    prof = TraceProfile.from_trace(trace, start_iter, stop_iter)
    preds: Dict[Tuple[int, int], float] = {}
    for s in range(1, max(1, int(stage_cap)) + 1):
        if s > prof.n_units:
            break
        for d in range(1, max(1, int(depth_cap)) + 1):
            res = replay(trace, dataclasses.replace(base, stages=s,
                                                    depth=d),
                         start_iter=start_iter, stop_iter=stop_iter)
            preds[(s, d)] = res.steady_step_s
    best = min(preds, key=lambda sd: (preds[sd], sd))
    return best, preds
