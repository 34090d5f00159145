"""Traffic workloads for the serving engines: arrival traces, a real-
engine driver, and a deterministic traffic simulator (the JAX package's
``serving/workload.py``, ported).

Three pieces, smallest first:

  * ``ArrivalTrace`` — a seeded, fully deterministic request schedule
    (``poisson_trace`` / ``ramp_trace`` generators, JSON round-trip for
    replayed traces).  Arrival times are in *trace seconds*; drivers
    scale them onto their own clock.
  * ``run_trace(eng, trace)`` — drives a REAL engine (resident or
    offloaded) step by step, submitting each request once its arrival
    time passes so queue wait is charged to the request
    (``Request.t_arrive`` is the scheduled arrival, not the submit
    call).  Per-request TTFT/TBT/e2e series land in
    ``eng.trace.meta["latency"]`` where ``Trace.report()`` summarizes
    them as p50/p95/p99.
  * ``TrafficSim`` — a discrete-event simulator of the slot-engine
    serving loop on a virtual clock, with a three-number cost model
    (full weight sweep, per-decode-token compute, per-prefill-token
    compute).  It reproduces the scheduling semantics that matter for
    latency — monolithic prefill pays a dedicated weight sweep per
    admission, a chunked prefill rides the decode batch's sweeps — so
    policy comparisons (OnlineSLO vs OfflineThroughput vs monolithic)
    are exact and hardware-free.  Its trace meta carries the arrival
    schedule and knobs, so ``core.replay.replay_traffic`` can re-run
    the same traffic under what-if chunk/policy settings.
"""
from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.tasks import Trace, TraceEvent, VirtualClock
from repro_torch.serving.base import Request

__all__ = ["Arrival", "ArrivalTrace", "poisson_trace", "ramp_trace",
           "latency_series", "run_trace", "SimCosts", "SimResult",
           "TrafficSim"]


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Arrival:
    t: float                   # arrival time (trace seconds, from 0)
    rid: int
    prompt: tuple              # token ids (immutable -> hashable/JSON)
    max_new: int = 8


@dataclass
class ArrivalTrace:
    """A deterministic request schedule.  ``meta`` records how it was
    generated (kind, seed, rates) so a benchmark row can name its
    workload; replayed-JSON traces round-trip through
    ``to_json``/``from_json`` byte-for-byte."""

    arrivals: List[Arrival] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    def requests(self) -> List[Request]:
        """Fresh ``Request`` objects in arrival order (prompt arrays are
        newly allocated — safe to reuse the trace across engines)."""
        return [Request(rid=a.rid, prompt=np.asarray(a.prompt, np.int32),
                        max_new=a.max_new)
                for a in sorted(self.arrivals, key=lambda a: a.t)]

    def to_json(self) -> Dict[str, Any]:
        return {"meta": dict(self.meta),
                "arrivals": [{"t": a.t, "rid": a.rid,
                              "prompt": list(map(int, a.prompt)),
                              "max_new": a.max_new}
                             for a in self.arrivals]}

    @classmethod
    def from_json(cls, d: "Dict[str, Any] | str") -> "ArrivalTrace":
        if isinstance(d, str):
            d = json.loads(d)
        return cls(arrivals=[Arrival(t=float(a["t"]), rid=int(a["rid"]),
                                     prompt=tuple(int(x)
                                                  for x in a["prompt"]),
                                     max_new=int(a.get("max_new", 8)))
                             for a in d.get("arrivals", [])],
                   meta=dict(d.get("meta", {})))


def _gen(rates: Sequence[float], *, seed: int, vocab: int,
         prompt_len, max_new: int, kind: str, extra: dict) -> ArrivalTrace:
    """Shared generator: one exponential inter-arrival per request at
    that request's rate (req/s), seeded prompts."""
    rng = np.random.default_rng(seed)
    lo, hi = ((prompt_len, prompt_len) if isinstance(prompt_len, int)
              else prompt_len)
    t, arrivals = 0.0, []
    for rid, rate in enumerate(rates):
        t += float(rng.exponential(1.0 / max(1e-9, rate)))
        s = int(rng.integers(lo, hi + 1))
        prompt = tuple(int(x) for x in rng.integers(0, vocab, (s,)))
        arrivals.append(Arrival(t=t, rid=rid, prompt=prompt,
                                max_new=max_new))
    return ArrivalTrace(arrivals=arrivals,
                        meta=dict(kind=kind, seed=seed, n=len(arrivals),
                                  vocab=vocab, prompt_len=[lo, hi],
                                  max_new=max_new, **extra))


def poisson_trace(n: int, rate: float, *, seed: int = 0, vocab: int = 256,
                  prompt_len=(6, 12), max_new: int = 8) -> ArrivalTrace:
    """``n`` arrivals with exponential inter-arrivals at a constant
    ``rate`` (requests per trace second)."""
    return _gen([rate] * n, seed=seed, vocab=vocab, prompt_len=prompt_len,
                max_new=max_new, kind="poisson", extra=dict(rate=rate))


def ramp_trace(n: int, rate0: float, rate1: float, *, seed: int = 0,
               vocab: int = 256, prompt_len=(6, 12),
               max_new: int = 8) -> ArrivalTrace:
    """``n`` arrivals whose rate ramps linearly from ``rate0`` to
    ``rate1`` across the trace — the load-buildup regime where queue
    wait dominates TTFT tails."""
    rates = [rate0 + (rate1 - rate0) * (i / max(1, n - 1))
             for i in range(n)]
    return _gen(rates, seed=seed, vocab=vocab, prompt_len=prompt_len,
                max_new=max_new, kind="ramp",
                extra=dict(rate0=rate0, rate1=rate1))


# ---------------------------------------------------------------------------
# Real-engine driver
# ---------------------------------------------------------------------------


def latency_series(done: Sequence[Request]) -> Dict[str, List[float]]:
    """Per-request latency series (seconds): TTFT (arrival -> first
    token), TBT (gaps between consecutive emitted tokens), e2e
    (arrival -> completion)."""
    return {
        "ttft": [r.t_first_token - r.t_arrive for r in done],
        "tbt": [b - a for r in done
                for a, b in zip(r.t_tokens, r.t_tokens[1:])],
        "e2e": [r.t_done - r.t_arrive for r in done],
    }


def run_trace(eng, atrace: ArrivalTrace, *, time_scale: float = 1.0,
              max_steps: int = 100_000) -> List[Request]:
    """Drive a real engine through an arrival trace (main thread,
    blocking).  Each request is submitted once its scaled arrival time
    passes on the wall clock, with ``t_arrive`` stamped to the SCHEDULED
    arrival so queue wait counts; the engine then steps until every
    request drains.  Idle gaps (engine empty, next arrival in the
    future) sleep the wall clock forward.  Latency series are stamped
    into ``eng.trace.meta["latency"]`` when the engine records a trace,
    and the completed requests are returned either way."""
    arrivals = sorted(atrace.arrivals, key=lambda a: a.t)
    reqs = {a.rid: a for a in arrivals}
    if len(reqs) != len(arrivals):
        raise ValueError("arrival rids must be unique")
    eng._epoch += 1                    # fresh spill namespaces, like run()
    done: List[Request] = []
    t0 = time.perf_counter()
    i = 0
    for _ in range(max_steps):
        now = time.perf_counter() - t0
        while i < len(arrivals) and arrivals[i].t * time_scale <= now:
            a = arrivals[i]
            i += 1
            req = Request(rid=a.rid,
                          prompt=np.asarray(a.prompt, np.int32),
                          max_new=a.max_new)
            req.t_arrive = t0 + a.t * time_scale
            eng.submit(req)
        if eng.idle():
            if i >= len(arrivals):
                break
            dt = t0 + arrivals[i].t * time_scale - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            continue
        eng.step(done)
    trace = getattr(eng, "trace", None)
    if trace is not None:
        trace.meta["latency"] = latency_series(done)
    return done


# ---------------------------------------------------------------------------
# TrafficSim — deterministic policy comparison on a virtual clock
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimCosts:
    """Three-number cost model for one engine step.  A step (one
    ``generate`` sweep) streams every layer's weights once —
    ``sweep_s`` — overlapped with its compute: ``tok_s`` per active
    decode row plus ``prefill_tok_s`` per prompt token carried (chunk
    or monolithic).  Step time is the max of the two (the pipeline
    overlaps transfers with compute); the offloading regime has
    ``sweep_s`` dominating, which is exactly why a chunk riding an
    existing decode sweep is nearly free while a monolithic prefill
    pays a whole dedicated sweep."""

    sweep_s: float = 1.0
    tok_s: float = 0.02
    prefill_tok_s: float = 0.01


@dataclass
class SimResult:
    trace: Trace
    done: List[Dict[str, Any]]         # per-request records (rid, ttft, ...)
    tokens_out: int
    sweeps: int
    span_s: float

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / self.span_s if self.span_s > 0 else 0.0

    def report(self) -> Dict[str, Any]:
        return self.trace.report()


class TrafficSim:
    """Discrete-event simulation of ``SlotEngineBase``'s serving loop
    under a scheduling policy: ``sched`` in {"monolithic", "online",
    "offline"} with ``chunk`` the per-step prefill-token cap (online;
    offline and monolithic derive theirs).  Semantics mirror the real
    engines: FIFO admission into ``b_max`` slots; monolithic prefill is
    a dedicated sweep at admission; chunked prefill claims the slot and
    feeds ``<= cap`` prompt tokens per step into the shared sweep, at
    most one in flight; every active slot emits one token per step; the
    first token of a chunked request lands when its last chunk
    completes.  All time is virtual — identical inputs give identical
    latency numbers on any machine."""

    def __init__(self, atrace: ArrivalTrace, *, b_max: int = 2,
                 sched: str = "monolithic", chunk: int = 0,
                 costs: SimCosts = SimCosts()):
        if sched not in ("monolithic", "online", "offline"):
            raise ValueError(f"unknown sched policy {sched!r}")
        self.atrace = atrace
        self.b_max = int(b_max)
        self.sched = sched
        self.chunk = int(chunk)
        self.costs = costs

    def _cap(self, plen: int) -> int:
        if self.sched == "online":
            return max(1, self.chunk or 32)
        return plen                    # offline: the whole prompt rides once

    def run(self) -> SimResult:
        c = self.costs
        arrivals = sorted(self.atrace.arrivals, key=lambda a: a.t)
        clock = VirtualClock()
        tr = Trace(clock=clock)
        queue: List[Arrival] = []
        slots: List[Optional[dict]] = [None] * self.b_max
        ck: Optional[dict] = None      # in-flight chunked prefill
        recs: List[Dict[str, Any]] = []
        t, i, sweeps, toks_out, step_id = 0.0, 0, 0, 0, 0

        def drain_arrivals():
            nonlocal i
            while i < len(arrivals) and arrivals[i].t <= t:
                queue.append(arrivals[i])
                i += 1

        def emit(ev_kind, name, dt):
            nonlocal t, sweeps
            tr._events.append(TraceEvent(ev_kind, name, t, t + dt, "main"))
            t += dt
            sweeps += 1
            clock.advance_to(t)

        def first_token(rec, a):
            nonlocal toks_out
            rec.update(ttft=t - a.t, t_first=t, t_tokens=[t], emitted=1)
            toks_out += 1

        def finish(s):
            nonlocal toks_out
            rec = slots[s]
            rec["e2e"] = t - rec["a"].t
            recs.append(rec)
            slots[s] = None

        while i < len(arrivals) or queue or any(slots):
            drain_arrivals()
            # admission (FIFO; chunked policies claim at most one slot
            # for prefill at a time, like the engines' CHUNK_BUSY gate)
            while queue and None in slots:
                s = slots.index(None)
                a = queue[0]
                rec = dict(rid=a.rid, a=a, emitted=0, active=False,
                           t_tokens=[])
                if self.sched == "monolithic":
                    queue.pop(0)
                    slots[s] = rec
                    emit("prefill_sweep", f"prefill[{a.rid}]",
                         max(c.sweep_s, len(a.prompt) * c.prefill_tok_s))
                    first_token(rec, a)
                    rec["active"] = True
                    if rec["emitted"] >= a.max_new:
                        finish(s)
                    drain_arrivals()
                else:
                    if ck is not None:
                        break          # one chunked prefill in flight
                    queue.pop(0)
                    slots[s] = rec
                    ck = dict(slot=s, a=a, done=0, need=len(a.prompt))
            active = [s for s in range(self.b_max)
                      if slots[s] is not None and slots[s]["active"]]
            n_ck = 0
            if ck is not None:
                n_ck = min(self._cap(ck["need"]), ck["need"] - ck["done"])
            if not active and n_ck == 0:
                if i < len(arrivals):
                    t = max(t, arrivals[i].t)   # idle: jump to next arrival
                    clock.advance_to(t)
                    continue
                break
            # one shared sweep carries the decode batch + the chunk
            emit("decode_step", f"step[{step_id}]",
                 max(c.sweep_s,
                     len(active) * c.tok_s + n_ck * c.prefill_tok_s))
            step_id += 1
            for s in active:
                rec = slots[s]
                rec["emitted"] += 1
                rec["t_tokens"].append(t)
                toks_out += 1
                if rec["emitted"] >= rec["a"].max_new:
                    finish(s)
            if ck is not None:
                ck["done"] += n_ck
                if ck["done"] >= ck["need"]:
                    s, a = ck["slot"], ck["a"]
                    ck = None
                    first_token(slots[s], a)
                    slots[s]["active"] = True
                    if slots[s]["emitted"] >= a.max_new:
                        finish(s)

        lat = {
            "ttft": [r["ttft"] for r in recs],
            "tbt": [b - a for r in recs
                    for a, b in zip(r["t_tokens"], r["t_tokens"][1:])],
            "e2e": [r["e2e"] for r in recs],
        }
        tr.meta.update(
            latency=lat, tokens_out=toks_out, sweeps=sweeps,
            traffic=dict(sched=self.sched, chunk=self.chunk,
                         b_max=self.b_max, costs=asdict(self.costs),
                         arrivals=self.atrace.to_json()))
        for r in recs:
            r.pop("a", None)
            r.pop("active", None)
        return SimResult(trace=tr, done=recs, tokens_out=toks_out,
                         sweeps=sweeps, span_s=tr.span())
