"""PIPO task model (paper §3.1.2).

Inference work is decomposed into four task types:
  * COMPUTE        — MHA/MLP/embedding layer compute (main thread only)
  * WEIGHT_LOAD    — weights: disk/host tier -> device tier
  * KV_LOAD        — KV-cache: host tier -> device tier
  * KV_SAVE        — new KV-pairs: device tier -> host tier

Each task carries a threading.Event for *task-level* synchronization —
the paper's central deviation from FlexGen's device-level sync ('S' boxes
in Fig. 2): a consumer waits on exactly the producer it needs, nothing
else.

Clock seam: all timestamps flow through a ``Clock`` so the scheduler can
run against a ``VirtualClock`` (deterministic discrete-event timeline, no
sleeps) in tests and the wall clock in production.  See
``core.pipeline.VirtualPool`` for the fake transport built on top.

On a CUDA device a task's body only enqueues work on a stream.  A
transfer worker passes ``Task.run`` a ``sync`` callable (its stream's
synchronize) that runs before ``t_end`` is stamped and before ``done``
is set, so a transfer's interval ends when the card finished the copy
and a waiter never sees a half-copied tensor.  A compute task's end is
set later, from a CUDA event (``core.pipeline.ThreadPool``).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, Optional


class TaskType(Enum):
    COMPUTE = "compute"
    WEIGHT_LOAD = "weight_load"
    KV_LOAD = "kv_load"
    KV_SAVE = "kv_save"


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


class Clock:
    """Timestamp source for tasks/traces."""

    def now(self) -> float:
        raise NotImplementedError


class WallClock(Clock):
    def now(self) -> float:
        return time.perf_counter()


class VirtualClock(Clock):
    """Deterministic logical time: advanced explicitly by the virtual
    transport (``VirtualPool``), never by sleeping.  Starts at 0 so traces
    are reproducible run to run."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance_to(self, t: float):
        if t > self.t:
            self.t = t


WALL_CLOCK = WallClock()


@dataclass
class Task:
    kind: TaskType
    name: str                      # e.g. "w[3]", "kv_load[i=2,j=5]"
    fn: Callable[[], Any]
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    # timing for the utilization/trace benchmarks
    t_submit: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    # payload size (bytes moved); 0 when unknown.  Set by the submitter
    # BEFORE the task is handed to a pool (a VirtualPool traces the task
    # synchronously inside submit), and copied onto the TraceEvent so
    # per-task-type transfer volumes are assertable on traces (e.g. the
    # MoE routed-union invariant: union bytes < whole-bank bytes).  The
    # scheduler fills it for WEIGHT_LOADs (model.weight_nbytes) and
    # KV_LOADs (model.kv_nbytes) when the model exposes those hooks, so
    # report() splits link volume by task kind.
    nbytes: int = 0
    # live extent of a KV payload, (live_batch, live_len); None when the
    # payload is not extent-sliced (weight loads, whole-slab KV).  Set by
    # the submitter alongside nbytes and copied onto the TraceEvent so
    # live-row slicing is observable on traces (the tiered-KV-store
    # invariant: a half-full slot's KV_LOAD bytes < the allocated slab).
    extent: Optional[tuple] = None
    # pipeline-parallel stage this task belongs to (0 for the single-stage
    # pipeline).  Stamped by the submitting scheduler and copied onto the
    # TraceEvent so per-stage residency/bubble accounting is assertable on
    # traces (``report()['stage_bubbles']``).
    stage: int = 0
    # device ordering: a CUDA event recorded behind the compute whose
    # output this transfer reads (a KV save); the worker's stream waits
    # for it before the task body runs.  On a compute task, the event
    # recorded behind its own work.  None on the CPU.
    after: Any = None
    # virtual-transport hook: called by wait() once the task is done, so a
    # VirtualPool can advance its clock to the waiter's sync point.
    on_wait: Optional[Callable[["Task"], None]] = None

    def run(self, clock: Clock = WALL_CLOCK,
            sync: Optional[Callable[[], None]] = None):
        """Execute ``fn``; ``sync`` (if given) blocks until the device
        work ``fn`` enqueued has finished, inside the timed interval."""
        self.t_start = clock.now()
        try:
            self.result = self.fn()
            if sync is not None:
                sync()
        except BaseException as e:  # propagate to waiter
            self.error = e
        finally:
            self.t_end = clock.now()
            self.done.set()

    def wait(self):
        self.done.wait()
        if self.on_wait is not None:
            self.on_wait(self)
        if self.error is not None:
            raise self.error
        return self.result


@dataclass
class TraceEvent:
    kind: str
    name: str
    t_start: float
    t_end: float
    thread: str
    nbytes: int = 0
    extent: Optional[tuple] = None     # live (batch, len) of a KV payload
    stage: int = 0                     # pipeline-parallel stage (0 = single)


def percentile(xs, q: float) -> float:
    """Linear-interpolation percentile (numpy's default method), stdlib
    only so trace tooling stays importable without the array stack.
    ``q`` in [0, 100]; empty input returns 0.0."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return float(xs[0])
    rank = (len(xs) - 1) * q / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def latency_summary(samples) -> Dict[str, float]:
    """p50/p95/p99 + mean/count for one latency series (seconds)."""
    xs = [float(x) for x in samples]
    return {
        "count": len(xs),
        "mean_s": sum(xs) / len(xs) if xs else 0.0,
        "p50_s": percentile(xs, 50),
        "p95_s": percentile(xs, 95),
        "p99_s": percentile(xs, 99),
    }


def _merged_busy(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    ivals = sorted(intervals)
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in ivals:
        if cur_s is None:
            cur_s, cur_e = s, t
        elif s <= cur_e:
            cur_e = max(cur_e, t)
        else:
            busy += cur_e - cur_s
            cur_s, cur_e = s, t
    if cur_s is not None:
        busy += cur_e - cur_s
    return busy


class Trace:
    """Execution trace for the GPU-utilization analogue (Fig. 8) and the
    pipeline-overlap benchmarks.  Timestamps are relative to the clock's
    value at construction (0 for a fresh VirtualClock)."""

    def __init__(self, clock: Clock = WALL_CLOCK):
        self._events: list[TraceEvent] = []
        self._lock = threading.Lock()
        self.clock = clock
        self.t0 = clock.now()
        # replayable context: schedulers/pools/engines stamp the knobs the
        # trace was recorded under (mode, warm, depth, pool_size, per-call
        # iteration counts, sim_bw, quant, kv_mode ...) so ``core.replay``
        # can rebuild the run without the model.  Serialized by to_json.
        self.meta: Dict[str, Any] = {}

    def add(self, task: Task, thread: str):
        with self._lock:
            self._events.append(TraceEvent(task.kind.value, task.name,
                                           task.t_start - self.t0,
                                           task.t_end - self.t0, thread,
                                           task.nbytes, task.extent,
                                           task.stage))

    def events(self):
        with self._lock:
            return list(self._events)

    # -- (de)serialization --------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        """JSON-serializable snapshot: ``meta`` + every event, timestamps
        already relative to the trace origin.  Committable as a golden
        fixture; ``from_json`` rebuilds an equivalent trace for
        ``core.replay`` (extent tuples survive the list round-trip)."""
        events = []
        for e in self.events():
            ev = {"kind": e.kind, "name": e.name, "t_start": e.t_start,
                  "t_end": e.t_end, "thread": e.thread, "nbytes": e.nbytes,
                  "extent": None if e.extent is None else list(e.extent)}
            # the stage tag is emitted only when set, so single-stage
            # fixtures recorded before pipeline parallelism stay byte-stable
            if e.stage:
                ev["stage"] = e.stage
            events.append(ev)
        return {"meta": dict(self.meta), "events": events}

    @classmethod
    def from_json(cls, d: "Dict[str, Any] | str") -> "Trace":
        """Rebuild a trace from ``to_json`` output (dict or JSON string).
        The result reads back identically (events/meta/report); its clock
        is a fresh ``VirtualClock`` so t0 is 0, matching the already-
        relative recorded timestamps."""
        if isinstance(d, str):
            d = json.loads(d)
        unknown = set(d) - {"meta", "events"}
        if unknown:
            raise ValueError(f"unknown Trace JSON key(s) {sorted(unknown)}")
        tr = cls(clock=VirtualClock())
        tr.meta = dict(d.get("meta", {}))
        for ev in d.get("events", []):
            ext = ev.get("extent")
            tr._events.append(TraceEvent(
                ev["kind"], ev["name"], ev["t_start"], ev["t_end"],
                ev.get("thread", ""), ev.get("nbytes", 0),
                None if ext is None else tuple(ext),
                ev.get("stage", 0)))
        return tr

    def span(self) -> float:
        evs = self.events()
        if not evs:
            return 0.0
        return max(e.t_end for e in evs) - min(e.t_start for e in evs)

    def busy_time(self, kind: str) -> float:
        """Merged-interval busy seconds for one task kind."""
        return _merged_busy((e.t_start, e.t_end) for e in self.events()
                            if e.kind == kind)

    def thread_busy(self, thread: str = "main") -> float:
        """Merged-interval busy seconds on one executor thread."""
        return _merged_busy((e.t_start, e.t_end) for e in self.events()
                            if e.thread == thread)

    def busy_fraction(self, kind: str = "compute") -> float:
        """Fraction of the makespan the given task kind was executing —
        the paper's 'GPU utilization' proxy."""
        span = self.span()
        if span <= 0:
            return 0.0
        return self.busy_time(kind) / max(1e-9, span)

    def bytes_moved(self, kind: str, name_prefix: str = "") -> int:
        """Sum of per-event payload sizes for one task kind (0-byte events
        are tasks whose submitter didn't know the size).  ``name_prefix``
        filters events by name."""
        return sum(e.nbytes for e in self.events()
                   if e.kind == kind and e.name.startswith(name_prefix))

    def report(self) -> Dict[str, Any]:
        """Pipeline instrumentation (Fig. 8/9 analogue): per-task-type busy
        time + counts, compute-thread utilization, and bubble accounting
        (compute-thread idle time = pipeline stalls waiting on transfers)."""
        evs = self.events()
        span = self.span()
        per_kind = {}
        # the four task types always get a bucket (zeroed when absent);
        # kinds the schema doesn't know (hand-built or future traces) get
        # their own bucket instead of silently vanishing from the report
        kinds = [t.value for t in TaskType]
        kinds += sorted({e.kind for e in evs} - set(kinds))
        for kind in kinds:
            sub = [e for e in evs if e.kind == kind]
            ivals = [(e.t_start, e.t_end) for e in sub]
            busy = _merged_busy(ivals)
            nbytes = sum(e.nbytes for e in sub)
            per_kind[kind] = {
                "busy_s": busy,
                "count": len(ivals),
                "busy_frac": busy / span if span > 0 else 0.0,
                "bytes": nbytes,
                # measured link bandwidth for this task kind (0 when no
                # byte-accounted events) — the observable AdaptiveDepth's
                # bandwidth feedback EWMAs per step
                "bw_Bps": nbytes / busy if busy > 0 else 0.0,
            }
        compute_busy = self.thread_busy("main")
        out = {
            "span_s": span,
            "per_kind": per_kind,
            "compute_util": compute_busy / span if span > 0 else 0.0,
            "bubble_s": max(0.0, span - compute_busy),
            "bubble_frac": (max(0.0, span - compute_busy) / span
                            if span > 0 else 0.0),
        }
        # pipeline-parallel fill/drain accounting: when any event carries a
        # stage tag, each stage gets a bucket measuring how long it idles
        # before its first compute (fill — upstream stages haven't produced
        # an activation yet) and after its last (drain — downstream stages
        # are still flushing).  Single-stage traces skip the bucket.
        if any(e.stage for e in evs):
            t_lo = min(e.t_start for e in evs)
            t_hi = max(e.t_end for e in evs)
            stage_bubbles = {}
            for s in sorted({e.stage for e in evs}):
                sub = [e for e in evs if e.stage == s]
                comp = [e for e in sub if e.kind == TaskType.COMPUTE.value]
                busy = _merged_busy((e.t_start, e.t_end) for e in comp)
                if comp:
                    fill = min(e.t_start for e in comp) - t_lo
                    drain = t_hi - max(e.t_end for e in comp)
                else:
                    fill, drain = t_hi - t_lo, 0.0
                stage_bubbles[s] = {
                    "fill_s": max(0.0, fill),
                    "drain_s": max(0.0, drain),
                    "busy_s": busy,
                    "idle_s": max(0.0, (t_hi - t_lo) - busy),
                    "span_s": t_hi - t_lo,
                }
            out["stage_bubbles"] = stage_bubbles
        # request-latency percentiles: workload runners
        # (serving.workload.run_trace / TrafficSim) stamp per-request
        # series into meta["latency"] = {"ttft": [...], "tbt": [...],
        # "e2e": [...]} (seconds); the report summarizes each so p99
        # TTFT is a first-class trace observable next to busy fractions
        lat = self.meta.get("latency")
        if lat:
            out["latency"] = {name: latency_summary(xs)
                              for name, xs in sorted(lat.items())}
        return out
