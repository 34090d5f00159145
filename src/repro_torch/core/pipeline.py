"""PIPO pipeline: thread pool + Algorithm-1 scheduler (paper §3.2).

Thread-pool principles (paper §3.2.1):
  * pool size 3 — one slot per transfer type (weight-load, KV-load,
    KV-save); threads are NOT statically bound to task types: they pull
    whatever is next in the queue ("flexible scheduling ... minimizes
    idle time");
  * compute runs on the MAIN thread, outside the pool;
  * KV-save is lower priority (queued behind loads) and may have several
    requests in flight; its completion is only *checked* one layer before
    the same layer's KV-load in the next token loop.

Scheduling modes:
  * "performance"  — preload the next ``depth`` layers' weights during
    layer j's compute (``depth + 1`` layers resident; ``depth=1`` is the
    paper's two-resident-layer performance pipeline);
  * "memory"       — single layer resident; loads start only after the
    previous layer's memory is released; KV-save synchronized before the
    next save launches (paper's memory-efficient pipeline);
  * "sequential"   — FlexGen-like device-level sync baseline: every task
    completes before the next starts (ablation baseline, Fig. 9).

Warm pipeline (``PipelineScheduler(warm=True)``, performance mode): the
scheduler keeps its pending-task state alive *across* ``generate()``
calls and pre-submits the next call's first ``depth`` weight loads (and
the window's KV loads) while the current call's tail layers compute —
serving engines that drain the scheduler once per decode step get zero
cold-start bubble per token (see docs/ARCHITECTURE.md and
docs/TUNING.md for sizing ``depth``).

On a CUDA device each transfer worker owns a ``torch.cuda.Stream``: its
copies run there, and it synchronizes that stream before it marks the
task done, so the trace times real transfers and the main thread only
ever receives finished tensors.  Compute runs on the main thread's
current stream and is not synchronized per task: ``run_on_main`` records
a timing event at the end of each compute task and waits only for the
*previous* compute task's event, so the host queues unit j+1 while the
card runs unit j and at most two units' work is in flight.  The previous
task's trace interval then ends at its event, mapped onto the host clock
(the interval ends when the card finished, not when the launch
returned).  A transfer that reads a compute task's output (a KV save)
carries that task's event as ``Task.after``; its worker's stream waits
for it before the copy.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.tasks import Task, TaskType, Trace, VirtualClock

PIPELINE_MODES = ("performance", "memory", "sequential")


def adopt(device: torch.device, loaded):
    """Tell the caching allocator that the compute stream uses what a
    transfer worker allocated on its own stream: a tensor, a dict of
    tensors, or of ``kvstore.PackedRows`` (anything with ``packed`` and
    ``scale``).  The worker waited for its copy before the task
    completed, so no stream wait is needed.  Main thread."""
    if device.type != "cuda" or loaded is None:
        return
    cur = torch.cuda.current_stream(device)
    for t in (loaded.values() if isinstance(loaded, dict) else (loaded,)):
        for a in ((t.packed, t.scale) if hasattr(t, "packed") else (t,)):
            a.record_stream(cur)


class ThreadPool:
    """3 transfer workers pulling from a two-level (priority) queue.

    Thread affinity: ``submit`` is called from the submitter (main)
    thread and returns immediately — the task's ``fn`` executes later on
    one of the pool's worker threads.  ``run_on_main`` executes the task
    synchronously on the *caller's* thread (compute never enters the
    pool).  ``shutdown`` blocks the caller until the workers exit.

    ``device``: with a CUDA device each worker runs its tasks on its own
    stream and synchronizes it before the task completes; compute tasks
    end at a timing event (module docstring).  ``None`` or a CPU device:
    no streams, no events."""

    def __init__(self, n_threads: int = 3, trace: Optional[Trace] = None,
                 device: Optional[torch.device] = None):
        self.trace = trace or Trace()
        self.n_workers = n_threads
        self.device = device
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._q: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = 0
        self._lock = threading.Lock()
        self._pending: Optional[Task] = None    # compute task not yet traced
        self._ref = None                        # (event, host time) anchor
        self._threads = [threading.Thread(target=self._worker,
                                          args=(f"pool-{i}",), daemon=True)
                         for i in range(n_threads)]
        for t in self._threads:
            t.start()

    def submit(self, task: Task, priority: int = 0) -> Task:
        """Enqueue a task (submitter thread; non-blocking).  Lower
        priority values run first; KV-saves use priority 1 so loads win
        ties (paper §3.2.1)."""
        task.t_submit = time.perf_counter()
        with self._lock:
            self._seq += 1
            self._q.put((priority, self._seq, task))
        return task

    def _worker(self, name: str):
        stream = torch.cuda.Stream(self.device) if self._cuda else None
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        sync = stream.synchronize if stream is not None else None
        with ctx:
            while True:
                prio, _, task = self._q.get()
                if task is None:
                    return
                if stream is not None and task.after is not None:
                    stream.wait_event(task.after)
                task.run(sync=sync)
                self.trace.add(task, name)
                self._q.task_done()

    def run_on_main(self, task: Task) -> Task:
        """Compute tasks execute on the caller (main) thread, blocking
        until the task body returns.  On a CUDA device the body only
        enqueues work: the task's ``after`` becomes a timing event
        recorded behind that work, and the call then waits for the
        previous compute task's event and traces that task."""
        if not self._cuda:
            task.run()
            self.trace.add(task, "main")
        else:
            stream = torch.cuda.current_stream(self.device)
            if self._ref is None:             # anchor: an idle stream
                stream.synchronize()
                ev = torch.cuda.Event(enable_timing=True)
                self._ref = (ev, time.perf_counter())
                ev.record(stream)
            task.run()
            task.after = torch.cuda.Event(enable_timing=True)
            task.after.record(stream)
            self.settle()
            self._pending = task
        if task.error is not None:
            raise task.error
        return task

    def settle(self):
        """Wait for the pending compute task's event, set its end to the
        host time the card reached it, and trace it (main thread).  The
        scheduler calls it after every compute task in the memory and
        sequential modes, whose invariants forbid overlap with it."""
        prev, self._pending = self._pending, None
        if prev is None:
            return
        prev.after.synchronize()
        ev, t_ref = self._ref
        prev.t_end = max(prev.t_end,
                         t_ref + ev.elapsed_time(prev.after) / 1e3)
        self.trace.add(prev, "main")

    def shutdown(self):
        """Trace the last compute task, drain queued tasks and join the
        workers (caller thread; blocking — sentinel priority 99 runs
        after all real work)."""
        self.settle()
        for _ in self._threads:
            self._q.put((99, 1 << 30, None))
        for t in self._threads:
            t.join(timeout=5)


class VirtualPool:
    """Deterministic fake transport: same interface as ThreadPool, but every
    task executes synchronously on the caller thread while its start/end
    timestamps are assigned on a *virtual* discrete-event timeline with
    ``n_threads`` parallel transfer slots.

    The timeline models exactly what the scheduler enforces: a submitted
    task starts at max(submission time, earliest-free worker); a wait()
    advances the virtual clock to the task's end (the caller blocked until
    then).  Per-task durations come from ``cost_fn(task)`` — tests supply
    fixed costs per TaskType, so scheduler ordering invariants (overlap,
    serialization, save-before-load) are asserted on virtual timestamps
    with zero sleeps and zero timing races.
    """

    def __init__(self, n_threads: int = 3, trace: Optional[Trace] = None,
                 cost_fn: Optional[Callable[[Task], float]] = None,
                 clock: Optional[VirtualClock] = None):
        self.clock = clock or VirtualClock()
        self.trace = trace if trace is not None else Trace(clock=self.clock)
        self.cost_fn = cost_fn or (lambda task: 1.0)
        self.n_workers = n_threads
        self._free = [0.0] * n_threads

    def submit(self, task: Task, priority: int = 0) -> Task:
        """Run the task NOW on the caller thread (side effects are
        immediate, single-threaded) while assigning its trace interval
        on the virtual timeline's earliest-free worker."""
        task.t_submit = self.clock.now()
        task.run(self.clock)               # side effects happen now
        w = min(range(len(self._free)), key=lambda k: self._free[k])
        start = max(self.clock.now(), self._free[w])
        end = start + float(self.cost_fn(task))
        task.t_start, task.t_end = start, end
        self._free[w] = end
        task.on_wait = self._advance       # waiters block until virtual end
        self.trace.add(task, f"vpool-{w}")
        return task

    def _advance(self, task: Task):
        self.clock.advance_to(task.t_end)

    def settle(self):
        pass                               # compute is traced in run_on_main

    def run_on_main(self, task: Task) -> Task:
        start = self.clock.now()
        task.run(self.clock)
        end = start + float(self.cost_fn(task))
        task.t_start, task.t_end = start, end
        self.clock.advance_to(end)
        self.trace.add(task, "main")
        if task.error is not None:
            raise task.error
        return task

    def shutdown(self):
        pass


@dataclass
class LayerTasks:
    """Per-(iteration, layer) task handles used by the scheduler."""
    weight: Optional[Task] = None
    kv_load: Optional[Task] = None
    kv_save: Optional[Task] = None


class PipelineScheduler:
    """Algorithm 1.  The model supplies callbacks; the scheduler owns all
    ordering/synchronization decisions so they can be tested in isolation
    (tests assert the event-order invariants on Trace timestamps).

    Thread affinity: ``generate``/``drop_kv_preloads``/``drain_saves``/
    ``shutdown`` run on the submitter (main) thread and may block on task
    completion; the model's ``load_weights``/``load_kv``/``save_kv``
    callbacks execute on transfer-pool threads and must be thread-safe;
    ``compute``/``finalize``/``release_weights`` run on the main thread.

    Callbacks (all pure-ish, thread-safe):
      load_weights(j) -> device weights      (WEIGHT_LOAD)
      release_weights(j, handle)             (called on main after compute)
      load_kv(i, j) -> device kv             (KV_LOAD; None for non-MHA)
      save_kv(i, j, new_kv)                  (KV_SAVE)
      compute(i, j, x, weights, kv) -> (x, new_kv)   (COMPUTE, main thread)
      is_mha(j) -> bool
      weight_nbytes(j) -> int                (optional; trace byte account)

    Preload depth (``depth``, performance pipeline only): the scheduler
    keeps the weight loads of the next ``depth`` schedulable positions in
    flight while the current layer computes — ``depth + 1`` layers
    resident, ``depth=1`` reproduces the paper's two-resident-layer
    invariant.  On weight-dominated links a deeper window hides more
    transfer time behind the same compute (up to the pool's parallelism);
    ``core.autoconfig`` sizes it from the memory budget.  ``depth`` is
    clamped to ``num_layers - 1`` so no layer can ever have two loads
    pending under the same key.

    Warm mode (``warm=True``, performance pipeline only): pending task
    state persists *across* ``generate()`` calls.  At the tail of a call,
    the first ``depth`` weight loads (and the window's KV loads) of the
    NEXT call are pre-submitted so they overlap the tail layers' compute
    — a serving engine that drains the scheduler once per decode step
    then starts every step with its first layers' transfers already
    resident instead of paying a cold-start bubble per token.  Iteration
    indices become global (monotonic across calls) so the KV
    save(i-1,j)-before-load(i,j) check keeps working across call
    boundaries.
    """

    def __init__(self, num_layers: int, mode: str = "performance",
                 pool: Optional[ThreadPool] = None,
                 trace: Optional[Trace] = None, warm: bool = False,
                 depth: int = 1, device: Optional[torch.device] = None,
                 stage: int = 0, unit_base: int = 0):
        if mode not in PIPELINE_MODES:
            raise ValueError(f"mode {mode!r} not in {PIPELINE_MODES}")
        self.n = num_layers
        self.mode = mode
        # pipeline-parallel placement: ``stage`` tags every task this
        # scheduler submits; ``unit_base`` offsets task NAMES to the
        # global unit index so a shared multi-stage trace stays
        # replayable — callbacks still receive stage-local indices (a
        # StagedScheduler's per-stage model view translates).
        self.stage = int(stage)
        self.unit_base = int(unit_base)
        self.trace = trace or Trace()
        # cross-call ("warm pipeline") state: preloading across generate()
        # calls only makes sense in performance mode — memory mode's
        # single-layer-resident invariant forbids a second in-flight load,
        # and sequential is a full-serialization baseline by definition.
        self.warm = bool(warm) and mode == "performance"
        self.depth = self.clamp_depth(mode, num_layers, depth)
        self.pool = pool or ThreadPool(self.pool_size(self.depth),
                                       self.trace, device=device)
        self._owns_pool = pool is None
        self._w_tasks: Dict[int, Task] = {}          # j -> pending load
        self._kv_tasks: Dict[tuple, Task] = {}       # (i, j) -> pending load
        self._save_tasks: Dict[tuple, Task] = {}     # (i, j) -> pending save
        self._iter0 = 0                              # global iteration base
        # stamp the replayable scheduling context on the trace: with the
        # per-call iteration counts generate() appends, a replayer can
        # re-run the recorded schedule under hypothetical knobs
        self.trace.meta.update(
            mode=self.mode, warm=self.warm, depth=self.depth,
            n_units=self.n,
            pool_size=getattr(self.pool, "n_workers", None)
            or self.pool_size(self.depth))
        self.trace.meta.setdefault("calls", [])

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def clamp_depth(mode: str, num_layers: int, depth: int) -> int:
        """Effective preload depth: > 1 only exists in performance mode,
        and the clamp to n-1 keeps every pending weight load's layer key
        unique (window positions p+1..p+depth are distinct mod n iff
        depth <= n-1).  Engines that pre-build the transfer pool must use
        this + ``pool_size`` so their pool matches the scheduler's
        window."""
        if mode != "performance":
            return 1
        return max(1, min(int(depth), max(1, num_layers - 1)))

    def set_depth(self, depth: int) -> int:
        """Re-size the preload window between ``generate()`` calls (main
        thread) — the ``AdaptiveDepth`` policy's hook.  Takes effect for
        every *subsequent* preload decision: when shrinking at a warm
        tail, loads already in flight beyond the new window are simply
        consumed by the next call's first computes (weights are
        immutable, so nothing is stale), after which residency settles
        to the new ``depth + 1`` bound.  Clamped exactly like the
        constructor; returns the effective depth."""
        self.depth = self.clamp_depth(self.mode, self.n, depth)
        return self.depth

    @staticmethod
    def pool_size(depth: int) -> int:
        """Transfer workers for a depth-D window: depth workers for the
        window's weight loads plus 2 of KV headroom (depth=1 -> the
        paper's one-worker-per-transfer-type pool of 3).  The window can
        also hold up to depth KV *pre*loads, but those are short-lived
        relative to weight loads (cache rows vs merged layer buffers)
        and share the headroom; what the sizing must prevent is weight
        loads monopolizing every worker — with a fixed 3-worker pool,
        depth>=2 queued far-future weight preloads in front of the
        imminent KV traffic and measurably REGRESSED KV-heavy links
        (see docs/BENCHMARKS.md)."""
        return depth + 2

    def _submit(self, kind: TaskType, name: str, fn, priority=0,
                nbytes: int = 0, extent=None, after=None) -> Task:
        t = Task(kind, name, fn)
        t.nbytes = nbytes            # before submit: VirtualPool traces here
        t.extent = extent
        t.after = after
        t.stage = self.stage
        self.pool.submit(t, priority)
        if self.mode == "sequential":
            t.wait()
        return t

    # -- warm-pipeline maintenance (main thread) ----------------------------
    def drop_kv_preloads(self):
        """Discard ALL pending cross-call KV preloads — with ``depth > 1``
        a warm call's tail leaves up to ``depth`` of them in flight (one
        per MHA position in the window), not just the next layer's.  Main
        thread; blocks until every in-flight load finishes so its
        host-side reads can't race the caller's mutation.  Call before
        mutating KV state outside the pipeline (e.g. a serving slot
        restore writes host KV directly) — every preloaded device copy
        would be stale.  Weight preloads are untouched (weights are
        immutable)."""
        for t in self._kv_tasks.values():
            try:
                t.wait()
            except Exception:
                pass                  # discarded anyway
        self._kv_tasks.clear()

    def drain_saves(self):
        """Block (main thread) until every outstanding KV save has landed.
        In warm mode saves are NOT drained per generate() call (that sync
        is itself a bubble); callers that read or write KV storage outside
        the pipeline must drain first."""
        for t in self._save_tasks.values():
            t.wait()
        self._save_tasks.clear()

    def prime_weights(self, model, count: Optional[int] = None) -> int:
        """Pre-submit the NEXT ``generate()`` call's first ``count``
        weight loads (default: the preload depth) — the warm-window
        generalization of the cross-step preload for speculative
        decoding: while the device-resident DRAFT computes its
        proposals, the link is idle, so the verify pass's first layers
        stream during draft compute instead of cold-starting after it.
        Main thread; non-blocking; a no-op for layers already in flight
        (a warm tail may have submitted them) and outside performance
        mode (the single-layer-resident/sequential invariants forbid a
        second pending load).  Never primes beyond the window — the
        ``depth + 1`` residency bound holds exactly as in steady state.
        Returns the number of loads actually submitted."""
        if self.mode != "performance":
            return 0
        nbytes_of = getattr(model, "weight_nbytes", None)
        c = self.depth if count is None else \
            max(0, min(int(count), self.depth))
        submitted = 0
        for j in range(min(c, self.n)):
            if j in self._w_tasks:
                continue
            self._w_tasks[j] = self._submit(
                TaskType.WEIGHT_LOAD, f"w[{self.unit_base + j}]",
                lambda j=j: model.load_weights(j),
                nbytes=nbytes_of(j) if nbytes_of else 0)
            submitted += 1
        return submitted

    # -- Algorithm 1 ----------------------------------------------------------
    def generate(self, model, x0, num_iterations: int):
        """Run ``num_iterations`` full passes over the layer stack (one per
        generated token); x0 is the initial activation provider:
        callable i -> x input for iteration i (call-local index).  Blocks
        the calling (main) thread; compute runs here, transfers on the
        pool.  Task/trace names use *global* iteration indices so events
        from successive warm calls stay distinct."""
        n = self.n
        w_tasks, kv_tasks, save_tasks = (self._w_tasks, self._kv_tasks,
                                         self._save_tasks)
        base = self._iter0
        self.trace.meta.setdefault("calls", []).append(num_iterations)
        total = n * num_iterations             # call-local position count
        outputs = []
        nbytes_of = getattr(model, "weight_nbytes", None)
        kv_nbytes_of = getattr(model, "kv_nbytes", None)
        # optional byte-accounting hooks a tiered-KV model exposes: the
        # live (batch, len) extent of a KV_LOAD payload (recorded on the
        # trace event so live-row slicing is assertable) and the size of
        # a KV_SAVE payload (so report() splits ALL link volume by kind,
        # not just the load directions)
        kv_extent_of = getattr(model, "kv_extent", None)
        kv_save_nbytes_of = getattr(model, "kv_save_nbytes", None)
        ub = self.unit_base                    # global-name offset

        def submit_weight(j):
            if j is not None and j < n and j not in w_tasks:
                w_tasks[j] = self._submit(
                    TaskType.WEIGHT_LOAD, f"w[{ub + j}]",
                    lambda j=j: model.load_weights(j),
                    nbytes=nbytes_of(j) if nbytes_of else 0)

        def submit_kv(i, j, blocking=True):
            if j is None or not model.is_mha(j):
                return
            if (i, j) in kv_tasks:
                return
            # KV-save completion check, advanced ahead of the load (paper):
            # the save from iteration i-1, layer j must be done before we
            # load layer j's cache in iteration i.  A *pre*load must not
            # stall the main thread on an unfinished save — skip it; a
            # later window pass (or the blocking just-in-time submit)
            # retries once the save has landed.
            prev_save = save_tasks.get((i - 1, j))
            if prev_save is not None:
                if not blocking and not prev_save.done.is_set():
                    return
                save_tasks.pop((i - 1, j))
                prev_save.wait()
            kv_tasks[(i, j)] = self._submit(
                TaskType.KV_LOAD, f"kv[{i},{ub + j}]",
                lambda i=i, j=j: model.load_kv(i, j),
                nbytes=kv_nbytes_of(i, j) if kv_nbytes_of else 0,
                extent=kv_extent_of(i, j) if kv_extent_of else None)

        def preload_window(pc):
            """Keep the next ``depth`` positions' weight loads — and the
            window's KV loads, plus the paper's advance-one-MHA rule — in
            flight while position ``pc`` computes.  Positions past the
            call's tail belong to the NEXT call (warm pipelines only)."""
            for d in range(1, self.depth + 1):
                p = pc + d
                if p >= total and not self.warm:
                    break
                submit_weight(p % n)
            # KV preload of (i, j) is legal only once compute(i-1, j) has
            # been issued — before that, the save it must trail is not
            # even in save_tasks, so the save-before-load check couldn't
            # see it.  Structurally that bounds the lookahead to n-1
            # positions (the distance to the same layer one iteration
            # earlier).
            seen_mha = False
            for d in range(1, n):
                p = pc + d
                if p >= total and not self.warm:
                    break
                jp = p % n
                if not model.is_mha(jp):
                    continue
                if d > self.depth and seen_mha:
                    break              # beyond the window AND advanced one
                submit_kv(base + p // n, jp, blocking=False)
                seen_mha = True
                if d >= self.depth:
                    break

        for it in range(num_iterations):
            gi = base + it                         # global iteration index
            x = x0(it)
            for j in range(n):
                # --- CallLoadData(i, j): ensure current loads in flight ----
                submit_weight(j)                       # no-op if preloaded
                submit_kv(gi, j)                       # no-op if advanced

                # --- SynchronizeLoadTask(i, j) -----------------------------
                weights = w_tasks.pop(j).wait()
                kv = None
                if model.is_mha(j):
                    kv = kv_tasks.pop((gi, j)).wait()

                if self.mode == "performance":
                    # Preload: each window load starts only after the one
                    # ``depth`` positions back completed (= now),
                    # overlapping with this layer's compute (paper §3.1.2;
                    # depth=1 is the paper's next-layer preload).  At the
                    # stack tail a warm scheduler preloads for the NEXT
                    # generate() call.
                    preload_window(it * n + j)

                # --- Compute(i, j) on the main thread ----------------------
                ct = Task(TaskType.COMPUTE, f"c[{gi},{ub + j}]",
                          lambda: model.compute(gi, j, x, weights, kv))
                ct.stage = self.stage
                self.pool.run_on_main(ct)
                if self.mode != "performance":
                    self.pool.settle()
                x, new_kv = ct.result

                # --- CallStoreCache(i, j) ----------------------------------
                if model.is_mha(j) and new_kv is not None:
                    st = self._submit(TaskType.KV_SAVE, f"sv[{gi},{ub + j}]",
                                      lambda gi=gi, j=j, kv=new_kv:
                                      model.save_kv(gi, j, kv),
                                      priority=1,  # lower priority
                                      nbytes=(kv_save_nbytes_of(gi, j)
                                              if kv_save_nbytes_of else 0),
                                      after=ct.after)
                    save_tasks[(gi, j)] = st
                    if self.mode in ("memory", "sequential"):
                        st.wait()

                model.release_weights(j, weights)
            outputs.append(model.finalize(it, x))
        self._iter0 = base + num_iterations
        if not self.warm:
            # cold pipeline: drain outstanding saves before returning (the
            # caller may read host KV directly).  Warm pipelines keep saves
            # in flight across calls; drain_saves()/shutdown() syncs.
            self.drain_saves()
        return outputs

    def shutdown(self):
        """Drain outstanding saves and stop the pool if owned (main
        thread; blocking)."""
        self.drain_saves()
        if self._owns_pool:
            self.pool.shutdown()


class _StageView:
    """One stage's view of a global model: the child scheduler hands it
    stage-local unit indices, the wrapped model speaks global ones.
    Non-final stages return ``(activation, t_ready)`` from ``finalize``
    so the downstream stage's activation provider can advance its own
    virtual clock to the handoff point (real pools carry no virtual
    clock; the timestamp is then unused)."""

    def __init__(self, model, base: int, final: bool, clock=None):
        self._m = model
        self._b = base
        self._final = final
        self._clock = clock
        b = base
        # byte-accounting hooks are optional on models; mirror exactly the
        # ones present so generate()'s getattr probes see the same surface
        if hasattr(model, "weight_nbytes"):
            self.weight_nbytes = lambda j: model.weight_nbytes(b + j)
        if hasattr(model, "kv_nbytes"):
            self.kv_nbytes = lambda i, j: model.kv_nbytes(i, b + j)
        if hasattr(model, "kv_extent"):
            self.kv_extent = lambda i, j: model.kv_extent(i, b + j)
        if hasattr(model, "kv_save_nbytes"):
            self.kv_save_nbytes = \
                lambda i, j: model.kv_save_nbytes(i, b + j)

    def is_mha(self, j):
        return self._m.is_mha(self._b + j)

    def load_weights(self, j):
        return self._m.load_weights(self._b + j)

    def release_weights(self, j, handle):
        return self._m.release_weights(self._b + j, handle)

    def load_kv(self, i, j):
        return self._m.load_kv(i, self._b + j)

    def save_kv(self, i, j, new_kv):
        return self._m.save_kv(i, self._b + j, new_kv)

    def compute(self, i, j, x, weights, kv):
        return self._m.compute(i, self._b + j, x, weights, kv)

    def finalize(self, it, x):
        if self._final:
            return self._m.finalize(it, x)
        t = self._clock.now() if self._clock is not None else 0.0
        return (x, t)


class StagedScheduler:
    """Pipeline-parallel composition of per-stage Algorithm-1 schedulers.

    The layer stack is split into contiguous stages; each stage owns its
    OWN scheduler, transfer pool, and (on the engines) tiered stores —
    so every stage streams only its slice and aggregate link bandwidth
    scales with stage count.  Microbatched activations hand stage to
    stage: stage ``s+1`` computes microbatch ``m`` while stage ``s``
    computes ``m+1`` and both overlap their own WEIGHT/KV loads.

    On the virtual harness each stage's pool carries its own
    ``VirtualClock`` over ONE shared ``Trace`` (all clocks start at the
    trace origin): stages execute sequentially in wall order, but the
    downstream provider advances its stage clock to
    ``max(own time, upstream handoff time)`` — exactly the pipeline
    recurrence — so overlap, fill/drain bubbles, and per-stage residency
    are all assertable on virtual timestamps.  Task names use GLOBAL
    unit indices (``unit_base``), every task carries its ``stage`` tag,
    and ``meta`` records ``stages``/``stage_units``/``stage_depths`` so
    ``core.replay`` can rebuild the staged run.

    ``handoff(stage, it, x)`` is the activation-transport seam: identity
    here (queue handoff); the staged serving engine's subclass moves the
    activation onto the receiving stage's device
    (``serving.offload_engine._MeshStagedScheduler``).
    """

    def __init__(self, stage_units, mode: str = "performance", pools=None,
                 trace: Optional[Trace] = None, warm: bool = False,
                 depths=None):
        units = [(int(lo), int(hi)) for lo, hi in stage_units]
        if not (units and all(lo < hi for lo, hi in units)
                and units[0][0] == 0
                and all(units[s][1] == units[s + 1][0]
                        for s in range(len(units) - 1))):
            raise ValueError(f"stages must tile the stack contiguously: "
                             f"{units}")
        self.stage_units = units
        self.n = units[-1][1]
        self.mode = mode
        if depths is None:
            depths = [1] * len(units)
        if pools is None:
            pools = [None] * len(units)
        self.trace = trace or Trace()
        self.scheds = [
            PipelineScheduler(hi - lo, mode, pool=pools[s], trace=self.trace,
                              warm=warm, depth=depths[s], stage=s,
                              unit_base=lo)
            for s, (lo, hi) in enumerate(units)]
        self.warm = self.scheds[0].warm
        self.depths = [sc.depth for sc in self.scheds]
        self.depth = max(self.depths)
        # each child stamped the shared meta with its own local view (last
        # writer won); restamp the staged run as a whole
        self.trace.meta.update(
            mode=self.mode, warm=self.warm, depth=self.depth,
            n_units=self.n,
            pool_size=max(getattr(sc.pool, "n_workers", 0)
                          or PipelineScheduler.pool_size(sc.depth)
                          for sc in self.scheds),
            stages=len(self.scheds),
            stage_units=[list(u) for u in units],
            stage_depths=list(self.depths))
        self.trace.meta.setdefault("calls", [])

    # -- activation transport (override on real meshes) ---------------------
    def handoff(self, stage: int, it: int, x):
        """Move microbatch ``it``'s activation onto stage ``stage``:
        identity queue-handoff here."""
        return x

    @property
    def _iter0(self) -> int:
        """Global iteration base (all stages advance in lockstep — the
        serving engines read this to anchor their live decode view)."""
        return self.scheds[0]._iter0

    def prime_weights(self, model, count: Optional[int] = None) -> int:
        """Fan ``prime_weights`` out to every stage (each primes its own
        window through its stage view); returns total loads submitted."""
        last = len(self.scheds) - 1
        return sum(
            sc.prime_weights(
                _StageView(model, sc.unit_base, s == last,
                           getattr(sc.pool, "clock", None)), count)
            for s, sc in enumerate(self.scheds))

    # -- staged Algorithm 1 --------------------------------------------------
    def generate(self, model, x0, num_iterations: int):
        """Run ``num_iterations`` microbatches through every stage.  The
        model's callbacks use GLOBAL unit indices (each stage sees its
        slice through a ``_StageView``).  Blocks the calling thread;
        returns the final stage's outputs."""
        calls = self.trace.meta.setdefault("calls", [])
        mark = len(calls)                    # children append; collapse below
        outs = None
        for s, sched in enumerate(self.scheds):
            final = s == len(self.scheds) - 1
            clock = getattr(sched.pool, "clock", None)
            view = _StageView(model, sched.unit_base, final, clock)
            # all stages start streaming their first window at the current
            # stage-local time — never gated on upstream activations
            sched.prime_weights(view)
            if s == 0:
                prov = x0
            else:
                handed = outs

                def prov(it, _h=handed, _c=clock, _s=s):
                    x, t_ready = _h[it]
                    if isinstance(_c, VirtualClock):
                        _c.advance_to(t_ready)
                    return self.handoff(_s, it, x)
            outs = sched.generate(view, prov, num_iterations)
        # each child recorded the call; the staged run is ONE call
        del calls[mark:]
        calls.append(num_iterations)
        return outs

    # -- maintenance fan-out (main thread) -----------------------------------
    def set_depth(self, depth: int) -> int:
        """Uniform window re-size across stages (per-stage caps apply);
        returns the largest effective depth."""
        self.depths = [sc.set_depth(depth) for sc in self.scheds]
        self.depth = max(self.depths)
        self.trace.meta.update(depth=self.depth,
                               stage_depths=list(self.depths))
        return self.depth

    def drop_kv_preloads(self):
        for sc in self.scheds:
            sc.drop_kv_preloads()

    def drain_saves(self):
        for sc in self.scheds:
            sc.drain_saves()

    def shutdown(self):
        for sc in self.scheds:
            sc.shutdown()
