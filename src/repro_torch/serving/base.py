"""Slot-based continuous batching (the JAX package's ``serving/base.py``,
ported unchanged apart from its imports and the host tier it is handed).

``SlotEngineBase`` owns everything that is *scheduling policy*, not
compute: the request queue, slot assignment, ragged per-slot positions,
completion/preemption bookkeeping, and slot-granularity KV spill/restore
orchestration.  Concrete engines supply the compute:

  * ``ServingEngine`` (serving.engine) — fully-resident weights, one
    whole-model decode per step.
  * ``OffloadedServingEngine`` (serving.offload_engine) — weights live on
    host/disk tiers and stream through the PIPO ``PipelineScheduler``
    per layer.  Serves models larger than device memory.

Slot KV offload runs as PIPO ``KV_SAVE`` tasks on a transfer pool when one
is provided (``kv_pool``), overlapping the device->host spill with the
next decode steps instead of blocking the batch; admission to a spilled
slot synchronizes on exactly the pending save task (task-level sync, the
paper's §3.1.2 principle at request scope).  The offloaded engine's
spill/restore hooks route through its ``core.kvstore.TieredKVStore``
(rows spill packed under ``kv_mode="int4"``); this class only owns the
namespace/LRU/pinning policy, so the same invariants are testable on a
virtual clock with a fake compute engine.

Warm-pipeline engines (OffloadedServingEngine with
``PipelineScheduler(warm=True, depth=D)``) carry in-flight cross-step
state between the steps this class drives: up to D weight preloads and
the window's KV preloads.  Any path here that mutates KV rows outside
the pipeline (restore into a slot, spill reads) must go through the
engine's drain hooks (``drain_saves`` + ``drop_kv_preloads``) first —
with D > 1 there are *several* stale preloads to discard, not one.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.kvstore import PhasedKVExtents
from repro_torch.core.offload import HostStore
from repro_torch.core.pipeline import ThreadPool
from repro_torch.core.tasks import Task, TaskType


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (s,) int32
    max_new: int = 32
    eos_id: int = -1                   # -1: never stops early
    # enc-dec architectures (whisper): precomputed encoder frames
    # (enc_len, d_model); None = zero-frame stub (frontends are stubs
    # per assignment).  Ignored by decoder-only configs.
    enc_embeds: Optional[np.ndarray] = None
    # filled by the engine
    out: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    # per-request latency accounting (both engines, same fields, so TTFT
    # parity is comparable engine-to-engine): ``t_arrive`` is the
    # request's scheduled arrival — a traffic runner sets it BEFORE
    # submit to charge queue wait to the request; submit defaults it to
    # t_submit.  ``t_first_token`` mirrors t_first (kept separate so the
    # legacy field keeps its exact historical meaning); ``t_tokens``
    # records one timestamp per emitted token for TBT percentiles.
    t_arrive: float = 0.0
    t_first_token: float = 0.0
    t_tokens: List[float] = field(default_factory=list)
    # preemption state: >= 0 means this request's KV rows are spilled to
    # the host store under ``spill_ns`` and it resumes via restore, not
    # prefill.  The namespace (not the bare rid) is recorded at spill
    # time: rids may be reused across run() epochs, and a parked request
    # must find *its* rows even after the epoch advanced.
    preempt_pos: int = -1
    resume_token: int = -1
    spill_ns: str = ""


class SlotEngineBase(PhasedKVExtents):
    """Continuous batching over a fixed decode batch (b_max): requests
    queue in; a free slot triggers a b=1 prefill; each engine step decodes
    ALL active slots with ragged per-slot positions; completed slots free
    immediately (no padding to the slowest request).

    Thread affinity: the whole scheduling loop (``submit``/``run``/
    ``preempt_slot``) runs on the caller's (main) thread; only slot KV
    spills execute on ``kv_pool`` transfer threads when one is attached.

    Slot KV spills live in ``self.host`` under per-epoch namespaces
    (``e{epoch}/slot{rid}/...``): the epoch advances on every ``run()``
    call, so clients that reuse rids across runs can never alias a stale
    spill.  ``spill_cap`` bounds how many spill namespaces are retained —
    least-recently-written namespaces are evicted first, except those of
    currently-parked (preempted) requests, whose rows are still needed to
    resume.  ``host`` is the host tier spills go to (a plain
    ``HostStore`` unless the engine passes its page-locked one)."""

    def __init__(self, cfg, *, b_max: int = 4, max_len: int = 256,
                 kv_pool: Optional[ThreadPool] = None, spill_cap: int = 32,
                 host: Optional[HostStore] = None):
        self.cfg = cfg
        self.b_max = b_max
        self.max_len = max_len
        self.spill_cap = spill_cap
        self.host = host if host is not None else HostStore()
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * b_max
        self.pos = np.zeros(b_max, np.int32)           # next write position
        self.tokens = np.zeros(b_max, np.int32)        # last emitted token
        self.stats: Dict[str, int] = {
            "prefills": 0, "prefill_chunks": 0, "decode_steps": 0,
            "tokens_out": 0, "slot_saves": 0, "slot_restores": 0,
            "spill_evictions": 0}
        self._kv_pool = kv_pool
        self._slot_saves: Dict[int, Task] = {}
        self._epoch = 0
        self._spill_lru: "OrderedDict[str, bool]" = OrderedDict()
        self._ns_saves: Dict[str, Task] = {}

    # ---- engine-specific compute (implemented by subclasses) ---------------
    def _prefill_into_slot(self, slot: int, req: Request) -> int:
        """Run the prompt, scatter KV rows into the slot; returns the first
        generated token.  Main thread."""
        raise NotImplementedError

    def _decode_active(self, active: List[int]) -> np.ndarray:
        """One batched decode step over all slots; returns (b_max,) next
        tokens (values at inactive slots are ignored).  Main thread."""
        raise NotImplementedError

    def _spill_ns(self, rid: int) -> str:
        """Host-store namespace for a spill happening NOW: epoch-scoped so
        rids reused across run() epochs can never collide."""
        return f"e{self._epoch}/slot{rid}"

    def offload_slot(self, slot: int):
        """KV-save: spill a slot's cache rows to host memory under the
        occupying request's epoch namespace (the PIPO KV-save task at
        request scope).  Synchronous; main thread."""
        rid = self.slots[slot].rid if self.slots[slot] else slot
        ns = self._spill_ns(rid)
        self._offload_write(ns, self._offload_snapshot(slot))
        self._record_spill(ns)

    def restore_slot(self, slot: int, ns: str):
        """KV-load: bring an offloaded request's rows (spill namespace
        ``ns``, see ``_spill_ns``) back into a slot.  Main thread;
        blocking."""
        raise NotImplementedError

    def _offload_snapshot(self, slot: int):
        """Capture whatever the spill needs *now* (cheap; no copies for
        immutable caches) so the write can run on a transfer thread.
        Main thread."""
        raise NotImplementedError

    def _offload_write(self, ns: str, snapshot):
        """Write a snapshot's rows under host keys ``{ns}/...``.  Runs on
        a transfer-pool thread when ``kv_pool`` is attached, else on the
        main thread."""
        raise NotImplementedError

    # ---- public API ---------------------------------------------------------
    def submit(self, req: Request):
        """Enqueue a request (main thread; non-blocking)."""
        req.t_submit = time.perf_counter()
        if not req.t_arrive:
            req.t_arrive = req.t_submit
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive admission + decode until queue and slots drain (main
        thread; blocking).  Each call is a new spill *epoch*: fresh spill
        namespaces, so rids reused across runs can't alias old rows."""
        self._epoch += 1
        done: List[Request] = []
        for _ in range(max_steps):
            if self.idle():
                break
            self.step(done)
        return done

    def idle(self) -> bool:
        """True when there is nothing to do: empty queue, no occupied
        slots (main thread)."""
        return not self.queue and all(s is None for s in self.slots)

    @torch.no_grad()
    def step(self, done: List[Request]):
        """One admission + decode step — the unit ``run()`` loops;
        public so a traffic runner can
        interleave request arrivals with engine steps.  Main thread;
        completed requests are appended to ``done``.  Serving needs no
        gradients: the step runs with grad mode off, so autograd keeps
        no records and the kernel ops' grad guard returns at once."""
        self._admit()
        self._decode_step(done)

    def preempt_slot(self, slot: int):
        """Spill an active request's KV rows and push it back to the queue
        head; it resumes later via restore_slot (no re-prefill).  Main
        thread; the spill is synchronous."""
        req = self.slots[slot]
        assert req is not None, f"slot {slot} not active"
        assert slot != self._chunk_slot(), \
            "cannot preempt an in-flight chunked prefill"
        self._sync_slot(slot)
        # mark parked and enqueue BEFORE the spill is recorded: the LRU's
        # parked-pinning set is built from the queue, and the request's
        # own fresh spill must already be pinned when eviction runs
        req.spill_ns = self._spill_ns(req.rid)
        req.preempt_pos = int(self.pos[slot])
        req.resume_token = int(self.tokens[slot])
        self.queue.insert(0, req)
        self.offload_slot(slot)                 # sync spill, epoch-keyed
        self.stats["slot_saves"] += 1
        self.slots[slot] = None
        self.pos[slot] = 0

    # ---- internals ----------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _sync_slot(self, slot: int):
        """Wait for any in-flight async spill of this slot's previous
        occupant before its rows are reused."""
        t = self._slot_saves.pop(slot, None)
        if t is not None:
            t.wait()

    def _admit(self):
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            if not self._admit_one(slot):
                return

    # chunked-admission hook outcomes (engines with a SchedPolicy seam
    # override _begin_chunked_prefill; the base never chunks)
    CHUNK_OFF = 0        # not chunking: run the monolithic prefill
    CHUNK_STARTED = 1    # slot claimed; first token comes at completion
    CHUNK_BUSY = 2       # a chunked prefill is in flight: stop admitting

    def _begin_chunked_prefill(self, slot: int, req: Request) -> int:
        """Claim ``slot`` for a chunked prefill of ``req`` (which is
        still at the queue head — the caller pops on STARTED/OFF)."""
        return self.CHUNK_OFF

    def _chunk_slot(self) -> Optional[int]:
        """Slot of the in-flight chunked prefill, or None.  The slot is
        occupied (reserved) but not decode-active until the prefill
        completes and ``_finish_prefill`` runs."""
        return None

    def _admit_one(self, slot: int) -> bool:
        """Admit the queue head into ``slot``; False stops this step's
        admission loop (a chunked prefill is already in flight)."""
        req = self.queue[0]
        if req.preempt_pos >= 0:                # resume a preempted request
            self.queue.pop(0)
            self._sync_slot(slot)
            self.restore_slot(slot, req.spill_ns)
            self._drop_spill(req.spill_ns)      # rows are back in the slot
            self.stats["slot_restores"] += 1
            self.pos[slot] = req.preempt_pos
            self.tokens[slot] = req.resume_token
            req.preempt_pos = -1
            req.spill_ns = ""
            self.slots[slot] = req
            return True
        state = self._begin_chunked_prefill(slot, req)
        if state == self.CHUNK_BUSY:
            return False
        self.queue.pop(0)
        self._sync_slot(slot)
        if state == self.CHUNK_STARTED:
            # reserve the slot; chunk steps run inside _decode_step and
            # the first token lands via _finish_prefill at completion
            self.slots[slot] = req
            self.pos[slot] = 0
            return True
        tok = self._prefill_into_slot(slot, req)
        self._finish_prefill(slot, req, tok)
        return True

    def _finish_prefill(self, slot: int, req: Request, tok: int):
        """Shared first-token bookkeeping: runs at monolithic-prefill
        admission AND at chunked-prefill completion, so both paths stamp
        identical timing fields and stats."""
        self.stats["prefills"] += 1
        req.out.append(tok)
        now = time.perf_counter()
        req.t_first = now
        req.t_first_token = now
        req.t_tokens.append(now)
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        self.tokens[slot] = tok
        self.stats["tokens_out"] += 1

    def _emitted_tokens(self, active: List[int],
                        nt: np.ndarray) -> Dict[int, List[int]]:
        """Tokens each active slot emitted this step, in stream order.
        The base emits exactly one per slot (``nt[i]``); speculative
        engines override to surface the whole accepted run of a
        draft-then-verify step (up to k+1 tokens)."""
        return {i: [int(nt[i])] for i in active}

    def _decode_step(self, done: List[Request]):
        # the chunked-prefill slot (if any) is occupied but not yet
        # decode-active: its chunk rides _decode_active's generate call
        # alongside the active batch, and the step must run even when the
        # chunk is the only work in the engine
        cslot = self._chunk_slot()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i != cslot]
        if not active and cslot is None:
            return
        nt = self._decode_active(active)
        if not active:
            return
        self.stats["decode_steps"] += 1
        emitted = self._emitted_tokens(active, nt)
        now = time.perf_counter()
        for i in active:
            req = self.slots[i]
            for tok in emitted[i]:
                req.out.append(int(tok))
                req.t_tokens.append(now)
                self.stats["tokens_out"] += 1
                self.pos[i] += 1
                self.tokens[i] = int(tok)
                # completion checks run per emitted token: a speculative
                # run past max_new/eos is cut exactly where sequential
                # decode would have stopped (surplus tokens discarded)
                if (len(req.out) >= req.max_new
                        or int(tok) == req.eos_id
                        or self.pos[i] >= self.max_len - 1):
                    req.t_done = now
                    done.append(req)
                    self._release_slot(i)
                    break

    def _release_slot(self, slot: int):
        """Free a finished slot; the KV spill overlaps with the next decode
        steps when a transfer pool is available.  Main thread; the write
        itself runs on a transfer thread when possible."""
        rid = self.slots[slot].rid
        self.stats["slot_saves"] += 1
        if self._kv_pool is not None:
            ns = self._spill_ns(rid)
            snap = self._offload_snapshot(slot)
            t = Task(TaskType.KV_SAVE, f"slot_save[{ns}]",
                     lambda ns=ns, snap=snap: self._offload_write(ns, snap))
            self._kv_pool.submit(t, priority=1)   # behind loads, per §3.2.1
            self._slot_saves[slot] = t
            self._ns_saves[ns] = t
            self._record_spill(ns)
        else:
            self.offload_slot(slot)
        self.slots[slot] = None
        self.pos[slot] = 0

    # ---- spill retention (LRU with parked-request pinning) ------------------
    def _record_spill(self, ns: str):
        """Mark ``ns`` most-recently-written and evict over-cap spills.
        Main thread."""
        self._spill_lru.pop(ns, None)
        self._spill_lru[ns] = True
        parked = {r.spill_ns for r in self.queue if r.preempt_pos >= 0}
        while len(self._spill_lru) > self.spill_cap:
            victim = next((n for n in self._spill_lru if n not in parked),
                          None)
            if victim is None:
                return          # every retained spill is resumable: keep all
            self._spill_lru.pop(victim)
            t = self._ns_saves.pop(victim, None)
            if t is not None:
                t.wait()        # never delete under an in-flight write
            self._delete_spill_keys(victim)
            self.stats["spill_evictions"] += 1

    def _drop_spill(self, ns: str):
        """Forget a namespace after its rows were restored into a slot."""
        self._spill_lru.pop(ns, None)
        t = self._ns_saves.pop(ns, None)
        if t is not None:
            t.wait()
        self._delete_spill_keys(ns)

    def _delete_spill_keys(self, ns: str):
        for k in list(self.host.keys()):
            if k.startswith(ns + "/"):
                self.host.delete(k)

    def shutdown(self):
        """Drain in-flight slot spills (main thread; blocking)."""
        for t in self._slot_saves.values():
            t.wait()
        self._slot_saves.clear()
        self._ns_saves.clear()
