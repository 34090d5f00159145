"""Engine plans for the port: the JAX package's ``serving/spec.py``.

  spec = EngineSpec(arch="llama3.1-8b", quant="int4")
  plan = spec.resolve()          # every auto field materialized + why
  eng  = create_engine(plan)     # ServingEngine | OffloadedServingEngine
  lm   = build_lm(plan)          # the batch-generation PipelinedLM

``EngineSpec`` is the intent (``None``/"auto" fields, typed
``SpecError``s); ``resolve(budget)`` runs the paper's §3.5 memory model
(``core.autoconfig``) and returns a ``ResolvedPlan`` whose JSON, the
per-field provenance included, equals the JAX package's for the same
spec.  The policy seams the offloaded engine consults live here too
(``PreloadPolicy``: ``StaticDepth``/``AdaptiveDepth``; ``QuantPolicy``/
``WeightsInt4``; ``SchedPolicy``), and ``CLI_FLAGS`` is the one
flag<->field table ``launch.serve`` generates its argparse from.

``resolve(trace=...)`` replays the recorded trace (``core.replay``) to
pick the depth, or on a staged recording the (stages, depth) pair, as
the JAX package does.  ``sched="online"|"offline"`` builds the chunked-
prefill offloaded engine (``OnlineSLO``/``OfflineThroughput``).  Plans
that ask for speculation or pipeline stages resolve as in the JAX
package; building their engines raises ``NotImplementedError`` naming
the later slice of the port.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ATTN, MOE, ModelConfig, scaled_down
from repro_torch.configs.registry import get_config
from repro_torch.core.memory_model import host_pinned_bytes, live_depth
from repro_torch.core.offload import MemoryBudget
from repro_torch.core.pipeline import PIPELINE_MODES

QUANT_MODES = (None, "int4")
KV_MODES = (None, "fp32", "int4")       # None = auto (resolves to fp32)
DEPTH_POLICIES = ("static", "adaptive")
PLACEMENTS = ("auto", "device", "host", "disk")
SCHED_MODES = (None, "online", "offline", "monolithic")
STAGE_AXES = (None, "layer")            # None = auto (resolves to "layer")


class SpecError(ValueError):
    """An EngineSpec field (or field combination) is invalid."""


class UnsupportedModelError(RuntimeError):
    """The offloaded engine cannot serve this architecture; carries the
    failing capability (``resolve`` gives such plans the resident
    engine)."""

    def __init__(self, capability: str, message: str):
        super().__init__(message)
        self.capability = capability


def offload_capability(cfg: ModelConfig) -> Optional[str]:
    """The capability that rules out offloaded serving for ``cfg``, or
    None when the offloaded engine supports it (token-frontend rope
    decoder stacks only)."""
    if cfg.enc_dec:
        return "enc_dec"
    if cfg.frontend == "embeds":
        return "embeds_frontend"
    if cfg.rope_theta == 0:
        return "no_rope"
    return None


def _dense_global_attn_capability(cfg: ModelConfig) -> Optional[str]:
    """Shared gate for features that need a dense global-attention
    decoder stack on the offloaded engine (speculative verify, chunked
    prefill)."""
    cap = offload_capability(cfg)
    if cap is not None:
        return cap
    for spec in tuple(cfg.pattern) + tuple(cfg.remainder):
        if spec.mixer != ATTN:
            return f"mixer_{spec.mixer}"
        if spec.ffn == MOE:
            return "moe_ffn"
    return None


def spec_decode_capability(cfg: ModelConfig) -> Optional[str]:
    """The capability that rules out speculative decoding for ``cfg`` as
    the TARGET model, or None when supported.  The verify pass scores
    k+1 positions in one ragged decode step
    (``attention.spec_decode_attention``), which exists for global
    attention only — window/MLA/SSM mixers keep single-token decode
    state.  MoE is out too: routing k+1 tokens jointly changes the
    capacity/slot assignment versus k+1 sequential steps, which would
    break the bit-exact parity speculation promises."""
    return _dense_global_attn_capability(cfg)


def chunked_prefill_capability(cfg: ModelConfig) -> Optional[str]:
    """The capability that rules out chunked prefill for ``cfg``, or
    None when supported.  A prefill chunk attends its fresh rows against
    the engine-held running prefix (``attention.chunk_prefill_attention``)
    — global attention only: window mixers need rolling-buffer chunk
    state and MLA/SSM keep latent/conv state the chunk path doesn't
    carry.  MoE is out for the same reason as speculation: expert
    capacity depends on the token count per pass, so chunked routing
    diverges bitwise from the monolithic pass."""
    return _dense_global_attn_capability(cfg)



# ---------------------------------------------------------------------------
# shared JSON/registry plumbing (EngineSpec and ResolvedPlan)
# ---------------------------------------------------------------------------


def _registry_config(arch: str, scaled: bool,
                     cfg: Optional[ModelConfig]) -> ModelConfig:
    if cfg is not None:
        return cfg
    try:
        base = get_config(arch)
    except KeyError as e:
        raise SpecError(str(e)) from e
    return scaled_down(base) if scaled else base


def _json_dict(obj) -> Dict[str, Any]:
    d = dataclasses.asdict(obj)
    d.pop("cfg")                       # not serializable, not compared
    return d


def _from_json_dict(cls, d: "Dict[str, Any] | str", *, require_all: bool):
    if isinstance(d, str):
        d = json.loads(d)
    known = {f.name for f in dataclasses.fields(cls)} - {"cfg"}
    unknown = set(d) - known
    if unknown:
        raise SpecError(f"unknown {cls.__name__} field(s) "
                        f"{sorted(unknown)}")
    if require_all:
        missing = known - set(d)
        if missing:
            raise SpecError(f"{cls.__name__} JSON missing "
                            f"{sorted(missing)}")
    return cls(**d)


# ---------------------------------------------------------------------------
# EngineSpec — declarative intent
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EngineSpec:
    """Declarative engine plan.  ``None`` / ``"auto"`` fields are
    resolved against the memory budget by ``resolve()``; everything else
    is validated as-is.  ``cfg`` optionally overrides the registry
    lookup (ad-hoc benchmark configs); it is excluded from JSON and
    equality — a spec is registry-reconstructable iff ``cfg`` is None."""

    arch: str = "tinyllama-1.1b"
    scaled: bool = False
    # -- batch + lengths ---------------------------------------------------
    b_max: int = 4
    max_len: int = 256
    seed: int = 0
    # -- engine + placement ------------------------------------------------
    offload: Optional[bool] = None      # None: memory model decides
    placement: str = "auto"             # auto|device|host|disk
    # -- pipeline ----------------------------------------------------------
    pipeline: str = "performance"
    warm: Optional[bool] = None         # None: performance => warm
    depth: Optional[int] = None         # None: budget-sized
    depth_policy: str = "static"        # static|adaptive
    # -- quant -------------------------------------------------------------
    quant: Optional[str] = None         # None|int4
    kv_mode: Optional[str] = None       # None(auto->fp32)|fp32|int4
    fused_int4: Optional[bool] = None   # None: §3.5 batch<16 rule
    moe_quant: Optional[str] = None     # None|int4 resident expert stacks
    # -- spill / io / sim --------------------------------------------------
    spill_cap: int = 32
    cache_on: str = "host"              # PipelinedLM only: host|device
    disk_root: str = ""                 # "": default root
    block_bytes: Optional[int] = None   # None: 8 MiB (Appendix A)
    n_io_threads: int = 3
    cold_reads: bool = False
    sim_bw: Optional[float] = None
    # -- speculative decoding ----------------------------------------------
    draft_arch: Optional[str] = None    # device-resident draft arch; None=off
    spec_k: Optional[int] = None        # proposals per verify (None: auto)
    # -- traffic scheduling ------------------------------------------------
    sched: Optional[str] = None         # None(auto->monolithic)|online|offline
    prefill_chunk: Optional[int] = None  # prompt tokens per step (None: auto)
    # -- pipeline parallelism ----------------------------------------------
    stages: Optional[int] = None        # None(auto->1)|N contiguous stages
    stage_axis: Optional[str] = None    # None(auto)|"layer"
    # -- ad-hoc config override (not serialized, not compared) -------------
    cfg: Optional[ModelConfig] = field(default=None, compare=False,
                                       repr=False)

    # ---- JSON ------------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return _json_dict(self)

    @classmethod
    def from_json(cls, d: "Dict[str, Any] | str") -> "EngineSpec":
        return _from_json_dict(cls, d, require_all=False)

    # ---- validation ------------------------------------------------------
    def model_config(self) -> ModelConfig:
        return _registry_config(self.arch, self.scaled, self.cfg)

    def validate(self) -> None:
        """Typed field/combination checks; raises ``SpecError``."""
        def bad(msg):
            raise SpecError(msg)
        if self.placement not in PLACEMENTS:
            bad(f"placement {self.placement!r} not in {PLACEMENTS}")
        if self.pipeline not in PIPELINE_MODES:
            bad(f"pipeline {self.pipeline!r} not in {PIPELINE_MODES}")
        if self.quant not in QUANT_MODES:
            bad(f"quant {self.quant!r} not in {QUANT_MODES}")
        if self.kv_mode not in KV_MODES:
            bad(f"kv_mode {self.kv_mode!r} not in {KV_MODES}")
        if self.moe_quant not in QUANT_MODES:
            bad(f"moe_quant {self.moe_quant!r} not in {QUANT_MODES}")
        if self.moe_quant is not None and self.model_config().moe is None:
            bad(f"moe_quant={self.moe_quant!r} needs an MoE architecture "
                f"({self.arch!r} has no expert stacks)")
        if self.depth_policy not in DEPTH_POLICIES:
            bad(f"depth_policy {self.depth_policy!r} not in "
                f"{DEPTH_POLICIES}")
        if self.cache_on not in ("host", "device"):
            bad(f"cache_on {self.cache_on!r} not in ('host', 'device')")
        if self.b_max < 1:
            bad(f"b_max must be >= 1, got {self.b_max}")
        if self.max_len < 2:
            bad(f"max_len must be >= 2, got {self.max_len}")
        if self.depth is not None and self.depth < 1:
            bad(f"depth must be >= 1 (or None for auto), got {self.depth}")
        if self.spill_cap < 0:
            bad(f"spill_cap must be >= 0, got {self.spill_cap}")
        if self.n_io_threads < 1:
            bad(f"n_io_threads must be >= 1, got {self.n_io_threads}")
        if self.block_bytes is not None and self.block_bytes < 4096:
            bad(f"block_bytes must be >= 4096, got {self.block_bytes}")
        if self.sim_bw is not None and self.sim_bw <= 0:
            bad(f"sim_bw must be > 0, got {self.sim_bw}")
        if self.spec_k is not None and self.spec_k < 1:
            bad(f"spec_k must be >= 1 (or None for auto), got {self.spec_k}")
        if self.sched not in SCHED_MODES:
            bad(f"sched {self.sched!r} not in {SCHED_MODES}")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            bad(f"prefill_chunk must be >= 1 (or None for auto), got "
                f"{self.prefill_chunk}")
        if self.prefill_chunk is not None and self.sched not in ("online",
                                                                 "offline"):
            bad("prefill_chunk needs a chunking policy (set sched='online' "
                "or 'offline'; monolithic prefill has no chunks)")
        if self.stages is not None and self.stages < 1:
            bad(f"stages must be >= 1 (or None for auto), got {self.stages}")
        if self.stage_axis not in STAGE_AXES:
            bad(f"stage_axis {self.stage_axis!r} not in {STAGE_AXES}")
        if self.spec_k is not None and self.draft_arch is None:
            bad("spec_k needs a draft model (set draft_arch; speculation "
                "is draft-proposes, target-verifies)")
        if self.draft_arch is not None:
            dcfg = _registry_config(self.draft_arch, self.scaled, None)
            if dcfg.vocab_size != self.model_config().vocab_size:
                bad(f"draft_arch {self.draft_arch!r} vocab "
                    f"({dcfg.vocab_size}) != target vocab "
                    f"({self.model_config().vocab_size}); the draft "
                    f"proposes target token ids")
            cap = spec_decode_capability(self.model_config())
            if cap is not None:
                bad(f"draft_arch needs a speculation-capable target "
                    f"(failing capability: {cap}; global-attention dense "
                    f"decoder stacks only)")
        if self.offload is False:
            for name in ("quant", "kv_mode", "sim_bw", "depth", "warm",
                         "draft_arch", "spec_k", "sched", "prefill_chunk",
                         "stages", "stage_axis"):
                if getattr(self, name) is not None:
                    bad(f"{name} only applies to the offloaded engine "
                        f"(offload=False pins the resident ServingEngine)")
            if self.depth_policy != "static":
                bad("depth_policy only applies to the offloaded engine")
            if self.placement not in ("auto", "device"):
                bad(f"placement={self.placement!r} only applies to the "
                    f"offloaded engine")
        if self.depth_policy == "adaptive" and self.pipeline != "performance":
            bad("depth_policy='adaptive' needs the performance pipeline "
                "(other modes pin a single-layer window)")
        self.model_config()          # arch resolvable (raises SpecError)

    # ---- resolution ------------------------------------------------------
    def resolve(self, budget: Optional[MemoryBudget] = None,
                trace=None) -> "ResolvedPlan":
        """Materialize every auto field against ``budget`` (paper §3.5 /
        Eq. 1 via ``core.autoconfig``), recording each decision's why in
        the plan's provenance map.

        ``trace`` (a recorded ``core.tasks.Trace``, e.g. loaded with
        ``Trace.from_json``) switches depth resolution from the
        closed-form heuristic to the trace-replay simulator
        (``core.replay``): the memory model still sets the affordable
        cap, but WITHIN the cap the simulated-argmin depth wins and the
        provenance records ``replay`` as the source.  Explicit depths
        and non-performance pipelines ignore the trace; a trace that
        cannot be replayed keeps the heuristic depth, and the provenance
        says so.  A trace recorded from a staged run re-resolves
        ``(stages, depth)`` jointly (``core.replay.best_stage_depth``)."""
        from repro_torch.core.autoconfig import (choose_placement,
                                                 replay_depth_decision,
                                                 serving_depth_decision)
        self.validate()
        budget = budget or MemoryBudget()
        cfg = self.model_config()
        prov: Dict[str, str] = {}
        cap = offload_capability(cfg)

        # ---- engine + placement (capability gate, then Eq. 1) ----
        eq1: Dict[str, str] = {}

        def eq1_placement():
            if not eq1:
                pl, why = choose_placement(cfg, batch=self.b_max,
                                           seq=self.max_len,
                                           precision_bytes=4, budget=budget,
                                           quant=self.quant)
                eq1["placement"], eq1["why"] = pl, why
            return eq1["placement"], eq1["why"]

        if self.offload is False:
            engine = "resident"
            prov["engine"] = "explicit: offload=False (resident weights)"
        elif cap is not None:
            engine = "resident"
            detail = {"enc_dec": "encoder-decoder stack",
                      "embeds_frontend": "embeds frontend",
                      "no_rope": "non-rope positions"}[cap]
            if self.offload:
                prov["engine"] = (f"offload requested but unsupported "
                                  f"({cap}: {detail}); fell back to the "
                                  f"resident ServingEngine")
            else:
                prov["engine"] = (f"auto: offloading unsupported "
                                  f"({cap}: {detail}); resident")
        elif self.offload is True:
            engine = "offloaded"
            prov["engine"] = "explicit: offload=True"
        elif self.placement == "device":
            engine = "resident"
            prov["engine"] = "explicit: placement='device' (resident)"
        elif self.placement in ("host", "disk"):
            engine = "offloaded"
            prov["engine"] = (f"explicit placement={self.placement!r} "
                              f"implies the offloaded engine")
        else:
            pl, why = eq1_placement()
            engine = "resident" if pl == "device" else "offloaded"
            prov["engine"] = f"auto (Eq. 1): {why}"

        if engine == "resident":
            placement = "device"
            prov.setdefault("placement",
                            "resident engine: weights live on device")
        elif self.placement != "auto":
            placement = self.placement
            prov["placement"] = f"explicit: {self.placement}"
        else:
            pl, why = eq1_placement()
            if pl == "device":
                placement = "host"
                prov["placement"] = ("auto: weights would fit the device, "
                                     "but offloading was requested; host "
                                     "is the fastest streaming tier")
            else:
                placement = pl
                prov["placement"] = f"auto (Eq. 1): {why}"

        # ---- offload-only fields ----
        if engine == "resident":
            quant, warm, depth, depth_policy = None, False, 0, "static"
            kv_mode = None
            fused = True
            sim_bw = None
            draft_arch, spec_k = None, None
            sched, prefill_chunk = "monolithic", 0
            stages, stage_axis, stage_plan = 1, "layer", ()
            for name, was in (("quant", self.quant),
                              ("kv_mode", self.kv_mode),
                              ("sim_bw", self.sim_bw),
                              ("warm", self.warm),
                              ("depth", self.depth),
                              ("draft_arch", self.draft_arch),
                              ("spec_k", self.spec_k),
                              ("sched", self.sched),
                              ("prefill_chunk", self.prefill_chunk),
                              ("stages", self.stages),
                              ("stage_axis", self.stage_axis)):
                if was is not None:
                    prov[name] = (f"dropped ({was!r}): the resident engine "
                                  f"streams nothing over the link")
            if self.depth_policy != "static":
                prov["depth_policy"] = ("dropped ('adaptive'): no preload "
                                        "window on the resident engine")
            prov.setdefault("warm", "n/a: resident engine has no pipeline")
            prov.setdefault("depth", "n/a: resident engine has no window")
        else:
            quant = self.quant
            if self.kv_mode is None:
                kv_mode = "fp32"
                prov["kv_mode"] = ("auto: cache streams at compute "
                                   "precision (pass --kv-mode int4 for "
                                   "packed KV rows)")
            else:
                kv_mode = self.kv_mode
                prov["kv_mode"] = f"explicit: kv_mode={kv_mode!r}"
            if self.warm is None:
                warm = self.pipeline == "performance"
                prov["warm"] = (
                    "auto: performance pipeline keeps the scheduler warm "
                    "across decode steps (cross-step preload)"
                    if warm else
                    f"auto: {self.pipeline} pipeline has no cross-step "
                    f"preload")
            else:
                warm = bool(self.warm)
                prov["warm"] = f"explicit: warm={warm}"
            if self.depth is not None:
                depth = self.depth
                prov["depth"] = (f"explicit: depth={self.depth} (engines "
                                 f"clamp to their schedulable unit count)")
            elif self.pipeline != "performance":
                depth = 1
                prov["depth"] = (f"auto: {self.pipeline} pipeline pins a "
                                 f"single-layer window")
            else:
                d, why = serving_depth_decision(
                    cfg, b_max=self.b_max, max_len=self.max_len,
                    quant=quant, kv_mode=kv_mode,
                    spill_cap=self.spill_cap,
                    placement=placement, budget=budget)
                depth = d
                prov["depth"] = f"auto: {why}"
                if trace is not None:
                    # the memory model's fit is the cap; within it the
                    # simulated argmin from the recorded trace wins
                    from repro_torch.core.replay import ReplayError
                    try:
                        d, why = replay_depth_decision(
                            trace, depth_cap=max(1, d), quant=quant,
                            kv_mode=kv_mode, sim_bw=self.sim_bw)
                        depth = d
                        prov["depth"] = f"replay: {why}"
                    except ReplayError as e:
                        prov["depth"] += (f"; trace given but not "
                                          f"replayable ({e}), kept the "
                                          f"heuristic depth")
            depth_policy = self.depth_policy
            if depth_policy == "adaptive":
                prov["depth_policy"] = (
                    "adaptive: window re-sized between decode steps from "
                    "live KV/spill pressure (requests in flight, longest "
                    "position used, retained spills) via "
                    "memory_model.live_depth; the static fit above is the "
                    "initial depth")
            if quant != "int4":
                fused = True
                prov["fused_int4"] = "n/a: no INT4 streaming"
            elif self.fused_int4 is None:
                fused = self.b_max < 16
                prov["fused_int4"] = (
                    f"auto (§3.5): batch {self.b_max} "
                    f"{'<' if fused else '>='} 16 — "
                    f"{'fused dequant-matmul' if fused else 'dequant-first'}")
            else:
                fused = bool(self.fused_int4)
                prov["fused_int4"] = f"explicit: fused_int4={fused}"
            sim_bw = self.sim_bw
            draft_arch = self.draft_arch
            if draft_arch is None:
                spec_k = None
            else:
                prov["draft_arch"] = (
                    f"explicit: device-resident draft {draft_arch!r} "
                    f"proposes, the streamed target verifies k+1 positions "
                    f"in one ragged decode step")
                if self.spec_k is None:
                    spec_k = 4
                    prov["spec_k"] = ("auto: 4 proposals per verify pass "
                                      "(the acceptance-length sweet spot on "
                                      "weight-dominated links; see "
                                      "benchmarks serving_spec_decode)")
                else:
                    spec_k = int(self.spec_k)
                    prov["spec_k"] = f"explicit: spec_k={spec_k}"

            # ---- traffic scheduling policy ----
            sched = self.sched
            if sched is None:
                sched = "monolithic"
                prov["sched"] = ("auto: monolithic prefill (chunked "
                                 "admission is opt-in via --sched "
                                 "online|offline)")
            elif sched != "monolithic":
                ccap = chunked_prefill_capability(cfg)
                if ccap is not None:
                    prov["sched"] = (
                        f"dropped ({sched!r}): chunked prefill needs a "
                        f"dense global-attention stack (failing "
                        f"capability: {ccap}); monolithic")
                    sched = "monolithic"
                else:
                    prov["sched"] = f"explicit: sched={sched!r}"
            else:
                prov["sched"] = "explicit: sched='monolithic'"
            if sched == "online":
                if self.prefill_chunk is None:
                    prefill_chunk = 32
                    prov["prefill_chunk"] = (
                        "auto: 32 prompt tokens per engine step (bounds "
                        "the per-step decode stall; see docs/TUNING.md)")
                else:
                    prefill_chunk = int(self.prefill_chunk)
                    prov["prefill_chunk"] = (
                        f"explicit: {prefill_chunk} tokens/step")
            elif sched == "offline":
                if self.prefill_chunk is None:
                    prefill_chunk = self.max_len
                    prov["prefill_chunk"] = (
                        "auto: whole-prompt chunks (run-to-completion "
                        "throughput regime; chunks still share the decode "
                        "step's weight window)")
                else:
                    prefill_chunk = int(self.prefill_chunk)
                    prov["prefill_chunk"] = (
                        f"explicit: {prefill_chunk} tokens/step")
            else:
                prefill_chunk = 0
                if self.prefill_chunk is not None:
                    prov["prefill_chunk"] = (
                        f"dropped ({self.prefill_chunk}): monolithic "
                        f"prefill has no chunks")

            # ---- pipeline-parallel stages (StagePlan) ----
            stage_axis = self.stage_axis or "layer"
            if self.stage_axis is not None:
                prov["stage_axis"] = "explicit: stage_axis='layer'"
            n_units = (cfg.num_periods * len(cfg.pattern)
                       + len(cfg.remainder))
            dense_cap = _dense_global_attn_capability(cfg)
            stages = 1 if self.stages is None else max(1, int(self.stages))
            if stages > 1 and dense_cap is not None:
                prov["stages"] = (
                    f"dropped ({self.stages}): pipeline-parallel staging "
                    f"needs a dense global-attention decoder stack "
                    f"(failing capability: {dense_cap}); single stage")
                stages = 1
            elif stages > 1 and draft_arch is not None:
                prov["stages"] = (
                    f"dropped ({self.stages}): speculative verify runs the "
                    f"accept logic against one device-resident draft; "
                    f"per-stage speculation is future work — single stage")
                stages = 1
            elif stages > 1 and sched != "monolithic":
                prov["stages"] = (
                    f"dropped ({self.stages}): chunked admission "
                    f"({sched!r}) is not staged yet; single stage")
                stages = 1
            elif stages > 1:
                if stages > n_units:
                    prov["stages"] = (
                        f"explicit: {self.stages} clamped to the "
                        f"{n_units} schedulable units")
                    stages = n_units
                else:
                    prov["stages"] = (
                        f"explicit: {stages} contiguous layer ranges, one "
                        f"tiered weight/KV store + scheduler per stage "
                        f"(aggregate link bandwidth scales with stages)")
            elif self.stages is not None:
                prov["stages"] = "explicit: stages=1 (single-stage pipeline)"
            else:
                prov["stages"] = ("auto: single stage (pass --stages N to "
                                  "partition the stack across a mesh)")
            # joint (stages, depth) argmin: a trace RECORDED from a staged
            # run re-resolves both knobs through the simulator; a
            # single-stage trace keeps the replay-depth path above
            depth_src_replay = False
            if (trace is not None and self.stages is None
                    and int(trace.meta.get("stages") or 1) > 1
                    and self.depth is None
                    and self.pipeline == "performance"
                    and dense_cap is None and draft_arch is None
                    and sched == "monolithic"):
                from repro_torch.core.replay import (ReplayError,
                                                     best_stage_depth)
                try:
                    (sb, db), _ = best_stage_depth(
                        trace, stage_cap=min(4, n_units),
                        depth_cap=max(1, depth))
                    stages, depth = sb, db
                    depth_src_replay = True
                    prov["stages"] = (
                        f"replay: joint (stages, depth) argmin over the "
                        f"recorded staged trace -> {sb} stage(s)")
                    prov["depth"] = (
                        f"replay: depth {db} at {sb} stage(s) minimizes "
                        f"simulated steady-state step time")
                except ReplayError as e:
                    prov["stages"] += (f"; staged trace given but not "
                                       f"replayable ({e})")
            stage_plan = ()
            if stages > 1:
                if depth_policy == "adaptive":
                    depth_policy = "static"
                    prov["depth_policy"] = (
                        "dropped ('adaptive'): per-stage windows are "
                        "statically sized from the budget split "
                        "(adaptive staging is future work)")
                # accelerate-style max_memory-per-rank split: each stage
                # resolves its own §3.5 depth fit against 1/stages of the
                # device (and host) budget, so stage windows auto-size
                # independently of the global plan
                bounds = [round(s * n_units / stages)
                          for s in range(stages + 1)]
                dev_each = budget.device // stages
                sbud = MemoryBudget(device=dev_each,
                                    host=budget.host // stages)
                plans = []
                for s in range(stages):
                    lo, hi = bounds[s], bounds[s + 1]
                    if self.depth is not None:
                        sd, swhy = self.depth, (f"explicit: depth="
                                                f"{self.depth} every stage")
                    elif depth_src_replay:
                        sd, swhy = depth, (f"replay: joint argmin depth "
                                           f"{depth}")
                    else:
                        sd, swhy = serving_depth_decision(
                            cfg, b_max=self.b_max, max_len=self.max_len,
                            quant=quant, kv_mode=kv_mode,
                            spill_cap=self.spill_cap,
                            placement=placement, budget=sbud)
                        swhy = (f"stage {s} (§3.5 on the 1/{stages} "
                                f"budget split): {swhy}")
                    sd = max(1, min(int(sd), max(1, hi - lo - 1)))
                    plans.append(StagePlan(stage=s, layer_lo=lo,
                                           layer_hi=hi, depth=sd,
                                           device_budget=dev_each,
                                           why=swhy))
                stage_plan = tuple(plans)
                depth = max(p.depth for p in plans)
                prov["stage_plan"] = (
                    f"{n_units} units tiled contiguously over {stages} "
                    f"stages; device budget split {stages} x {dev_each} B "
                    f"(per-stage §3.5 depth fit)")
                if self.depth is None and not depth_src_replay:
                    prov["depth"] = (
                        f"auto: max per-stage fit {depth} (see stage_plan; "
                        f"each stage sized on its budget split)")

        # ---- resident-only fields ----
        if self.moe_quant is None:
            moe_quant = None
        elif engine == "resident":
            moe_quant = self.moe_quant
            prov["moe_quant"] = (
                "explicit: resident expert stacks packed INT4 once at "
                "load (~1/7 the f32 bytes incl. scales); compute unpacks "
                "through the fused-int4 path")
        else:
            moe_quant = None
            prov["moe_quant"] = (
                f"dropped ({self.moe_quant!r}): the offloaded engine "
                f"streams experts through the unit quant path (--quant)")

        if self.block_bytes is None:
            block_bytes = 8 << 20
            prov["block_bytes"] = ("auto: 8MiB blocks (Appendix A: disk "
                                   "bandwidth saturates at 8-32MiB)")
        else:
            block_bytes = int(self.block_bytes)
        disk_root = self.disk_root or "/tmp/pipo_serve_disk"
        if not self.disk_root:
            prov["disk_root"] = "auto: default /tmp/pipo_serve_disk"

        return ResolvedPlan(
            arch=self.arch, scaled=self.scaled, engine=engine,
            b_max=self.b_max, max_len=self.max_len, seed=self.seed,
            placement=placement, pipeline=self.pipeline, quant=quant,
            kv_mode=kv_mode, fused_int4=fused, moe_quant=moe_quant,
            warm=warm, depth=depth,
            depth_policy=depth_policy, spill_cap=self.spill_cap,
            cache_on=self.cache_on, disk_root=disk_root,
            block_bytes=block_bytes, n_io_threads=self.n_io_threads,
            cold_reads=self.cold_reads, sim_bw=sim_bw,
            draft_arch=draft_arch, spec_k=spec_k,
            sched=sched, prefill_chunk=prefill_chunk,
            stages=stages, stage_axis=stage_axis, stage_plan=stage_plan,
            device_budget=budget.device, host_budget=budget.host,
            provenance=prov, cfg=self.cfg)



# ---------------------------------------------------------------------------
# ResolvedPlan — materialized execution plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StagePlan:
    """One pipeline-parallel stage's slice of a resolved plan: the
    contiguous schedulable-unit range ``[layer_lo, layer_hi)`` it owns,
    the preload depth its OWN §3.5 fit resolved on its share of the
    split device budget, and the why string recording that decision.
    JSON round-trips inside ``ResolvedPlan.stage_plan`` (``asdict``
    nests it as a dict; ``ResolvedPlan.__post_init__`` rehydrates)."""

    stage: int
    layer_lo: int
    layer_hi: int
    depth: int
    device_budget: int
    why: str = ""


@dataclass(frozen=True)
class ResolvedPlan:
    """A fully-materialized engine plan: no Nones-meaning-auto left, and
    ``provenance[field]`` records why each auto field got its value.
    JSON round-trips (``to_json``/``from_json``); ``cfg`` (the ad-hoc
    config override) is excluded from JSON and equality, so a plan is
    file-shippable iff its arch is registry-resolvable."""

    arch: str
    scaled: bool
    engine: str                  # "resident" | "offloaded"
    b_max: int
    max_len: int
    seed: int
    placement: str               # device|host|disk
    pipeline: str
    quant: Optional[str]
    kv_mode: Optional[str]       # fp32|int4 streamed KV; None on resident
    fused_int4: bool
    moe_quant: Optional[str]     # int4-resident expert stacks; resident only
    warm: bool
    depth: int                   # 0 on the resident engine
    depth_policy: str
    spill_cap: int
    cache_on: str
    disk_root: str
    block_bytes: int
    n_io_threads: int
    cold_reads: bool
    sim_bw: Optional[float]
    draft_arch: Optional[str]    # device-resident draft; None = no speculation
    spec_k: Optional[int]        # proposals per verify pass; None = off
    sched: str = "monolithic"    # monolithic | online | offline
    prefill_chunk: int = 0       # prompt tokens per engine step; 0 = n/a
    stages: int = 1              # pipeline-parallel stage count
    stage_axis: str = "layer"    # the partition axis (layer stacks only)
    stage_plan: Tuple = ()       # per-stage StagePlan slices; () single-stage
    # the budget the plan was resolved under (bytes) — recorded so the
    # plan is auditable and so AdaptiveDepth re-sizes against the SAME
    # budget at run time
    device_budget: int = MemoryBudget.device
    host_budget: int = MemoryBudget.host
    provenance: Dict[str, str] = field(default_factory=dict)
    cfg: Optional[ModelConfig] = field(default=None, compare=False,
                                       repr=False)

    def __post_init__(self):
        # JSON round-trip rehydration: asdict() serialized each StagePlan
        # as a nested dict (and the tuple as a list) — normalize back so
        # equality and attribute access work on a from_json'd plan
        sp = tuple(StagePlan(**p) if isinstance(p, dict) else p
                   for p in self.stage_plan)
        object.__setattr__(self, "stage_plan", sp)

    def to_json(self) -> Dict[str, Any]:
        return _json_dict(self)

    @classmethod
    def from_json(cls, d: "Dict[str, Any] | str") -> "ResolvedPlan":
        return _from_json_dict(cls, d, require_all=True)

    def model_config(self) -> ModelConfig:
        return _registry_config(self.arch, self.scaled, self.cfg)

    def summary(self) -> str:
        return (f"{self.arch}{'(scaled)' if self.scaled else ''} "
                f"engine={self.engine} placement={self.placement} "
                f"pipeline={self.pipeline} warm={self.warm} "
                f"depth={self.depth}({self.depth_policy}) "
                f"quant={self.quant or 'fp32'} "
                f"kv={self.kv_mode or 'n/a'} b_max={self.b_max} "
                f"max_len={self.max_len}"
                + (f" draft={self.draft_arch} spec_k={self.spec_k}"
                   if self.draft_arch else "")
                + (f" sched={self.sched} chunk={self.prefill_chunk}"
                   if self.sched != "monolithic" else "")
                + (f" stages={self.stages}" if self.stages > 1 else ""))


# ---------------------------------------------------------------------------
# PreloadPolicy seam
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Pressure:
    """Live load snapshot the engine hands the preload policy between
    decode steps."""
    active: int                  # requests in flight (occupied slots)
    max_pos: int                 # longest KV position actually written
    spills: int = 0              # slot-spill namespaces retained on host
    # exact per-layer live KV_LOAD bytes (TieredKVStore.load_nbytes at
    # the live extent); None falls back to the modeled slab — with it the
    # adaptive window's KV pricing is measured, not modeled
    kv_layer_bytes: Optional[int] = None


class PreloadPolicy:
    """Decides the preload window.  ``max_depth()`` sizes the transfer
    pool at engine build time; ``depth(pressure)`` is consulted before
    every decode step (main thread; must be cheap)."""

    def max_depth(self) -> int:
        raise NotImplementedError

    def depth(self, pressure: Pressure) -> int:
        raise NotImplementedError


class StaticDepth(PreloadPolicy):
    """Today's behavior, bit for bit: a fixed window, whatever the
    load.  ``StaticDepth(plan.depth)`` reproduces the pre-spec engines
    exactly (token parity asserted per depth x quant in tests)."""

    def __init__(self, depth: int):
        self._depth = max(1, int(depth))

    def max_depth(self) -> int:
        return self._depth

    def depth(self, pressure: Pressure) -> int:
        return self._depth

    def __repr__(self):
        return f"StaticDepth({self._depth})"


class AdaptiveDepth(PreloadPolicy):
    """Re-sizes the window between decode steps from live KV/spill
    pressure.  Light load —
    few requests in flight, short contexts — leaves device headroom the
    static worst-case sizing can't see, so the window deepens; as
    requests and positions ramp (or spills pile onto the host) the same
    §3.5 capacity model shrinks it back, bottoming out at the paper's
    depth-1 pipeline.  The transfer pool is sized once for
    ``depth_cap``, so deepening never needs new threads.

    Measured-bandwidth feedback: the engine calls ``observe()``
    between decode steps with the step's Trace deltas — transfer bytes,
    merged transfer busy seconds, compute busy seconds, layer count.
    The policy EWMAs the observed link bandwidth and per-layer compute
    time; ``depth()`` then asks for only as much window as the OBSERVED
    link needs to hide behind compute (``ceil(t_link_layer /
    t_compute_layer)``), capped by the memory fit.  A link that slows
    mid-run (contention, thermal, page-cache miss streaks) deepens the
    window; a link faster than budgeted stops wasting residency on
    preloads compute never waits for.  Before any observation the policy
    resolves exactly as the memory model alone (the pre-feedback
    behavior)."""

    def __init__(self, cfg: ModelConfig, *, b_max: int, max_len: int,
                 quant: Optional[str] = None,
                 kv_mode: Optional[str] = None, placement: str = "host",
                 budget: Optional[MemoryBudget] = None, depth_cap: int = 8,
                 ewma_alpha: float = 0.5):
        self.cfg = cfg
        self.b_max = b_max
        self.max_len = max_len
        self.quant = quant
        self.kv_mode = kv_mode
        self.placement = placement
        self.budget = budget or MemoryBudget()
        self.depth_cap = max(1, int(depth_cap))
        self.ewma_alpha = float(ewma_alpha)
        # measured state (None until the first observation)
        self.bw_ewma: Optional[float] = None          # link bytes/s
        self.compute_ewma: Optional[float] = None     # s per layer
        # mean streamed bytes per layer (weights); the engine sets it at
        # build time from the real store manifests via set_link_profile
        self.layer_link_bytes: Optional[int] = None
        # the host-guard terms don't depend on live load — precompute
        # once; depth() runs on the main thread between decode steps
        self._host_fixed, self._per_spill = host_pinned_bytes(
            cfg, b_max=b_max, max_len=max_len, quant=quant,
            kv_mode=kv_mode, placement=placement)

    def max_depth(self) -> int:
        return self.depth_cap

    def set_link_profile(self, layer_link_bytes: int):
        """Mean streamed weight bytes per schedulable layer (engine
        build time, from the tiered store's manifests — packed bytes
        under INT4)."""
        self.layer_link_bytes = int(layer_link_bytes)

    def observe(self, *, transfer_bytes: int, transfer_busy_s: float,
                compute_busy_s: float, layers: int):
        """Fold one decode step's Trace deltas into the bandwidth /
        compute EWMAs (main thread, between steps; cheap)."""
        a = self.ewma_alpha
        if transfer_busy_s > 0 and transfer_bytes > 0:
            bw = transfer_bytes / transfer_busy_s
            self.bw_ewma = bw if self.bw_ewma is None else \
                a * bw + (1 - a) * self.bw_ewma
        if layers > 0 and compute_busy_s > 0:
            c = compute_busy_s / layers
            self.compute_ewma = c if self.compute_ewma is None else \
                a * c + (1 - a) * self.compute_ewma

    def _bw_depth(self, pressure: Pressure) -> Optional[int]:
        """Window the MEASURED link needs: with D transfers in flight the
        steady-state per-layer wait is ~t_link/D, hidden once D >=
        t_link / t_compute.  None until both EWMAs and the link profile
        exist."""
        if not (self.bw_ewma and self.compute_ewma
                and self.layer_link_bytes):
            return None
        per_layer = self.layer_link_bytes + (pressure.kv_layer_bytes or 0)
        t_link = per_layer / self.bw_ewma
        return max(1, math.ceil(t_link / max(1e-12, self.compute_ewma)))

    def depth(self, pressure: Pressure) -> int:
        d_mem = live_depth(self.cfg, active=pressure.active,
                           pos_used=pressure.max_pos, b_max=self.b_max,
                           max_len=self.max_len, quant=self.quant,
                           kv_mode=self.kv_mode, spills=pressure.spills,
                           placement=self.placement,
                           device_budget=self.budget.device,
                           host_budget=self.budget.host,
                           depth_cap=self.depth_cap,
                           host_fixed=self._host_fixed,
                           per_spill=self._per_spill,
                           kv_layer_bytes=pressure.kv_layer_bytes)
        d_bw = self._bw_depth(pressure)
        if d_bw is None:
            return d_mem
        return max(1, min(d_mem, d_bw))

    def __repr__(self):
        return (f"AdaptiveDepth(cap={self.depth_cap}, "
                f"quant={self.quant or 'fp32'}, "
                f"kv={self.kv_mode or 'fp32'}, "
                f"bw={'%.2e' % self.bw_ewma if self.bw_ewma else 'unmeasured'})")


def preload_policy_for(plan: ResolvedPlan,
                       cfg: Optional[ModelConfig] = None,
                       budget: Optional[MemoryBudget] = None
                       ) -> PreloadPolicy:
    """The plan's preload policy instance (engine build time).  The
    adaptive policy re-sizes against the budget the plan was resolved
    under (recorded on the plan), not whatever the defaults are now."""
    if plan.depth_policy == "adaptive":
        if budget is None:
            budget = MemoryBudget(device=plan.device_budget,
                                  host=plan.host_budget)
        return AdaptiveDepth(cfg or plan.model_config(), b_max=plan.b_max,
                             max_len=plan.max_len, quant=plan.quant,
                             kv_mode=plan.kv_mode,
                             placement=plan.placement, budget=budget)
    return StaticDepth(max(1, plan.depth))


# ---------------------------------------------------------------------------
# QuantPolicy seam
# ---------------------------------------------------------------------------


class QuantPolicy:
    """What lives or crosses the link quantized: ``weight_mode`` feeds
    ``TieredWeightStore``, ``prepare_unit`` packs a unit's tensors at
    build time, ``kv_mode`` feeds ``TieredKVStore``."""

    name = "none"
    weight_mode: Optional[str] = None

    def __init__(self, kv_mode: Optional[str] = "fp32"):
        self.kv_mode = kv_mode or "fp32"
        if self.kv_mode not in ("fp32", "int4"):
            raise SpecError(f"kv_mode {kv_mode!r} not in {KV_MODES}")

    def prepare_unit(self, tensors: Dict[str, Any], device="cpu"
                     ) -> Dict[str, Any]:
        return tensors


class WeightsInt4(QuantPolicy):
    """Paper §3.4: eligible 2-D projections stored as packed nibbles and
    groupwise scales (``transfer.quantize_unit``); only packed bytes
    cross the link."""

    name = "int4"
    weight_mode = "int4"

    def prepare_unit(self, tensors: Dict[str, Any], device="cpu"
                     ) -> Dict[str, Any]:
        from repro_torch.core.transfer import quantize_unit
        return quantize_unit(tensors, device=device)


def quant_policy_for(quant: Optional[str],
                     kv_mode: Optional[str] = "fp32") -> QuantPolicy:
    if quant == "int4":
        return WeightsInt4(kv_mode)
    if quant is None:
        return QuantPolicy(kv_mode)
    raise SpecError(f"quant {quant!r} not in {QUANT_MODES}")


# ---------------------------------------------------------------------------
# SchedPolicy seam
# ---------------------------------------------------------------------------


class SchedPolicy:
    """Traffic-scheduling seam: HOW a new request's prefill meets the
    streamed weight window.  The base policy is today's behavior bit for
    bit — a dedicated monolithic b=1 prefill pass at admission that
    blanks the warm window.  Chunking policies instead split the prompt
    into per-step chunks that ride the SAME ``generate`` call (and the
    same WEIGHT_LOADs) as the active batch's decode; ``chunk_cap()`` is
    the per-engine-step token budget a chunk may consume."""

    name = "monolithic"
    chunked = False

    def chunk_cap(self) -> int:
        """Prompt tokens a prefill chunk may take per engine step
        (0 = no chunking: monolithic prefill at admission)."""
        return 0

    def __repr__(self):
        return f"{type(self).__name__}()"


class _ChunkedPolicy(SchedPolicy):
    """A policy that splits prompts into chunks of at most ``chunk``
    tokens per engine step."""

    chunked = True

    def __init__(self, chunk: int):
        if chunk < 1:
            raise SpecError(f"prefill chunk must be >= 1, got {chunk}")
        self.chunk = int(chunk)

    def chunk_cap(self) -> int:
        return self.chunk

    def __repr__(self):
        return f"{type(self).__name__}(chunk={self.chunk})"


class OnlineSLO(_ChunkedPolicy):
    """Latency regime: admit eagerly (FIFO), cap prefill tokens per
    engine step so every step still advances the decode batch — the
    chunk's compute bounds the decode stall (TBT) and queued requests
    start streaming KV immediately instead of waiting for a window
    restart (TTFT)."""

    name = "online"


class OfflineThroughput(_ChunkedPolicy):
    """Throughput regime (the PipeMax batch case): run-to-completion
    admission with whole-prompt chunks — the entire prefill rides one
    decode step's weight window, so the streamed weights are amortized
    over the largest possible token count and tok/s tracks the
    steady-state decode rate."""

    name = "offline"


def sched_policy_for(plan: ResolvedPlan) -> SchedPolicy:
    """The plan's traffic-scheduling policy instance (engine build
    time), mirroring ``preload_policy_for``/``quant_policy_for``."""
    if plan.sched == "online":
        return OnlineSLO(plan.prefill_chunk or 32)
    if plan.sched == "offline":
        return OfflineThroughput(plan.prefill_chunk or plan.max_len)
    return SchedPolicy()


# ---------------------------------------------------------------------------
# Engine construction — the single path
# ---------------------------------------------------------------------------


def create_engine(plan: "ResolvedPlan | EngineSpec", device="cuda"):
    """The one serving-engine constructor: dispatches a resolved plan to
    ``ServingEngine`` (resident) or ``OffloadedServingEngine`` (streamed)
    on ``device`` (CUDA unless the caller asks for the CPU).  Accepts an
    unresolved ``EngineSpec`` (resolved against the default budget)."""
    if isinstance(plan, EngineSpec):
        plan = plan.resolve()
    if not isinstance(plan, ResolvedPlan):
        raise TypeError(f"create_engine takes a ResolvedPlan or an "
                        f"EngineSpec, got {type(plan).__name__}")
    if plan.engine == "offloaded":
        from repro_torch.serving.offload_engine import OffloadedServingEngine
        return OffloadedServingEngine(plan, device=device)
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(plan, device=device)


def build_lm(plan: "ResolvedPlan | EngineSpec", device="cuda"):
    """Batch-generation twin of ``create_engine``: a ``PipelinedLM``
    configured from the plan (``b_max`` is its batch) on ``device``.
    ``kv_mode='int4'`` with ``cache_on='device'`` is contradictory (a
    device-resident cache never crosses the link) and is rejected."""
    if isinstance(plan, EngineSpec):
        plan = plan.resolve()
    if plan.kv_mode == "int4" and plan.cache_on == "device":
        raise SpecError(
            "kv_mode='int4' streams the cache over the link; with "
            "cache_on='device' nothing crosses — drop kv_mode or use "
            "cache_on='host'")
    from repro_torch.core.engine import PipelinedLM
    return PipelinedLM(plan, device=device)


# ---------------------------------------------------------------------------
# CLI flag <-> spec field table (launch.serve generates argparse from it;
# the tests hold it, flag for flag, to the JAX package's)
# ---------------------------------------------------------------------------


_NO_CLI_DEFAULT = object()     # sentinel: CLI default == spec field default


@dataclass(frozen=True)
class FlagSpec:
    """One CLI flag bound to one EngineSpec field.  ``kind``:
    "value" (typed argument), "true" (store_true), "false"
    (store_false, e.g. --no-warm -> warm=False).  ``cli_default``
    applies when the flag is absent and no --spec-json base was given
    (where the CLI's historical default differs from the spec's)."""

    flag: str
    field: str
    kind: str = "value"
    type: Any = str
    choices: Optional[Tuple] = None
    cli_default: Any = _NO_CLI_DEFAULT
    metavar: Optional[str] = None
    help: str = ""


CLI_FLAGS: Tuple[FlagSpec, ...] = (
    FlagSpec("--arch", "arch", help="registry architecture id"),
    FlagSpec("--scaled", "scaled", kind="true",
             help="use the scaled-down smoke config"),
    FlagSpec("--b-max", "b_max", type=int,
             help="decode slot count (continuous-batching width)"),
    FlagSpec("--max-len", "max_len", type=int, cli_default=128,
             help="per-slot KV capacity"),
    FlagSpec("--seed", "seed", type=int, help="parameter init seed"),
    FlagSpec("--offload", "offload", kind="true", cli_default=False,
             help="stream weights from host/disk via the PIPO pipeline "
                  "instead of keeping them resident"),
    FlagSpec("--placement", "placement", choices=("auto", "host", "disk"),
             help="weight tier for --offload (auto: Eq. 1 memory model)"),
    FlagSpec("--pipeline", "pipeline", choices=PIPELINE_MODES,
             help="PIPO scheduling mode for --offload"),
    FlagSpec("--quant", "quant", choices=("int4",),
             help="stream weights as packed INT4 (--offload only); ~1/4 "
                  "the link bytes, dequant overlapped on the transfer "
                  "pool"),
    FlagSpec("--kv-mode", "kv_mode", choices=("fp32", "int4"),
             help="KV-cache streaming precision (--offload only): fp32 "
                  "ships cache rows at compute precision; int4 stores "
                  "and streams them group-quantized (~1/3 the bf16 "
                  "bytes after group scales, dequant fused into decode "
                  "compute — see docs/TUNING.md)"),
    FlagSpec("--moe-quant", "moe_quant", choices=("int4",),
             help="pack the resident engine's routed expert stacks as "
                  "INT4 once at load (~1/7 the f32 resident bytes incl. "
                  "scales); compute unpacks through the fused-int4 path "
                  "(MoE archs only — see docs/TUNING.md)"),
    FlagSpec("--no-warm", "warm", kind="false",
             help="disable cross-step preloading (cold per-step "
                  "pipeline, the pre-warm baseline)"),
    FlagSpec("--preload-depth", "depth", type=int, metavar="D",
             help="layers kept in flight beyond the computing one "
                  "(--offload, performance pipeline); default: sized "
                  "from the memory budget (see docs/TUNING.md)"),
    FlagSpec("--depth-policy", "depth_policy",
             choices=DEPTH_POLICIES,
             help="static: fixed window; adaptive: re-sized between "
                  "decode steps from live KV/spill pressure"),
    FlagSpec("--spill-cap", "spill_cap", type=int,
             help="LRU cap on retained slot spills (parked requests "
                  "pinned)"),
    FlagSpec("--sim-bw", "sim_bw", type=float,
             help="simulated link bandwidth floor in bytes/s "
                  "(deterministic transfer timing; see "
                  "docs/BENCHMARKS.md)"),
    FlagSpec("--draft-arch", "draft_arch",
             help="speculative decoding (--offload only): registry arch "
                  "of a fully device-resident draft model; the draft "
                  "proposes --spec-k tokens, the streamed target scores "
                  "all k+1 positions in ONE ragged decode step and "
                  "greedy accept/reject keeps the non-speculative token "
                  "stream bit-exact (see docs/TUNING.md)"),
    FlagSpec("--spec-k", "spec_k", type=int, metavar="K",
             help="draft proposals per verify pass (needs --draft-arch; "
                  "default 4 — the link amortization grows with the "
                  "acceptance length)"),
    FlagSpec("--sched", "sched",
             choices=("online", "offline", "monolithic"),
             help="prefill scheduling policy (--offload only): online "
                  "admits eagerly and caps prefill tokens per engine "
                  "step (--prefill-chunk) so chunks share the decode "
                  "step's weight window (bounded decode stall, low "
                  "TTFT); offline runs whole-prompt chunks for maximum "
                  "throughput; monolithic (default) is the dedicated "
                  "b=1 prefill pass (see docs/TUNING.md)"),
    FlagSpec("--prefill-chunk", "prefill_chunk", type=int, metavar="T",
             help="prompt tokens prefillable per engine step (needs "
                  "--sched online/offline; defaults: 32 under online, "
                  "whole prompt under offline)"),
    FlagSpec("--stages", "stages", type=int, metavar="N",
             help="pipeline-parallel stage count (--offload only): "
                  "partition the layer stack into N contiguous stages, "
                  "each with its OWN tiered weight/KV stores, transfer "
                  "pool and preload window sized on a 1/N budget split — "
                  "aggregate host->device bandwidth scales with N and "
                  "microbatched activations hand stage to stage (see "
                  "docs/TUNING.md)"),
)

# EngineSpec fields deliberately without a CLI flag (engine-internal or
# kwargs-only knobs; the parity check closes over this set)
NO_FLAG_FIELDS = frozenset({
    "fused_int4", "cache_on", "disk_root", "block_bytes", "n_io_threads",
    "cold_reads", "stage_axis", "cfg",
})

# launch.serve flags that are workload/IO, not spec fields
WORKLOAD_FLAGS = frozenset({"--requests", "--spec-json", "--plan-json",
                            "--help"})


def add_spec_args(parser) -> None:
    """Generate the spec half of an argparse CLI from ``CLI_FLAGS``.
    All defaults are SUPPRESS so ``spec_from_args`` can tell explicit
    flags from absent ones (explicit flags override a --spec-json
    base)."""
    import argparse
    for f in CLI_FLAGS:
        kw = dict(dest=f.field, default=argparse.SUPPRESS, help=f.help)
        if f.kind == "true":
            parser.add_argument(f.flag, action="store_true", **kw)
        elif f.kind == "false":
            parser.add_argument(f.flag, action="store_false", **kw)
        else:
            if f.choices is not None:
                kw["choices"] = f.choices
            if f.metavar is not None:
                kw["metavar"] = f.metavar
            parser.add_argument(f.flag, type=f.type, **kw)


def spec_from_args(args, base: Optional[EngineSpec] = None) -> EngineSpec:
    """Build an EngineSpec from parsed args: start from ``base`` (a
    --spec-json load) or from the spec defaults overlaid with the
    table's CLI defaults, then apply every explicitly-given flag."""
    if base is None:
        cli_defaults = {f.field: f.cli_default for f in CLI_FLAGS
                        if f.cli_default is not _NO_CLI_DEFAULT}
        base = EngineSpec(**cli_defaults)
    given = {f.field: getattr(args, f.field) for f in CLI_FLAGS
             if hasattr(args, f.field)}
    return dataclasses.replace(base, **given)
