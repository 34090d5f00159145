"""The port's trace replay (``core/replay.py``), ``StagedScheduler`` and
``resolve(trace=...)`` against the JAX package's, on the CPU.

  * the five golden fixtures load into the port's ``Trace`` and replay
    to the same event multiset as the JAX replayer; those the JAX tests
    replay bit for bit against the recording do so in the port too;
  * ``best_depth``/``best_stage_depth``, ``replay_depth_decision`` and a
    set of what-if knobs give the JAX package's numbers on the fixtures;
  * ``StagedScheduler`` on virtual pools records the JAX package's trace
    on the ``tests/test_pipeline_pp.py`` workloads;
  * ``EngineSpec.resolve(trace=...)`` gives the JAX package's plan JSON
    for single-stage, staged and unreplayable traces.

Everything runs on virtual clocks, so every comparison is exact equality
(tolerance 0)."""
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from fake_model import COSTS, FakeModel, stage_split  # noqa: E402
from fake_model import run_virtual as jax_run_virtual  # noqa: E402
from fake_model import run_virtual_pp as jax_run_virtual_pp  # noqa: E402
from repro.core import autoconfig as JA  # noqa: E402
from repro.core import replay as JR  # noqa: E402
from repro.core.tasks import Trace as JTrace  # noqa: E402
from repro.serving import spec as JS  # noqa: E402
from repro_torch.core import autoconfig as PA  # noqa: E402
from repro_torch.core import replay as PR  # noqa: E402
from repro_torch.core.pipeline import (PipelineScheduler,  # noqa: E402
                                       StagedScheduler, VirtualPool)
from repro_torch.core.tasks import Trace, VirtualClock  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
NAMES = ["trace_warm_d1.json", "trace_warm_d2.json", "trace_spec_d2.json",
         "trace_traffic_d1.json", "trace_pp_s2.json"]
# the fixtures whose replay at the recorded knobs IS the recording (the
# JAX tests hold three; the traffic recording replays exactly as well,
# its composite activations being opaque to the scheduler).  The
# speculative one folds its draft events out and so replays faster.
AS_RECORDED = ["trace_warm_d1.json", "trace_warm_d2.json",
               "trace_traffic_d1.json", "trace_pp_s2.json"]
_COST = {k.value: v for k, v in COSTS.items()}


def _load(name):
    text = (FIXTURES / name).read_text()
    return Trace.from_json(text), JTrace.from_json(text)


def _key(e):
    return (e.kind, e.name, e.t_start, e.t_end, e.nbytes, e.extent, e.stage)


def _multiset(trace):
    return sorted(map(_key, trace.events()))


def _canon(d):
    return json.loads(json.dumps(d, sort_keys=True))


# ---------------------------------------------------------------------------
# golden fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_fixture_replays_as_the_reference(name):
    pt, jt = _load(name)
    pres, jres = PR.replay(pt), JR.replay(jt)
    assert _multiset(pres.trace) == _multiset(jres.trace)
    assert pres.step_times_s == jres.step_times_s
    assert pres.steady_step_s == jres.steady_step_s
    assert pres.span_s == jres.span_s
    assert pres.bytes_by_kind == jres.bytes_by_kind
    assert pres.report == jres.report
    assert PR.step_times(pt) == JR.step_times(jt)
    assert PR.step_boundaries(pt) == JR.step_boundaries(jt)
    assert PR.steady_step_s(pt) == JR.steady_step_s(jt)
    assert pres.trace.meta["replayed"] is True
    if name in AS_RECORDED:
        assert _multiset(pres.trace) == _multiset(pt)
    else:
        assert pres.steady_step_s < PR.steady_step_s(pt)
        assert not any(e.name.startswith("draft")
                       for e in pres.trace.events())


@pytest.mark.parametrize("name", NAMES)
def test_best_depth_matches_reference(name):
    pt, jt = _load(name)
    assert PR.best_depth(pt, depth_cap=4) == JR.best_depth(jt, depth_cap=4)
    knobs = dict(quant="int4", kv_mode="int4", sim_bw=250.0)
    assert (PR.best_depth(pt, depth_cap=3, knobs=PR.ReplayKnobs(**knobs))
            == JR.best_depth(jt, depth_cap=3, knobs=JR.ReplayKnobs(**knobs)))
    assert (PA.replay_depth_decision(pt, depth_cap=3, quant="int4")
            == JA.replay_depth_decision(jt, depth_cap=3, quant="int4"))


@pytest.mark.parametrize("name", NAMES)
def test_best_stage_depth_matches_reference(name):
    pt, jt = _load(name)
    assert (PR.best_stage_depth(pt, stage_cap=3, depth_cap=2)
            == JR.best_stage_depth(jt, stage_cap=3, depth_cap=2))


_KNOBS = [dict(depth=3), dict(mode="sequential"), dict(mode="memory"),
          dict(warm=False), dict(pool_size=1), dict(sim_bw=200.0),
          dict(quant="int4"), dict(kv_mode="int4"), dict(stages=2),
          dict(stages=1), dict(depth=2, stages=3, kv_mode="int4")]


@pytest.mark.parametrize("knobs", _KNOBS, ids=lambda k: json.dumps(k))
@pytest.mark.parametrize("name", ["trace_warm_d2.json", "trace_pp_s2.json"])
def test_what_if_knobs_match_reference(name, knobs):
    pt, jt = _load(name)
    pres = PR.replay(pt, PR.ReplayKnobs(**knobs))
    jres = JR.replay(jt, JR.ReplayKnobs(**knobs))
    assert _multiset(pres.trace) == _multiset(jres.trace)
    assert pres.step_times_s == jres.step_times_s
    assert pres.bytes_by_kind == jres.bytes_by_kind
    assert _canon(pres.trace.meta) == _canon(jres.trace.meta)


def test_iteration_window_and_errors_match_reference():
    pt, jt = _load("trace_warm_d1.json")
    pres = PR.replay(pt, start_iter=1)
    assert pres.step_times_s == JR.replay(jt, start_iter=1).step_times_s
    assert pres.profile.calls == [1, 1]
    with pytest.raises(PR.ReplayError, match="iteration window"):
        PR.replay(pt, start_iter=99)
    with pytest.raises(PR.ReplayError, match="no scheduler compute"):
        PR.replay(Trace())


def test_replay_of_replay_is_a_fixed_point():
    pt, _ = _load("trace_spec_d2.json")
    res = PR.replay(pt)
    assert PR.replay(res.trace).step_times_s == res.step_times_s


# ---------------------------------------------------------------------------
# StagedScheduler on the test_pipeline_pp.py workloads
# ---------------------------------------------------------------------------


def _port_run_pp(n_layers=3, stages=2, iters=4, warm=False, calls=1,
                 depth=1, mode="performance"):
    model = FakeModel(n_layers)
    trace = Trace(clock=VirtualClock())
    pools = [VirtualPool(3, trace=trace, cost_fn=lambda t: _COST[t.kind.value],
                         clock=VirtualClock()) for _ in range(stages)]
    sched = StagedScheduler(stage_split(model.n, stages), mode, pools=pools,
                            trace=trace, warm=warm, depths=[depth] * stages)
    outs = None
    for _ in range(calls):
        outs = sched.generate(model, lambda i: 0, iters)
    sched.shutdown()
    return model, trace, outs


@pytest.mark.parametrize("mode", ["performance", "memory"])
@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("warm", [False, True])
def test_staged_trace_matches_reference(mode, stages, depth, warm):
    kw = dict(n_layers=4, stages=stages, iters=4, warm=warm, calls=2,
              depth=depth, mode=mode)
    jm, jtrace, jouts = jax_run_virtual_pp(**kw)
    pm, ptrace, pouts = _port_run_pp(**kw)
    assert _canon(ptrace.to_json()) == _canon(jtrace.to_json())
    assert pm.calls == jm.calls
    assert pouts == jouts
    assert ptrace.report() == jtrace.report()
    # staging changes the schedule, not the outputs
    _, _, single = jax_run_virtual(mode, n_layers=4, iters=4, warm=warm,
                                   calls=2, depth=depth)
    assert pouts == single


def test_staged_fixture_recorded_by_port():
    """tools/make_trace_fixtures.py's "pp" case, driven through the port's
    StagedScheduler, records trace_pp_s2.json."""
    _, trace, _ = _port_run_pp(n_layers=3, stages=2, iters=4, depth=1)
    golden = json.loads((FIXTURES / "trace_pp_s2.json").read_text())
    assert _canon(trace.to_json()) == golden


def test_staged_maintenance_fans_out():
    model = FakeModel(4)
    sched = StagedScheduler(stage_split(model.n, 2), "performance",
                            pools=[VirtualPool(3) for _ in range(2)],
                            warm=True, depths=[1, 2])
    assert sched.depths == [1, 2] and sched.depth == 2
    assert sched.prime_weights(model) == 3
    assert sched.set_depth(3) == 3
    assert sched.trace.meta["stage_depths"] == [3, 3]
    sched.generate(model, lambda i: 0, 2)
    sched.drain_saves()
    sched.drop_kv_preloads()
    sched.shutdown()
    with pytest.raises(ValueError, match="contiguously"):
        StagedScheduler([(0, 2), (3, 4)])


def test_single_stage_names_unchanged_by_unit_base():
    """A stage's scheduler names its tasks by global unit; stage 0 of one
    stage is the plain scheduler, task for task."""
    model = FakeModel(3)
    pool = VirtualPool(3, cost_fn=lambda t: _COST[t.kind.value])
    sched = PipelineScheduler(model.n, "performance", pool=pool,
                              trace=pool.trace, warm=True, depth=2,
                              stage=0, unit_base=0)
    sched.generate(model, lambda i: 0, 3)
    sched.shutdown()
    _, jtrace, _ = jax_run_virtual("performance", iters=3, warm=True,
                                   depth=2)
    assert _canon(pool.trace.to_json()) == _canon(jtrace.to_json())


# ---------------------------------------------------------------------------
# EngineSpec.resolve(trace=...)
# ---------------------------------------------------------------------------

_SPECS = [dict(offload=True, b_max=2, max_len=64),
          dict(offload=True, b_max=2, max_len=64, quant="int4",
               kv_mode="int4"),
          dict(offload=True, b_max=2, max_len=64, depth=2),
          dict(offload=True, b_max=2, max_len=64, pipeline="sequential"),
          dict(offload=True, b_max=2, max_len=64, sched="online"),
          dict(offload=True, b_max=2, max_len=64, sim_bw=1e9)]


@pytest.mark.parametrize("spec", _SPECS, ids=lambda s: json.dumps(s))
@pytest.mark.parametrize("name", NAMES + [None])
def test_resolve_trace_plan_matches_reference(name, spec):
    if name is None:                       # no events: not replayable
        pt, jt = Trace(), JTrace()
    else:
        pt, jt = _load(name)
    kw = dict(arch="tinyllama-1.1b", scaled=True, **spec)
    pplan = PS.EngineSpec(**kw).resolve(trace=pt)
    jplan = JS.EngineSpec(**kw).resolve(trace=jt)
    assert pplan.to_json() == jplan.to_json()
    if name is None and "depth" not in spec and "pipeline" not in spec:
        assert "not replayable" in pplan.provenance["depth"]


def test_resolve_staged_trace_is_joint():
    pt, jt = _load("trace_pp_s2.json")
    kw = dict(arch="llama3.1-8b", quant="int4")
    pplan = PS.EngineSpec(**kw).resolve(trace=pt)
    assert pplan.to_json() == JS.EngineSpec(**kw).resolve(
        trace=jt).to_json()
    assert pplan.stages > 1
    assert "joint (stages, depth)" in pplan.provenance["stages"]
    assert pplan.provenance["depth"].startswith("replay:")
    assert all(p.why.startswith("replay:") for p in pplan.stage_plan)


def test_resolve_trace_picks_measured_best_static_depth():
    """The port's resolve picks the depth that measures fastest when the
    same fake workload is re-run at every depth the memory model allows,
    as the JAX test does."""
    _, rec, _ = jax_run_virtual("performance", n_layers=3, iters=6,
                                warm=True, calls=1, depth=1)
    spec = PS.EngineSpec(arch="tinyllama-1.1b", scaled=True, offload=True,
                         b_max=2, max_len=64)
    cap = spec.resolve().depth
    measured = {}
    for d in range(1, cap + 1):
        model = FakeModel(3)
        pool = VirtualPool(PipelineScheduler.pool_size(d),
                           cost_fn=lambda t: _COST[t.kind.value])
        sched = PipelineScheduler(model.n, "performance", pool=pool,
                                  trace=pool.trace, warm=True, depth=d)
        sched.generate(model, lambda i: 0, 6)
        sched.shutdown()
        measured[d] = PR.steady_step_s(pool.trace)
    plan = spec.resolve(trace=Trace.from_json(json.dumps(rec.to_json())))
    assert plan.depth == min(measured, key=lambda d: (measured[d], d))
    assert "source=replay" in plan.provenance["depth"]


def test_trace_bytes_moved_matches_reference():
    pt, jt = _load("trace_warm_d2.json")
    for kind in ("weight_load", "kv_load", "kv_save", "compute"):
        assert pt.bytes_moved(kind) == jt.bytes_moved(kind)
        assert pt.bytes_moved(kind, "w[1") == jt.bytes_moved(kind, "w[1")
    assert pt.bytes_moved("weight_load") > 0


def test_replay_knobs_are_the_reference_fields():
    assert ([f.name for f in dataclasses.fields(PR.ReplayKnobs)]
            == [f.name for f in dataclasses.fields(JR.ReplayKnobs)])
    assert PR.__all__ == JR.__all__
