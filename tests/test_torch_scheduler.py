"""The port's PipelineScheduler on its VirtualPool, driven with the fake
workload the golden trace fixtures were recorded from
(tools/make_trace_fixtures.py), must record the same Trace JSON as the
JAX package's scheduler."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from fake_model import COSTS, FakeModel  # noqa: E402
from fake_model import run_virtual as jax_run_virtual  # noqa: E402
from repro_torch.core.pipeline import (PipelineScheduler, ThreadPool,  # noqa: E402
                                       VirtualPool)
from repro_torch.core.tasks import Task, TaskType, Trace  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
_COST = {k.value: v for k, v in COSTS.items()}


def _port_run(mode, n_layers=3, iters=3, warm=False, calls=1, depth=1):
    model = FakeModel(n_layers)
    pool = VirtualPool(3, cost_fn=lambda t: _COST[t.kind.value])
    sched = PipelineScheduler(model.n, mode, pool=pool, trace=pool.trace,
                              warm=warm, depth=depth)
    outs = None
    for _ in range(calls):
        outs = sched.generate(model, lambda i: 0, iters)
    sched.shutdown()
    return model, pool.trace, outs


def _canon(d) -> dict:
    return json.loads(json.dumps(d, sort_keys=True))


@pytest.mark.parametrize("fixture,kwargs", [
    ("trace_warm_d1.json", dict(mode="performance", n_layers=3, iters=1,
                                warm=True, calls=3, depth=1)),
    ("trace_warm_d2.json", dict(mode="performance", n_layers=3, iters=4,
                                warm=True, calls=1, depth=2)),
])
def test_golden_fixture(fixture, kwargs):
    _, trace, _ = _port_run(**kwargs)
    golden = json.loads((FIXTURES / fixture).read_text())
    assert _canon(trace.to_json()) == golden


@pytest.mark.parametrize("mode,warm,depth,calls", [
    ("performance", False, 1, 1), ("performance", False, 3, 2),
    ("performance", True, 2, 3), ("memory", False, 1, 2),
    ("sequential", False, 1, 1), ("sequential", True, 4, 2)])
def test_trace_matches_reference_scheduler(mode, warm, depth, calls):
    kw = dict(mode=mode, n_layers=3, iters=2, warm=warm, calls=calls,
              depth=depth)
    jm, jtrace, jouts = jax_run_virtual(**kw)
    pm, ptrace, pouts = _port_run(**kw)
    assert _canon(ptrace.to_json()) == _canon(jtrace.to_json())
    assert pm.calls == jm.calls
    assert pouts == jouts
    assert ptrace.report() == jtrace.report()


def test_prime_drain_drop_sequence_matches_spec_fixture():
    """The speculative-step sequence (``prime_weights`` while a draft
    computes, one warm call, and on a rejected step ``drain_saves`` +
    ``drop_kv_preloads``) records trace_spec_d2.json, as
    tools/make_trace_fixtures.py drove the JAX scheduler."""
    model = FakeModel(3)
    pool = VirtualPool(3, cost_fn=lambda t: _COST[t.kind.value])
    sched = PipelineScheduler(model.n, "performance", pool=pool,
                              trace=pool.trace, warm=True, depth=2)
    primed = []
    for it in range(4):
        primed.append(sched.prime_weights(model))
        pool.run_on_main(Task(TaskType.COMPUTE, f"draft[{it}]", lambda: None))
        sched.generate(model, lambda i: 0, 1)
        if it == 2:
            sched.drain_saves()
            sched.drop_kv_preloads()
    sched.shutdown()
    golden = json.loads((FIXTURES / "trace_spec_d2.json").read_text())
    assert _canon(pool.trace.to_json()) == golden
    assert primed[0] == 2 and primed[1:] == [0, 0, 0]


def test_trace_json_roundtrip():
    _, trace, _ = _port_run("performance", warm=True, calls=2, depth=2)
    back = Trace.from_json(json.dumps(trace.to_json()))
    assert back.to_json() == trace.to_json()
    assert back.report() == trace.report()


def test_thread_pool_cpu_runs_the_workload():
    """The real 3-worker pool (no device streams on the CPU) runs the
    fake workload to the same outputs and task counts."""
    model = FakeModel(3)
    trace = Trace()
    sched = PipelineScheduler(model.n, "performance", trace=trace,
                              warm=True, depth=2,
                              device=torch.device("cpu"))
    assert isinstance(sched.pool, ThreadPool)
    outs = [sched.generate(model, lambda i: 0, 2) for _ in range(2)]
    sched.shutdown()
    assert outs == [[6, 6], [6, 6]]
    computes = [e for e in trace.events() if e.kind == "compute"]
    assert len(computes) == 2 * 2 * model.n
    assert all(e.t_end >= e.t_start for e in trace.events())


def test_task_sync_runs_inside_the_timed_interval():
    """A task's ``sync`` (the device-stream synchronize on a card) runs
    before ``t_end`` is stamped and before waiters wake."""
    seen = []
    t = Task(TaskType.WEIGHT_LOAD, "w[0]", lambda: seen.append("fn") or 7)
    t.run(sync=lambda: seen.append("sync"))
    assert seen == ["fn", "sync"] and t.wait() == 7
    err = Task(TaskType.KV_LOAD, "kv", lambda: 1)
    err.run(sync=lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        err.wait()
