"""The port's plan layer against the JAX package's, on the CPU: for all 19
registry architectures, full size and ``scaled``, across a grid of specs
and memory budgets, ``EngineSpec.resolve().to_json()`` is equal in both
packages (provenance strings included), the same invalid specs raise
``SpecError`` with the same message, the memory-model and autoconfig
functions give equal values, the CLI table parses the same argv into the
same spec, and ``launch.serve --plan-json`` prints the same JSON.  Pure
Python: no model is built.  Tolerance: exact equality throughout."""
import dataclasses
import itertools
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import REGISTRY as JREG  # noqa: E402
from repro.core import autoconfig as JA  # noqa: E402
from repro.core import memory_model as JM  # noqa: E402
from repro.core.offload import MemoryBudget as JBudget  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import spec as JS  # noqa: E402
from repro_torch.configs.registry import REGISTRY as PREG  # noqa: E402
from repro_torch.core import autoconfig as PA  # noqa: E402
from repro_torch.core import memory_model as PM  # noqa: E402
from repro_torch.core.offload import MemoryBudget as PBudget  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402

ARCHS = sorted(JREG)
GRID = [
    {}, {"offload": True}, {"offload": False},
    {"offload": True, "quant": "int4"},
    {"offload": True, "quant": "int4", "kv_mode": "int4"},
    {"offload": True, "kv_mode": "fp32", "warm": False},
    {"placement": "host", "quant": "int4"}, {"placement": "disk"},
    {"placement": "device"}, {"quant": "int4"},
    {"offload": True, "pipeline": "memory"},
    {"offload": True, "pipeline": "sequential", "warm": True},
    {"offload": True, "depth": 3}, {"offload": True, "depth": 40},
    {"offload": True, "depth_policy": "adaptive"},
    {"offload": True, "quant": "int4", "depth_policy": "adaptive",
     "kv_mode": "int4", "max_len": 128},
    {"offload": True, "sched": "online"},
    {"offload": True, "sched": "offline", "prefill_chunk": 16},
    {"offload": True, "sched": "monolithic"},
    {"offload": True, "stages": 1}, {"offload": True, "stages": 2},
    {"offload": True, "stages": 3, "depth_policy": "adaptive"},
    {"offload": True, "stages": 2, "sched": "online"},
    {"offload": True, "stages": 2, "depth": 2}, {"offload": True,
                                                 "stages": 200},
    {"offload": True, "stages": 2, "draft_arch": "tinyllama-1.1b"},
    {"offload": True, "draft_arch": "llama3.2-1b"},
    {"offload": True, "draft_arch": "tinyllama-1.1b", "spec_k": 2},
    {"offload": True, "stage_axis": "layer"},
    {"b_max": 32, "offload": True, "quant": "int4"},
    {"offload": True, "quant": "int4", "fused_int4": False},
    {"moe_quant": "int4"}, {"moe_quant": "int4", "offload": True},
    {"b_max": 16, "max_len": 4096}, {"b_max": 1, "max_len": 2},
    {"offload": True, "spill_cap": 0, "block_bytes": 1 << 20,
     "sim_bw": 1e9, "disk_root": "/x", "n_io_threads": 1,
     "cold_reads": True, "cache_on": "device", "seed": 3},
    # invalid: both packages raise SpecError with one message
    {"offload": False, "quant": "int4"}, {"spec_k": 2}, {"depth": 0},
    {"quant": "int8"}, {"kv_mode": "int8"}, {"placement": "tape"},
    {"pipeline": "eager"}, {"offload": False, "depth_policy": "adaptive"},
    {"depth_policy": "adaptive", "pipeline": "memory"},
    {"offload": False, "placement": "host"}, {"prefill_chunk": 8},
    {"sched": "batch"}, {"stages": 0}, {"stage_axis": "head"},
    {"b_max": 0}, {"max_len": 1}, {"spill_cap": -1}, {"n_io_threads": 0},
    {"block_bytes": 100}, {"sim_bw": 0.0}, {"cache_on": "disk"},
    {"depth_policy": "greedy"}, {"arch": "no-such-arch"},
]
BUDGETS = [None, (6 << 30, 16 << 30), (80 << 30, 96 << 30),
           (1 << 30, 2 << 30), (64 << 20, 1 << 30)]


def _resolve(S, E, B, arch, scaled, kw, budget):
    kw = dict(kw)
    arch = kw.pop("arch", arch)
    try:
        return S.EngineSpec(arch=arch, scaled=scaled, **kw).resolve(
            None if budget is None else B(device=budget[0], host=budget[1])
        ).to_json()
    except E as e:
        return ("SpecError", str(e))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_matches_reference(arch, scaled):
    """Every spec of the grid under every budget: the same plan JSON
    (provenance included) or the same ``SpecError``."""
    errors = 0
    for kw, budget in itertools.product(GRID, BUDGETS):
        want = _resolve(JS, JS.SpecError, JBudget, arch, scaled, kw, budget)
        got = _resolve(PS, PS.SpecError, PBudget, arch, scaled, kw, budget)
        assert got == want, (kw, budget)
        errors += isinstance(want, tuple)
    assert 0 < errors < len(GRID) * len(BUDGETS)


def test_registry_matches_reference():
    assert sorted(PREG) == sorted(JREG) and len(PREG) == 19
    for name in JREG:
        assert dataclasses.asdict(PREG[name]) == dataclasses.asdict(
            JREG[name]), name


def test_headline_plans():
    """The system's default plan and the paper's Llama-3.1-8B INT4 plan
    on the default (6 GiB device, 16 GiB host) budget."""
    tiny = PS.EngineSpec(arch="tinyllama-1.1b").resolve()
    assert tiny.engine == "resident"
    assert tiny.provenance["engine"] == "auto (Eq. 1): W+M=4.7GiB fits device"
    big = PS.EngineSpec(arch="llama3.1-8b", quant="int4").resolve()
    assert (big.engine, big.placement, big.depth, big.quant, big.kv_mode) \
        == ("offloaded", "host", 8, "int4", "fp32")
    assert big.provenance["placement"] == "auto (Eq. 1): W+C=4.0GiB fits host"
    assert "(2521MiB) affords 8 in-flight layer(s) at 92.0MiB each" \
        in big.provenance["depth"]
    for plan, jplan in ((tiny, JS.EngineSpec(arch="tinyllama-1.1b")),
                        (big, JS.EngineSpec(arch="llama3.1-8b",
                                            quant="int4"))):
        assert plan.summary() == jplan.resolve().summary()


def test_plan_and_spec_json_roundtrip():
    for spec in (PS.EngineSpec(arch="llama3.1-8b", quant="int4"),
                 PS.EngineSpec(arch="qwen3-8b", scaled=True, offload=True,
                               stages=2)):
        plan = spec.resolve()
        assert PS.ResolvedPlan.from_json(json.dumps(plan.to_json())) == plan
        assert PS.EngineSpec.from_json(spec.to_json()) == spec
        assert spec.to_json() == JS.EngineSpec(**spec.to_json()).to_json()
    with pytest.raises(PS.SpecError):
        PS.ResolvedPlan.from_json({**plan.to_json(), "bogus": 1})
    with pytest.raises(PS.SpecError):
        PS.EngineSpec.from_json({"bogus": 1})
    # cfg is excluded from JSON and equality
    cfg = PREG["tinyllama-1.1b"]
    assert PS.EngineSpec(cfg=cfg) == PS.EngineSpec()
    assert "cfg" not in PS.EngineSpec(cfg=cfg).to_json()


def test_capability_gates_match_reference():
    for name in JREG:
        for fn in ("offload_capability", "spec_decode_capability",
                   "chunked_prefill_capability"):
            assert getattr(PS, fn)(PREG[name]) == getattr(JS, fn)(
                JREG[name]), (name, fn)


def test_trace_replay_waits_for_its_slice():
    """A trace switches depth resolution to the replay simulator, which
    the port does not have yet: it raises, naming the slice; where the
    JAX package ignores the trace (an explicit depth), so does the
    port."""
    with pytest.raises(NotImplementedError, match="replay"):
        PS.EngineSpec(offload=True).resolve(trace=object())
    spec = PS.EngineSpec(offload=True, depth=2)
    assert spec.resolve(trace=object()) == spec.resolve()


_MM_KW = [dict(batch=1, seq=8), dict(batch=4, seq=256),
          dict(batch=16, seq=4096)]


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_model_matches_reference(arch):
    jc, pc = JREG[arch], PREG[arch]
    assert pc.param_count() == jc.param_count()
    assert pc.param_count(True) == jc.param_count(True)
    assert pc.kv_bytes_per_token_layer() == jc.kv_bytes_per_token_layer()
    assert pc.attn_layer_indices() == jc.attn_layer_indices()
    for p in (2, 4):
        assert PM.weight_sizes(pc, p) == JM.weight_sizes(jc, p)
        for q in (None, "int4"):
            assert PM.quant_weight_ratio(p, q) == JM.quant_weight_ratio(p, q)
            assert PM.quant_kv_ratio(p, q) == JM.quant_kv_ratio(p, q)
    for kw, p, pre in itertools.product(_MM_KW, (2, 4), (False, 1, 8)):
        assert dataclasses.asdict(PM.estimate(pc, p=p, preload=pre, **kw)) \
            == dataclasses.asdict(JM.estimate(jc, p=p, preload=pre, **kw))
    for kw, q, kv, budget in itertools.product(
            _MM_KW, (None, "int4"), (None, "int4"),
            (1 << 30, 6 << 30, 80 << 30)):
        assert PM.depth_capacity(pc, budget_bytes=budget, quant=q,
                                 kv_mode=kv, **kw) == \
            JM.depth_capacity(jc, budget_bytes=budget, quant=q,
                              kv_mode=kv, **kw)
        hk = dict(b_max=kw["batch"], max_len=kw["seq"], quant=q, kv_mode=kv)
        for placement in ("host", "disk"):
            assert PM.host_pinned_bytes(pc, placement=placement, **hk) == \
                JM.host_pinned_bytes(jc, placement=placement, **hk)
        for active, pos, spills in ((1, 0, 0), (kw["batch"], kw["seq"], 3)):
            lk = dict(active=active, pos_used=pos, spills=spills,
                      device_budget=budget, host_budget=16 << 30, **hk)
            assert PM.live_depth(pc, **lk) == JM.live_depth(jc, **lk)
            assert PM.live_depth(pc, kv_layer_bytes=1 << 20, **lk) == \
                JM.live_depth(jc, kv_layer_bytes=1 << 20, **lk)


@pytest.mark.parametrize("arch", ARCHS)
def test_autoconfig_matches_reference(arch):
    jc, pc = JREG[arch], PREG[arch]
    for (b, s), q, budget in itertools.product(
            ((1, 64), (4, 256), (32, 2048)), (None, "int4"),
            ((6 << 30, 16 << 30), (80 << 30, 96 << 30), (1 << 30, 1 << 30))):
        jb, pb = JBudget(*budget), PBudget(*budget)
        assert PA.choose_placement(pc, batch=b, seq=s, budget=pb, quant=q) \
            == JA.choose_placement(jc, batch=b, seq=s, budget=jb, quant=q)
        got = PA.configure(pc, batch=b, prompt_len=s // 2, gen_len=s // 2,
                           budget=pb, quant=q)
        want = JA.configure(jc, batch=b, prompt_len=s // 2, gen_len=s // 2,
                            budget=jb, quant=q)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for kv, cap in ((None, 32), ("int4", 0)):
            kw = dict(b_max=b, max_len=s, quant=q, kv_mode=kv,
                      spill_cap=cap)
            assert PA.serving_depth_decision(pc, budget=pb, **kw) == \
                JA.serving_depth_decision(jc, budget=jb, **kw)
            assert PA.serving_preload_depth(pc, budget=pb, **kw) == \
                JA.serving_preload_depth(jc, budget=jb, **kw)


ARGVS = [
    [],
    ["--arch", "llama3.1-8b", "--quant", "int4", "--offload"],
    ["--arch", "llama3.2-1b", "--offload", "--quant", "int4", "--kv-mode",
     "int4", "--depth-policy", "adaptive", "--requests", "8"],
    ["--scaled", "--offload", "--placement", "disk", "--pipeline",
     "memory", "--no-warm", "--b-max", "2", "--max-len", "64"],
    ["--scaled", "--offload", "--preload-depth", "3", "--spill-cap", "4",
     "--sim-bw", "2e9", "--seed", "7"],
    ["--arch", "tinyllama-1.1b", "--offload", "--draft-arch",
     "tinyllama-1.1b", "--spec-k", "3"],
    ["--scaled", "--offload", "--sched", "online", "--prefill-chunk", "4",
     "--stages", "2"],
    ["--arch", "mixtral-8x7b", "--scaled", "--moe-quant", "int4"],
    ["--arch", "whisper-base", "--offload"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_cli_builds_the_same_spec_and_plan(argv, capsys):
    """The same argv parses into the same spec in both packages, and
    ``--plan-json -`` prints the same plan."""
    jargs = jserve.build_parser().parse_args(argv)
    pargs = pserve.build_parser().parse_args(argv)
    assert PS.spec_from_args(pargs).to_json() == \
        JS.spec_from_args(jargs).to_json()
    jserve.main(argv + ["--plan-json", "-"])
    want = capsys.readouterr().out
    assert pserve.main(argv + ["--plan-json", "-"]) is None
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["arch"]


def test_cli_flag_table_matches_reference():
    def rows(S):
        return [dataclasses.astuple(dataclasses.replace(
            f, cli_default="spec default" if f.cli_default is
            S._NO_CLI_DEFAULT else f.cli_default)) for f in S.CLI_FLAGS]
    assert rows(PS) == rows(JS)
    assert PS.NO_FLAG_FIELDS == JS.NO_FLAG_FIELDS
    fields = {f.name for f in dataclasses.fields(PS.EngineSpec)}
    assert {f.field for f in PS.CLI_FLAGS} | PS.NO_FLAG_FIELDS == fields


def test_cli_spec_json_base_and_errors(tmp_path, capsys):
    base = tmp_path / "spec.json"
    base.write_text(json.dumps(PS.EngineSpec(
        arch="llama3.2-1b", offload=True, quant="int4").to_json()))
    argv = ["--spec-json", str(base), "--kv-mode", "int4", "--plan-json"]
    jserve.main(argv)
    want = capsys.readouterr().out
    pserve.main(argv)
    assert capsys.readouterr().out == want
    assert json.loads(want)["kv_mode"] == "int4"
    out = tmp_path / "plan.json"
    pserve.main(["--arch", "llama3.1-8b", "--quant", "int4", "--offload",
                 "--plan-json", str(out)])
    assert PS.ResolvedPlan.from_json(out.read_text()) == PS.EngineSpec(
        arch="llama3.1-8b", quant="int4", max_len=128,
        offload=True).resolve()
    with pytest.raises(SystemExit):
        pserve.main(["--quant", "int4", "--plan-json"])   # offload=False
