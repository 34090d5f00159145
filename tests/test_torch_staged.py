"""The port's pipeline-parallel (staged) offloaded engine against the JAX
package's, on the CPU, at ``tests/test_spec_decode.py``'s ``pipo-tiny``
config (three layers, so ``stages=2`` splits the units 2 + 1).

A two-stage ``OffloadedServingEngine`` (each stage its own weight and KV
store on its own link, its own transfer pool and window from the plan's
``stage_plan``, activations handed stage to stage) serves the tokens of
the single-stage engine and of the JAX staged engine on the same
weights, across quant {None, int4} x kv_mode {fp32, int4} x depth
{1, 2}; its trace is stage-tagged; both stages preload; preemption
spills per stage; the stage count clamps to the units.  ``build_lm`` on
a staged plan runs one stage, as the JAX ``PipelinedLM`` does."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ATTN, DENSE, LayerSpec, ModelConfig  # noqa: E402
from repro.core.transfer import split_views  # noqa: E402
from repro.serving import EngineSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving.spec import build_lm as jax_build_lm  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.core.convert import (from_reference,  # noqa: E402
                                      from_reference_serving)
from repro_torch.launch.mesh import stage_devices  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402

KW = dict(name="pipo-tiny", num_layers=3, d_model=128, num_heads=4,
          num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
JCFG = ModelConfig(**KW, pattern=(LayerSpec(ATTN, DENSE),))
PCFG = PB.ModelConfig(**KW, pattern=(PB.LayerSpec(PB.ATTN, PB.DENSE),))


def _prompts(n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(0, JCFG.vocab_size, (5 + i,)).astype(np.int32)
            for i in range(n)]


def _plans(quant=None, kv="fp32", depth=1, **kw):
    jplan = EngineSpec(arch=JCFG.name, cfg=JCFG, offload=True,
                       placement="host", pipeline="performance", b_max=2,
                       max_len=64, quant=quant, kv_mode=kv, depth=depth,
                       **kw).resolve()
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=PCFG)
    return jplan, pplan


def _serve(eng, req_cls, prompts, max_new=6):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=max_new))
    done = eng.run()
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


_REF = {}


def _ref(quant, kv):
    """The JAX single-stage engine's weights and tokens (the staged
    engines draw the same weights from the same seed)."""
    if (quant, kv) not in _REF:
        jeng = jax_create_engine(_plans(quant, kv)[0])
        res = {part: {n: np.asarray(a) for n, a in
                      jeng.resident[part].items()}
               for part in ("embed", "final_norm")}
        units = {u.key: {n: np.array(a) for n, a in split_views(
            jeng.host.get(u.key), jeng.weights.manifests[u.key]).items()}
            for u in jeng.units}
        _REF[quant, kv] = dict(res=res, units=units,
                               toks=_serve(jeng, JaxRequest, _prompts()))
    return _REF[quant, kv]


def _port(quant=None, kv="fp32", depth=1, **kw):
    ref = _ref(quant, kv)
    eng = PS.create_engine(_plans(quant, kv, depth, **kw)[1], device="cpu")
    from_reference_serving(ref["res"], ref["units"], eng)
    return eng


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("quant,kv", [(None, "fp32"), ("int4", "fp32"),
                                      (None, "int4"), ("int4", "int4")])
def test_two_stage_parity_grid(quant, kv, depth):
    """Staging is a scheduling change only: a two-stage engine serves the
    single-stage engine's tokens (the port's and the JAX package's)."""
    ref = _ref(quant, kv)
    eng = _port(quant, kv, depth, stages=2)
    assert eng.n_stages == 2
    assert eng.stage_bounds == [(0, 2), (2, 3)]
    assert eng._stage_depths == [1, 1]      # each clamped to its units
    assert _serve(eng, Request, _prompts()) == ref["toks"]
    assert _serve(_port(quant, kv, depth), Request, _prompts()) == \
        ref["toks"]


@pytest.mark.parametrize("quant,kv,depth", [(None, "fp32", 1),
                                            ("int4", "int4", 2)])
def test_two_stage_matches_reference_staged_engine(quant, kv, depth):
    """The JAX staged engine built from the same plan serves the same
    tokens over the same stage tiling and per-stage windows."""
    jplan, _ = _plans(quant, kv, depth, stages=2)
    jeng = jax_create_engine(jplan)
    eng = _port(quant, kv, depth, stages=2)
    assert eng.stage_bounds == jeng.stage_bounds
    assert eng._stage_depths == jeng._stage_depths
    assert _serve(eng, Request, _prompts()) == _serve(jeng, JaxRequest,
                                                       _prompts())
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == jeng.stats[k], k


def test_trace_carries_stage_structure():
    """The trace is stage-tagged end to end: meta records the tiling,
    events carry both stage ids, the report grows ``stage_bubbles``; each
    stage streams over its own link, and its KV store shares it."""
    eng = _port(stages=2)
    _serve(eng, Request, _prompts(2), max_new=3)
    assert eng.trace.meta["stages"] == 2
    assert eng.trace.meta["stage_units"] == [[0, 2], [2, 3]]
    assert {e.stage for e in eng.trace.events()} == {0, 1}
    assert set(eng.pipeline_report()["stage_bubbles"]) == {0, 1}
    s0, s1 = eng.weights.stores
    assert s0.link is not s1.link
    assert eng.kvstore.stores[0].link is s0.link
    assert eng.kvstore.stores[1].link is s1.link
    assert len(eng.kvstore) == 3 and len(eng.kvstore.stores[1]) == 1
    assert [sorted(st.manifests) for st in eng.weights.stores] == [
        ["u[0][0]", "u[1][0]"], ["u[2][0]"]]


def test_both_stages_preload_weights():
    """Every stage primes its own window: stage-tagged weight loads from
    both stages, under global unit names."""
    eng = _port(stages=2)
    _serve(eng, Request, _prompts(2), max_new=4)
    by_stage = {}
    for e in eng.trace.events():
        if e.kind == "weight_load":
            by_stage.setdefault(e.stage, []).append(e.name)
    assert set(by_stage) == {0, 1}
    assert set(by_stage[0]) == {"w[0]", "w[1]"}
    assert set(by_stage[1]) == {"w[2]"} and len(by_stage[1]) > 1


def test_spill_restore_resume_parity():
    """Preempt and resume under staging: each stage's KV store spills
    into its own namespace, and the stream equals the uninterrupted
    one."""
    ref = _ref(None, "int4")
    eng = _port(None, "int4", stages=2)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=6))
    done = []
    for _ in range(3):
        eng.step(done)
    eng.preempt_slot(0)
    assert any("/s1/" in k for k in eng.host.keys())
    while not eng.idle():
        eng.step(done)
    eng.shutdown()
    assert {r.rid: r.out for r in done} == ref["toks"]
    assert eng.stats["slot_restores"] == 1


def test_stage_count_clamps_to_units():
    eng = _port(stages=8)
    assert eng.n_stages == 3 and eng.plan.stages == 3
    assert "clamped" in eng.plan.provenance["stages"]
    assert eng.stage_bounds == [(0, 1), (1, 2), (2, 3)]
    assert _serve(eng, Request, _prompts(1), max_new=3) == {
        0: _ref(None, "fp32")["toks"][0][:3]}


def test_stage_devices():
    assert stage_devices(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert stage_devices(2) == [torch.device("cuda", s % n)
                                    for s in range(2)]


@pytest.mark.parametrize("kv", ["fp32", "int4"])
def test_build_lm_runs_a_staged_plan_on_one_stage(kv):
    """``build_lm`` on a ``stages=2`` plan builds the PipelinedLM (the JAX
    engine never reads ``stages``) and generates the JAX engine's
    tokens on its weights."""
    jplan, pplan = _plans(kv=kv, stages=2)
    assert pplan.stages == 2
    jlm = jax_build_lm(jplan)
    prompt = np.random.default_rng(0).integers(0, 512, (2, 9)).astype(
        np.int32)
    jtoks, _ = jlm.generate(prompt, 6)
    lm = PS.build_lm(pplan, device="cpu")
    from_reference(np.asarray(jlm.device.get("emb")), {
        u.key: {k: np.array(v) for k, v in split_views(
            jlm.host.get(u.key), jlm.manifests[u.key]).items()}
        for u in jlm.units}, lm)
    toks, _ = lm.generate(prompt, 6)
    np.testing.assert_array_equal(toks, jtoks)
