"""The port's ``PipelinedLM`` on MoE stacks against the JAX package's, on
the CPU: built from the same resolved plan, the port draws the JAX
engine's weights byte for byte (one generator: attention unit, router,
experts 0..E-1, shared expert), gives the same greedy tokens and, on a
virtual-clock pool, records the same trace (the expert WEIGHT_LOADs of
the routed union included), across placement, pipeline mode, INT4
weights (fused and unfused), INT4 KV and preload depth; performance
mode equals sequential (``tests/test_engine.py::test_moe_engine``), and
an engine built on another's weights (``build_lm(weights=...)``) equals
it.  Then the capability gates: ``attach_draft`` refuses MoE on both
offloaded engines, ``resolve`` refuses a draft and drops chunked prefill
and stages for MoE with the JAX package's errors and provenance, and the
CLI serves an MoE arch, resident (``--moe-quant int4``) and offloaded."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import (ATTN, MOE, LayerSpec,  # noqa: E402
                                ModelConfig, MoEConfig)
from repro.core.engine import PipelinedLM as JaxLM  # noqa: E402
from repro.core.pipeline import VirtualPool as JaxVirtualPool  # noqa: E402
from repro.serving import spec as JS  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.core.convert import lm_weights  # noqa: E402
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.spec import ResolvedPlan, build_lm  # noqa: E402
from fake_model import FakeDraft  # noqa: E402

CFGS = {  # pipo-moe: tests/test_engine.py's; pipo-moe128: no shared
    # expert, every expert projection INT4-eligible
    "pipo-moe": dict(name="pipo-moe", num_layers=2, d_model=64, num_heads=4,
                     num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                     moe=dict(num_experts=4, top_k=2, expert_d_ff=128,
                              num_shared=1, shared_d_ff=128)),
    "pipo-moe128": dict(name="pipo-moe128", num_layers=2, d_model=128,
                        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                        vocab_size=384,
                        moe=dict(num_experts=4, top_k=2, expert_d_ff=256)),
}
B, PROMPT, GEN, MAX_LEN = 2, 8, 5, 32


def _cfgs(name):
    kw = dict(CFGS[name])
    moe = kw.pop("moe")
    return (ModelConfig(**kw, pattern=(LayerSpec(ATTN, MOE),),
                        moe=MoEConfig(**moe)),
            PB.ModelConfig(**kw, pattern=(PB.LayerSpec(PB.ATTN, PB.MOE),),
                           moe=PB.MoEConfig(**moe)))


def _plans(tmp, name, placement="host", pipeline="performance", quant=None,
           fused=True, depth=1, kv_mode=None, cache_on="host"):
    jcfg, pcfg = _cfgs(name)
    spec = JS.EngineSpec(arch=name, cfg=jcfg, offload=True,
                         placement=placement, b_max=B, max_len=MAX_LEN,
                         pipeline=pipeline, quant=quant, fused_int4=fused,
                         depth=depth, cache_on=cache_on, kv_mode=kv_mode,
                         seed=0, disk_root=str(tmp / "jax_disk"))
    jplan = spec.resolve()
    pplan = dataclasses.replace(ResolvedPlan.from_json(jplan.to_json()),
                                cfg=pcfg, disk_root=str(tmp / "port_disk"))
    return jplan, pplan


def _prompt(vocab):
    return np.random.default_rng(0).integers(
        0, vocab, (B, PROMPT)).astype(np.int32)


def _buffer(lm, key):
    if lm.placement == "host":
        buf = lm.host.get(key)
    elif lm.placement == "disk":
        buf = lm.disk.get(key)
    else:
        buf = lm.device.get(key)
    return np.asarray(buf.cpu() if isinstance(buf, torch.Tensor) else buf
                      ).reshape(-1)


GRID = [  # cfg, placement, pipeline, quant, fused, depth, kv_mode, cache_on
    ("pipo-moe", "host", "performance", None, True, 1, None, "host"),
    ("pipo-moe", "host", "sequential", None, True, 1, None, "host"),
    ("pipo-moe", "device", "performance", None, True, 2, None, "host"),
    ("pipo-moe", "host", "performance", "int4", True, 1, "int4", "host"),
    ("pipo-moe128", "host", "performance", "int4", True, 2, None, "host"),
    ("pipo-moe128", "disk", "performance", "int4", False, 1, None, "host"),
    ("pipo-moe128", "host", "memory", None, True, 1, "int4", "host"),
    ("pipo-moe128", "host", "performance", "int4", True, 1, None, "device"),
]


@pytest.mark.parametrize(
    "name,placement,pipeline,quant,fused,depth,kv_mode,cache_on", GRID)
def test_moe_lm_matches_reference(tmp_path, name, placement, pipeline,
                                  quant, fused, depth, kv_mode, cache_on):
    jplan, pplan = _plans(tmp_path, name, placement, pipeline, quant, fused,
                          depth, kv_mode, cache_on)
    jlm = JaxLM(jplan)
    plm = build_lm(pplan, device="cpu")
    # the same draws, byte for byte: every store buffer and router
    keys = plm.store_keys()
    assert sorted(keys) == sorted(jlm.weights.manifests)
    for key in keys:
        np.testing.assert_array_equal(_buffer(plm, key), _buffer(jlm, key))
        assert plm.manifests[key].entries == jlm.manifests[key].entries
    for u in plm.units:
        if u.kind == "moe":
            np.testing.assert_array_equal(
                plm.device.get(f"wg[{u.layer}]").numpy(),
                np.asarray(jlm.device.get(f"wg[{u.layer}]")))
    prompt = _prompt(pplan.cfg.vocab_size)
    jpool = JaxVirtualPool(3)
    jtoks, _ = jlm.generate(prompt, GEN, pool=jpool)
    ppool = VirtualPool(3)
    ptoks, _ = plm.generate(prompt, GEN, pool=ppool)
    np.testing.assert_array_equal(ptoks, jtoks)
    # the same schedule, task for task: the routed experts' loads among
    # them, each with its bytes
    assert ppool.trace.to_json() == jpool.trace.to_json()
    experts = [e for e in ppool.trace.events()
               if e.kind == "weight_load" and e.name.startswith("exp[")]
    assert experts and all(e.nbytes > 0 for e in experts)
    loads = sum(plm.weights.load_counts.get(k, 0) for k in keys
                if k.startswith("exp["))
    assert loads == len(experts) < GEN * 2 * 4


@pytest.mark.parametrize("name", ["pipo-moe", "pipo-moe128"])
def test_performance_equals_sequential(tmp_path, name):
    """``tests/test_engine.py::test_moe_engine`` in the port, on real
    threads: the performance pipeline and the sequential one give the
    same tokens; the sequential engine takes the first one's weights
    (``build_lm(weights=lm_weights(lm))``) instead of drawing them."""
    _, perf = _plans(tmp_path, name, quant="int4")
    _, seq = _plans(tmp_path, name, pipeline="sequential", quant="int4")
    lm = build_lm(perf, device="cpu")
    prompt = _prompt(perf.cfg.vocab_size)
    toks, _ = lm.generate(prompt, GEN)
    assert toks.shape == (B, GEN)
    lm2 = build_lm(seq, device="cpu", weights=lm_weights(lm))
    for key in lm.store_keys():
        np.testing.assert_array_equal(_buffer(lm2, key), _buffer(lm, key))
    toks2, _ = lm2.generate(prompt, GEN)
    np.testing.assert_array_equal(toks, toks2)


def test_attach_draft_refuses_moe(tmp_path):
    """Both offloaded engines refuse a draft on MoE, as the JAX engines
    do (``tests/test_spec_decode.py::test_attach_draft_rejects_moe_
    engines``)."""
    _, pplan = _plans(tmp_path, "pipo-moe")
    lm = build_lm(pplan, device="cpu")
    with pytest.raises(ValueError, match="dense"):
        lm.attach_draft(FakeDraft(pplan.cfg.vocab_size), 2)
    eng = PS.create_engine(pplan, device="cpu")
    assert any(u.moe for u in eng.units)
    with pytest.raises(PS.UnsupportedModelError) as ei:
        eng.attach_draft(FakeDraft(pplan.cfg.vocab_size), 2)
    assert ei.value.capability == "moe_ffn"
    eng.shutdown()


def _resolve(pkg, **kw):
    try:
        return pkg.EngineSpec(arch="mixtral-8x7b", scaled=True, **kw
                              ).resolve().to_json()
    except pkg.SpecError as e:
        return ("SpecError", str(e))


@pytest.mark.parametrize("kw", [
    dict(offload=True, draft_arch="mixtral-8x7b"),
    dict(offload=True, sched="online", prefill_chunk=4),
    dict(offload=True, sched="offline"),
    dict(offload=True, b_max=2, max_len=64, stages=2),
    dict(offload=True, moe_quant="int4"),
    dict(offload=False, moe_quant="int4"),
], ids=["draft", "online", "offline", "stages", "moe_quant_offloaded",
        "moe_quant_resident"])
def test_moe_gates_match_reference(kw):
    """Speculation is refused, chunked prefill and stages are dropped and
    ``moe_quant`` is dropped from an offloaded plan, with the JAX
    package's errors and provenance (the plan JSON, whole)."""
    port, ref = _resolve(PS, **kw), _resolve(JS, **kw)
    assert port == ref
    if "draft_arch" in kw:
        assert port[0] == "SpecError" and "moe_ffn" in port[1]
    elif "sched" in kw:
        assert port["sched"] == "monolithic"
        assert "moe_ffn" in port["provenance"]["sched"]
    elif "stages" in kw:
        assert port["stages"] == 1


@pytest.mark.parametrize("argv", [
    ["--moe-quant", "int4"], ["--offload", "--quant", "int4"],
    ["--offload", "--kv-mode", "int4"]], ids=["moe_quant", "offload_int4",
                                              "offload_kv_int4"])
def test_cli_serves_moe(argv, capsys):
    """``launch.serve`` on the scaled Mixtral, on the CPU: every request
    completes; the offloaded plans stream the routed experts."""
    eng = pserve.main(["--arch", "mixtral-8x7b", "--scaled", "--requests",
                       "3", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert "completed=3 tokens=24" in out
    if "--offload" in argv:
        assert eng.stats["moe_stack_bytes"] > 0
        assert any(k.endswith("/exp[0]") or "/exp[" in k
                   for k in eng.weights.load_counts)
    else:
        assert eng.plan.moe_quant == "int4"
        assert "w_gate#q" in eng.params["pat"][0]
