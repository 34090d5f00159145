"""DeepSeek-V3 (MLA layers with MoE feed-forwards and a shared expert)
through the port's engines, against the JAX package's on the same
weights, at the scaled config on the CPU (2 layers of (MLA, MOE) over two
periods; MLA ranks 32/16, nope 8, rope 8, v 8; 4 experts, top-2, one
shared; the MoE dropless at ``scaled_down``'s capacity factor 4):

  * ``OffloadedServingEngine``: tokens, stats and the untimed virtual
    trace (the KV_LOAD/KV_SAVE bytes of the latent ``c``/``kr`` rows
    among them) equal the JAX engine's across kv fp32/int4 x depth 1/2,
    and with INT4 weights; the real transfer threads give the same
    tokens;
  * ``stages=2``: dropped at resolve on an MLA stack, as the JAX
    resolver drops it; a plan forced to two stages builds one latent KV
    store per stage in both packages;
  * the resident ``ServingEngine`` and ``KVRoundtripServingEngine`` on
    the JAX resident engine's tree;
  * ``PipelinedLM``: in both packages it reads neither ``cfg.mla`` nor
    ``moe.shared_d_ff`` (ROADMAP Queue 3 item 11): the same tokens from
    the same seed;
  * ``sched="online"`` dropped and ``draft_arch`` refused at resolve,
    with the JAX plan's provenance and message.

Tokens and traces are held equal; no tolerance is involved."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.core.pipeline import VirtualPool as JaxVirtualPool  # noqa: E402
from repro.core.transfer import split_views  # noqa: E402
from repro.serving import EngineSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving.engine import KVRoundtripServingEngine as JaxKV  # noqa: E402
from repro.serving.spec import build_lm as jax_build_lm  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import (from_reference,  # noqa: E402
                                      from_reference_resident,
                                      from_reference_serving,
                                      quant_roundtrip_params)
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import (KVRoundtripServingEngine,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.offload_engine import OffloadedServingEngine  # noqa: E402

ARCH = "deepseek-v3-671b"
JC, PC = scaled_down(get_config(ARCH)), PB.scaled_down(port_config(ARCH))
B_MAX, MAX_LEN = 2, 48
PROMPT_LENS = (9, 20, 13)
MAX_NEW = (5, 3, 6)
untimed = lambda tr: [{k: v for k, v in e.items()
                       if k not in ("t_start", "t_end")}
                      for e in tr["events"]]


def _prompts(vocab=JC.vocab_size):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(eng, req_cls):
    for i, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=n))
    done = eng.run()
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


def _plans(offload=True, **kw):
    base = dict(arch=ARCH, cfg=JC, scaled=True, b_max=B_MAX,
                max_len=MAX_LEN, seed=0)
    if offload:
        base.update(offload=True, placement="host", pipeline="performance")
    jplan = EngineSpec(**base, **kw).resolve()
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=PC)
    return jplan, pplan


def _virtualize(eng, pool_cls):
    n = eng.sched.pool.n_workers
    eng.sched.pool.shutdown()
    eng.sched.pool = eng._kv_pool = pool_cls(n, trace=eng.trace)


def _weights(jeng):
    """The JAX offloaded engine's weights as numpy arrays: resident
    tables, every unit and expert buffer, and the routers."""
    res = {part: {n: np.asarray(a) for n, a in jeng.resident[part].items()}
           for part in ("embed", "final_norm")}
    units = {k: {n: np.array(a) for n, a in split_views(
        jeng.host.get(k), jeng.weights.manifests[k]).items()}
        for u in jeng.units for k in [u.key, *u.expert_keys]}
    routers = {u.key: np.asarray(u.router) for u in jeng.units if u.moe}
    return res, units, routers


_RUNS = {}


def _reference(kv_mode, depth, quant=None, **kw):
    """The JAX offloaded engine's run on a virtual pool (tokens, trace,
    stats) and its weights, once per configuration."""
    key = (kv_mode, depth, quant, tuple(sorted(kw.items())))
    if key not in _RUNS:
        jplan, pplan = _plans(kv_mode=kv_mode, depth=depth, quant=quant,
                              **kw)
        jeng = jax_create_engine(jplan)
        weights = _weights(jeng)
        _virtualize(jeng, JaxVirtualPool)
        _RUNS[key] = dict(pplan=pplan, weights=weights,
                          toks=_serve(jeng, JaxRequest),
                          trace=jeng.trace.to_json(), stats=dict(jeng.stats),
                          bounds=jeng.stage_bounds,
                          depths=list(jeng._stage_depths))
    return _RUNS[key]


def _port_engine(ref, **plan_kw):
    eng = PS.create_engine(dataclasses.replace(ref["pplan"], **plan_kw),
                           device="cpu")
    res, units, routers = ref["weights"]
    from_reference_serving(res, units, eng, routers)
    return eng


GRID = [("fp32", 1, None), ("fp32", 2, None), ("int4", 1, None),
        ("int4", 2, None), ("fp32", 1, "int4"), ("int4", 2, "int4")]


@pytest.mark.parametrize("kv_mode,depth,quant", GRID)
def test_offloaded_matches_reference(kv_mode, depth, quant):
    ref = _reference(kv_mode, depth, quant)
    eng = _port_engine(ref)
    assert isinstance(eng, OffloadedServingEngine)
    assert [u.spec.mixer for u in eng.units] == [PB.MLA, PB.MLA]
    assert all(u.moe for u in eng.units)
    _virtualize(eng, VirtualPool)
    assert _serve(eng, Request) == ref["toks"]
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == ref["stats"][k], k
    assert untimed(eng.trace.to_json()) == untimed(ref["trace"])
    # the real transfer threads give the same tokens
    assert _serve(_port_engine(ref), Request) == ref["toks"]


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_latent_rows_cross_the_link(kv_mode):
    """Each MLA unit's cache is the latent ``c`` (r) and ``kr`` (dr), kind
    ``"kv"``: a decode save ships one row of r + dr values a live slot
    (bf16), packed at ``kv_group(F)`` under INT4; the trace's KV_SAVE
    and KV_LOAD bytes are the JAX engine's."""
    ref = _reference(kv_mode, 1)
    eng = _port_engine(ref)
    _virtualize(eng, VirtualPool)
    _serve(eng, Request)
    m = PC.mla
    for j in range(len(eng.units)):
        meta = eng.kvstore.leaf_meta(j)
        assert sorted(meta) == ["c", "kr"]
        assert meta["c"].feat == (m.kv_lora_rank,)
        assert meta["kr"].feat == (m.qk_rope_head_dim,)
        assert meta["c"].quant == meta["kr"].quant == (kv_mode == "int4")
        assert eng.kvstore.save_nbytes(j, 1) == \
            (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    evs = eng.trace.to_json()["events"]
    for kind in ("kv_save", "kv_load"):
        mine = [e["nbytes"] for e in evs if e["kind"] == kind]
        assert mine and mine == [e["nbytes"] for e in ref["trace"]["events"]
                                 if e["kind"] == kind]


def test_quant_roundtrip_params_match_reference():
    """``quant_roundtrip_params`` on the JAX resident tree: bit for bit
    the JAX function's, the 3-D ``w_uk``/``w_uv``, the norms and the
    routers passed through unchanged, every 2-D projection and expert
    slice through the INT4 codec."""
    from repro.serving.offload_engine import quant_roundtrip_params as jrt
    params = _resident_reference()["params"]
    want = jax.tree.map(np.asarray, jrt(JC, params))
    got = quant_roundtrip_params(PC, params)
    tab, jtab, orig = got["pat"][0], want["pat"][0], params["pat"][0]
    assert sorted(tab) == sorted(jtab)
    for n in tab:
        np.testing.assert_array_equal(np.asarray(tab[n]), jtab[n])
    for n in ("w_uk", "w_uv", "q_a_norm", "kv_a_norm", "wg"):
        np.testing.assert_array_equal(tab[n], orig[n])
    for n in ("wq_a", "wq_b", "wkv_a", "wo", "ws_gate", "w_down"):
        assert not np.array_equal(tab[n], orig[n]), n


def test_int4_engine_equals_roundtripped_resident():
    """Inside the port, on its own draws from one seed: the INT4-weight,
    INT4-KV offloaded engine gives the tokens of the KV-roundtrip
    resident engine on ``quant_roundtrip_params`` of the same tree."""
    _, poff = _plans(kv_mode="int4", depth=2, quant="int4")
    _, pres = _plans(offload=False)
    off = PS.create_engine(poff, device="cpu")
    res = KVRoundtripServingEngine(pres, device="cpu")
    res.params = {k: v for k, v in quant_roundtrip_params(
        PC, res.params).items()}
    assert _serve(off, Request) == _serve(res, Request)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_mode,depth", [("fp32", 1), ("int4", 2)])
def test_stages_dropped_at_resolve_as_in_reference(kv_mode, depth):
    """The JAX resolver refuses pipeline-parallel staging on an MLA stack
    (``mixer_mla``): ``stages=2`` resolves to one stage, and the port's
    plan is the JAX plan, provenance included; the engine built from it
    serves the single-stage tokens."""
    ref = _reference(kv_mode, depth)
    sref = _reference(kv_mode, depth, stages=2)
    jplan, pplan = _plans(kv_mode=kv_mode, depth=depth, stages=2)
    assert pplan.stages == jplan.stages == 1
    assert "mixer_mla" in pplan.provenance["stages"]
    assert pplan.provenance == jplan.provenance
    eng = _port_engine(sref)
    assert eng.n_stages == 1 and sref["bounds"] == [(0, 2)]
    _virtualize(eng, VirtualPool)
    assert _serve(eng, Request) == sref["toks"] == ref["toks"]


def test_forced_two_stage_plan_builds_latent_stores():
    """A plan forced past the resolver to two stages builds, in both
    packages, one stage per MLA unit, each with its own KV store holding
    that unit's latent ``c``/``kr`` leaves."""
    jplan, pplan = _plans(kv_mode="int4", depth=1)
    jeng = jax_create_engine(dataclasses.replace(jplan, stages=2))
    eng = PS.create_engine(dataclasses.replace(pplan, stages=2),
                           device="cpu")
    try:
        assert eng.n_stages == jeng.n_stages == 2
        assert eng.stage_bounds == [tuple(b) for b in jeng.stage_bounds] \
            == [(0, 1), (1, 2)]
        assert eng._stage_depths == list(jeng._stage_depths)
        for st, jst in zip(eng.kvstore.stores, jeng.kvstore.stores):
            assert len(st) == len(jst) == 1
            meta, jmeta = st.leaf_meta(0), jst.leaf_meta(0)
            assert sorted(meta) == sorted(jmeta) == ["c", "kr"]
            for n in meta:
                assert meta[n].feat == jmeta[n].feat
                assert meta[n].quant and meta[n].group == jmeta[n].group
            assert st.host_nbytes() == jst.host_nbytes()
    finally:
        eng.shutdown()
        jeng.shutdown()


# ---------------------------------------------------------------------------
# the resident engines
# ---------------------------------------------------------------------------


_RESIDENT = {}


def _resident_reference():
    if not _RESIDENT:
        jplan, pplan = _plans(offload=False)
        jeng = jax_create_engine(jplan)
        _RESIDENT.update(
            pplan=pplan, params=jax.tree.map(np.asarray, jeng.params),
            toks=_serve(jeng, JaxRequest),
            kv_toks=_serve(JaxKV(jplan), JaxRequest))
    return _RESIDENT


@pytest.mark.parametrize("cls", ["ServingEngine", "KVRoundtripServingEngine"])
def test_resident_matches_reference(cls):
    ref = _resident_reference()
    assert ref["pplan"].engine == "resident"
    if cls == "ServingEngine":
        eng = PS.create_engine(ref["pplan"], device="cpu")
        assert type(eng) is ServingEngine
        want = ref["toks"]
    else:
        eng = KVRoundtripServingEngine(ref["pplan"], device="cpu")
        want = ref["kv_toks"]
    from_reference_resident(ref["params"], eng)
    assert eng.caches["pat"][0]["c"].shape == (
        PC.num_periods, B_MAX, MAX_LEN, PC.mla.kv_lora_rank)
    assert _serve(eng, Request) == want


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_resident_equals_offloaded_in_port(kv_mode):
    """Inside the port, on its own draws: the offloaded engine's tokens
    equal the resident engine's (fp32 KV) or the KV-roundtrip
    reference's (INT4 KV)."""
    _, pres = _plans(offload=False)
    _, poff = _plans(kv_mode=kv_mode, depth=2)
    cls = ServingEngine if kv_mode == "fp32" else KVRoundtripServingEngine
    assert _serve(PS.create_engine(poff, device="cpu"), Request) == \
        _serve(cls(pres, device="cpu"), Request)


# ---------------------------------------------------------------------------
# PipelinedLM (ROADMAP Queue 3 item 11)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant,kv_mode", [(None, None), ("int4", "int4")])
def test_pipelined_lm_matches_reference(quant, kv_mode):
    """Both packages' batch engines draw ``mha`` units of ``wq/wk/wv/wo``
    at ``num_heads`` x ``head_dim`` (rope over the whole head; no
    ``cfg.mla``) and MoE units whose experts and shared expert are MLPs
    at ``d_ff``: the same buffers, routers and tokens from one seed."""
    spec = dict(arch=ARCH, offload=True, placement="host", b_max=2,
                max_len=64, pipeline="performance", depth=1, seed=0,
                quant=quant, kv_mode=kv_mode)
    jplan = EngineSpec(cfg=JC, **spec).resolve()
    jlm = jax_build_lm(jplan)
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=PC)
    plm = PS.build_lm(pplan, device="cpu")
    assert [u.kind for u in plm.units] == ["mha", "moe", "mha", "moe"]
    keys = plm.store_keys()
    assert sorted(keys) == sorted(jlm.weights.manifests)
    assert "shx[0]" in keys                        # the shared expert
    mha = {n.split("#")[0]: e[1]
           for n, e in plm.manifests["mha[0]"].entries.items()
           if not n.endswith("#s")}
    assert set(mha) == {"wq", "wk", "wv", "wo", "norm"}
    width = PC.num_heads * PC.head_dim
    assert mha["wq"][-1] in (width, width // 2)     # packed: N / 2
    shx = {n.split("#")[0]: e[1]
           for n, e in plm.manifests["shx[0]"].entries.items()
           if not n.endswith("#s")}
    assert shx["w_down"][0] == PC.d_ff != PC.moe.shared_d_ff
    prompt = np.random.default_rng(1).integers(
        0, JC.vocab_size, (2, 21)).astype(np.int32)
    jtoks, _ = jlm.generate(prompt, 6, pool=JaxVirtualPool(3))
    ptoks, _ = plm.generate(prompt, 6, pool=VirtualPool(3))
    np.testing.assert_array_equal(ptoks, jtoks)
    if quant is None:
        units = {k: {n: np.array(v) for n, v in split_views(
            jlm.host.get(k), jlm.manifests[k]).items()} for k in keys}
        routers = {u.layer: np.asarray(jlm.device.get(f"wg[{u.layer}]"))
                   for u in jlm.units if u.kind == "moe"}
        plm2 = PS.build_lm(pplan, device="cpu")
        from_reference(np.asarray(jlm.device.get("emb")), units, plm2,
                       routers)
        np.testing.assert_array_equal(plm2.generate(prompt, 6)[0], jtoks)


# ---------------------------------------------------------------------------
# the capability gates
# ---------------------------------------------------------------------------


def test_capabilities_gated_as_in_reference():
    """Chunked prefill and speculation need a dense global-attention
    stack: resolve drops ``sched="online"`` for deepseek in both packages
    with the same provenance (``mixer_mla``) and both refuse a draft with
    the same message; the port's engine refuses an attached one."""
    spec = dict(arch=ARCH, scaled=True, offload=True, b_max=2, max_len=48)
    jplan = EngineSpec(**spec, sched="online", prefill_chunk=4).resolve()
    pplan = PS.EngineSpec(**spec, sched="online", prefill_chunk=4).resolve()
    assert pplan.to_json() == jplan.to_json()
    assert pplan.sched == "monolithic"
    assert pplan.provenance == jplan.provenance
    assert "mixer_mla" in pplan.provenance["sched"]
    with pytest.raises(Exception) as jerr:
        EngineSpec(**spec, draft_arch="llama3.2-1b").resolve()
    with pytest.raises(PS.SpecError) as perr:
        PS.EngineSpec(**spec, draft_arch="llama3.2-1b").resolve()
    assert str(perr.value) == str(jerr.value)
    assert "mixer_mla" in str(perr.value)
    eng = PS.create_engine(pplan, device="cpu")
    assert not eng.sched_policy.chunked
    try:
        from fake_model import FakeDraft
        with pytest.raises(PS.UnsupportedModelError):
            eng.attach_draft(FakeDraft(256), 2)
    finally:
        eng.shutdown()


def test_full_config_plans_as_in_reference():
    """DeepSeek-V3 at full width: all 61 layers resolve to disk, cut to 2
    layers (two periods) to the host, in both packages, with the same
    plan and provenance (what ``chip_smoke.py`` run (t) builds)."""
    for layers, placement in ((61, "disk"), (2, "host")):
        jcfg = dataclasses.replace(get_config(ARCH), num_layers=layers,
                                   num_periods=layers)
        pcfg = dataclasses.replace(port_config(ARCH), num_layers=layers,
                                   num_periods=layers)
        jplan = EngineSpec(arch=ARCH, cfg=jcfg, quant="int4").resolve()
        pplan = PS.EngineSpec(arch=ARCH, cfg=pcfg, quant="int4").resolve()
        assert pplan.to_json() == jplan.to_json()
        assert (pplan.engine, pplan.placement, pplan.depth) == \
            ("offloaded", placement, 1)
        if layers == 2:
            assert (pplan.b_max, pplan.max_len) == (4, 256)
