"""The port's speculative decoding against the JAX package's, on the CPU,
at ``tests/test_spec_decode.py``'s ``pipo-tiny`` config.

  * Serving: the port's ``OffloadedServingEngine`` on the JAX engine's
    weights (``core/convert.from_reference_serving``) with a seeded
    ``FakeDraft`` (mostly rejected proposals: the truncate and
    drop-stale-preloads path every step) emits the JAX engine's
    non-speculative tokens and its own, across quant {None, int4} x
    kv_mode {fp32, int4} x depth {1, 2}; an ``OracleDraft`` forces full
    acceptance.  On a virtual-clock pool the port's speculative run
    records the JAX speculative run's trace, task for task, and the same
    ``trace.meta["spec_steps"]`` (but for the draft's wall seconds).
  * ``PipelinedLM``: the same over kv_mode {fp32, int4} x depth {1, 2}
    and with INT4 weights; the oracle collapses generation to
    ceil(gen / (k+1)) verify passes.
  * ``ResidentDraft`` on the JAX draft's weights (``from_reference_
    resident``) proposes the JAX draft's tokens; a plan with
    ``draft_arch`` builds it and serves the non-speculative tokens.
  * ``spec_decode_attention`` (plain and packed) against the JAX
    function, and the ``DraftPolicy``/resolve/CLI seam and the accept
    rule (a hypothesis property) as ``tests/test_spec_decode.py`` holds
    the JAX package's."""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from fake_model import FakeDraft, OracleDraft  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.configs.base import ATTN, DENSE, LayerSpec, ModelConfig  # noqa: E402
from repro.core.draft import ResidentDraft as JaxDraft  # noqa: E402
from repro.core.kvstore import kv_roundtrip_traceable  # noqa: E402
from repro.core.pipeline import VirtualPool as JaxVirtualPool  # noqa: E402
from repro.core.transfer import split_views  # noqa: E402
from repro.models import attention as JAT  # noqa: E402
from repro.serving import EngineSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving.spec import build_lm as jax_build_lm  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import (from_reference,  # noqa: E402
                                      from_reference_resident,
                                      from_reference_serving)
from repro_torch.core.draft import (ResidentDraft, accept_length,  # noqa: E402
                                    accepted_tokens)
from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows  # noqa: E402
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.models import attention as PAT  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.offload_engine import OffloadedServingEngine  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                   # optional test dependency
    given = None

KW = dict(name="pipo-tiny", num_layers=3, d_model=128, num_heads=4,
          num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
JCFG = ModelConfig(**KW, pattern=(LayerSpec(ATTN, DENSE),))
PCFG = PB.ModelConfig(**KW, pattern=(PB.LayerSpec(PB.ATTN, PB.DENSE),))
untimed = lambda tr: [{k: v for k, v in e.items()
                       if k not in ("t_start", "t_end")}
                      for e in tr["events"]]
no_wall = lambda steps: [{k: v for k, v in s.items() if k != "draft_s"}
                         for s in steps]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _prompts(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, (5 + i,)).astype(np.int32)
            for i in range(n)]


def _serve_plans(quant, kv, depth=1, **kw):
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


def _virtualize(eng, pool_cls):
    n = eng.sched.pool.n_workers
    eng.sched.pool.shutdown()
    eng.sched.pool = eng._kv_pool = pool_cls(n, trace=eng.trace)


def _serving_weights(jeng):
    res = {part: {n: np.asarray(a) for n, a in jeng.resident[part].items()}
           for part in ("embed", "final_norm")}
    units = {u.key: {n: np.array(a) for n, a in split_views(
        jeng.host.get(u.key), jeng.weights.manifests[u.key]).items()}
        for u in jeng.units}
    return res, units


_SERVE = {}


def _serve_ref(quant, kv):
    """The JAX engine's weights and non-speculative tokens, once per
    (quant, kv_mode)."""
    if (quant, kv) not in _SERVE:
        jplan, _ = _serve_plans(quant, kv)
        jeng = jax_create_engine(jplan)
        res, units = _serving_weights(jeng)
        _SERVE[quant, kv] = dict(res=res, units=units, toks=_serve(
            jeng, JaxRequest, _prompts()))
    return _SERVE[quant, kv]


def _port_serving(quant, kv, depth=1, **kw):
    ref = _serve_ref(quant, kv)
    eng = PS.create_engine(_serve_plans(quant, kv, depth, **kw)[1],
                           device="cpu")
    from_reference_serving(ref["res"], ref["units"], eng)
    return eng


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kv", ["fp32", "int4"])
@pytest.mark.parametrize("quant", [None, "int4"])
def test_serving_spec_parity_grid(quant, kv, depth):
    """Speculative greedy decode with a bad draft emits the JAX engine's
    non-speculative tokens and the port's own, at every depth, under
    INT4 weights and INT4 KV; 3 requests through 2 slots reuse a slot
    with a live draft cache."""
    ref = _serve_ref(quant, kv)
    assert _serve(_port_serving(quant, kv, depth), Request,
                  _prompts()) == ref["toks"]
    eng = _port_serving(quant, kv, depth)
    draft = FakeDraft(JCFG.vocab_size, seed=3)
    eng.attach_draft(draft, 3)
    assert _serve(eng, Request, _prompts()) == ref["toks"]
    assert eng.stats["spec_steps"] > 0
    assert 0 <= eng.stats["spec_accepted"] <= eng.stats["spec_proposed"]
    assert eng.trace.meta["spec_k"] == 3
    # every admitted prompt went into the draft too
    assert sorted(n for _, n in draft.prefills) == sorted(
        len(p) for p in _prompts())


def test_serving_oracle_full_acceptance():
    """The oracle proposes the recorded stream: every proposal accepted,
    each verify pass emits k+1 tokens, and the stream is unchanged."""
    prompt = _prompts(1)
    ref = _serve(_port_serving(None, "fp32"), Request, prompt, max_new=8)
    eng = _port_serving(None, "fp32")
    eng.attach_draft(OracleDraft([ref[0]], prompt_len=len(prompt[0])), 3)
    assert _serve(eng, Request, prompt, max_new=8) == ref
    assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"] > 0
    for s in eng.trace.meta["spec_steps"]:
        assert s["accepts"] == [s["k"]] * len(s["accepts"])


@pytest.mark.parametrize("quant,kv,depth", [(None, "fp32", 1),
                                            ("int4", "int4", 2)])
def test_serving_spec_trace_matches_reference(quant, kv, depth):
    """On a virtual-clock pool the port's speculative run records the JAX
    speculative run's trace (names, kinds, bytes, live extents) and the
    same per-step records: k, primed weight loads, acceptances."""
    jplan, _ = _serve_plans(quant, kv, depth)
    jeng = jax_create_engine(jplan)
    res, units = _serving_weights(jeng)
    _virtualize(jeng, JaxVirtualPool)
    jeng.attach_draft(FakeDraft(JCFG.vocab_size, seed=1), 3)
    jtoks = _serve(jeng, JaxRequest, _prompts())
    eng = PS.create_engine(_serve_plans(quant, kv, depth)[1], device="cpu")
    from_reference_serving(res, units, eng)
    _virtualize(eng, VirtualPool)
    eng.attach_draft(FakeDraft(JCFG.vocab_size, seed=1), 3)
    assert _serve(eng, Request, _prompts()) == jtoks
    for k in ("spec_steps", "spec_proposed", "spec_accepted", "prefills",
              "decode_steps", "tokens_out"):
        assert eng.stats[k] == jeng.stats[k], k
    assert untimed(eng.trace.to_json()) == untimed(jeng.trace.to_json())
    steps = eng.trace.meta["spec_steps"]
    assert no_wall(steps) == no_wall(jeng.trace.meta["spec_steps"])
    assert sum(sum(s["accepts"]) for s in steps) == \
        eng.stats["spec_accepted"]
    assert all(s["draft_s"] >= 0.0 for s in steps)


def test_serving_spec_under_chunked_prefill():
    """A chunk in flight runs the mixed step; speculation resumes after
    it, and the tokens still equal the monolithic engine's."""
    ref = _serve_ref(None, "fp32")
    eng = _port_serving(None, "fp32", sched="online", prefill_chunk=3)
    eng.attach_draft(FakeDraft(JCFG.vocab_size, seed=4), 2)
    assert _serve(eng, Request, _prompts()) == ref["toks"]
    assert eng.stats["prefill_chunks"] > eng.stats["prefills"]
    assert eng.stats["spec_steps"] > 0


def test_serving_spec_preempt_resume():
    """A preempted request resumes without a draft prefill (its draft
    cache is stale): acceptance may drop, tokens do not change."""
    ref = _serve_ref("int4", "int4")
    eng = _port_serving("int4", "int4")
    eng.attach_draft(FakeDraft(JCFG.vocab_size, seed=6), 2)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=6))
    done = []
    eng.step(done)
    eng.preempt_slot(0)
    while not eng.idle():
        eng.step(done)
    eng.shutdown()
    assert {r.rid: r.out for r in done} == ref["toks"]
    assert eng.stats["slot_restores"] == 1


def test_attach_draft_rejects_unsupported_target():
    eng = _port_serving(None, "fp32")
    eng.cfg = dataclasses.replace(
        PCFG, pattern=(PB.LayerSpec(PB.ATTN, PB.MOE),),
        moe=PB.MoEConfig(num_experts=2))
    with pytest.raises(PS.UnsupportedModelError) as ei:
        eng.attach_draft(FakeDraft(JCFG.vocab_size), 2)
    assert ei.value.capability == "moe_ffn"
    eng.shutdown()


# ---------------------------------------------------------------------------
# PipelinedLM
# ---------------------------------------------------------------------------


def _lm_plans(kv, depth, quant=None):
    jplan = EngineSpec(arch=JCFG.name, cfg=JCFG, offload=True,
                       placement="host", pipeline="performance", b_max=2,
                       max_len=48, quant=quant, kv_mode=kv,
                       depth=depth).resolve()
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=PCFG)
    return jplan, pplan


_LM = {}


def _lm_ref(kv, quant=None, gen=8):
    """The JAX PipelinedLM's weights, prompt and non-speculative tokens,
    once per (kv_mode, quant)."""
    if (kv, quant) not in _LM:
        jlm = jax_build_lm(_lm_plans(kv, 1, quant)[0])
        prompt = np.random.default_rng(0).integers(
            0, 512, (2, 10)).astype(np.int32)
        units = {u.key: {k: np.array(v) for k, v in split_views(
            jlm.host.get(u.key), jlm.manifests[u.key]).items()}
            for u in jlm.units}
        toks, _ = jlm.generate(prompt, gen)
        _LM[kv, quant] = dict(emb=np.asarray(jlm.device.get("emb")),
                              units=units, prompt=prompt, toks=toks)
    return _LM[kv, quant]


def _port_lm(kv, depth, quant=None):
    ref = _lm_ref(kv, quant)
    lm = PS.build_lm(_lm_plans(kv, depth, quant)[1], device="cpu")
    from_reference(ref["emb"], ref["units"], lm)
    return lm


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kv", ["fp32", "int4"])
def test_lm_spec_parity_grid(kv, depth):
    """The uniform batch accepts the shortest run over its rows; the
    stream equals the JAX engine's and the port's non-speculative one."""
    ref = _lm_ref(kv)
    plain, _ = _port_lm(kv, depth).generate(ref["prompt"], 8)
    np.testing.assert_array_equal(plain, ref["toks"])
    lm = _port_lm(kv, depth)
    draft = FakeDraft(512, seed=5)
    lm.attach_draft(draft, 3)
    toks, stats = lm.generate(ref["prompt"], 8)
    np.testing.assert_array_equal(toks, ref["toks"])
    assert stats["spec_steps"] > 0
    assert stats["spec_accepted"] <= stats["spec_proposed"]
    assert draft.prefills == [("batch", 10)]


def test_lm_int4_weights_spec_parity():
    ref = _lm_ref("fp32", "int4")
    lm = _port_lm("fp32", 1, "int4")
    lm.attach_draft(FakeDraft(512, seed=2), 2)
    toks, stats = lm.generate(ref["prompt"], 6)
    np.testing.assert_array_equal(toks, ref["toks"][:, :6])
    assert stats["spec_steps"] > 0


@pytest.mark.parametrize("kv", ["fp32", "int4"])
def test_lm_oracle_full_acceptance(kv):
    """Every row's own recorded stream: each step emits k+1 tokens, so 8
    tokens take ceil(8 / 4) = 2 verify passes."""
    ref = _lm_ref(kv)
    lm = _port_lm(kv, 1)
    lm.attach_draft(OracleDraft(list(ref["toks"]), prompt_len=10), 3)
    toks, stats = lm.generate(ref["prompt"], 8)
    np.testing.assert_array_equal(toks, ref["toks"])
    assert stats["spec_accepted"] == stats["spec_proposed"] > 0
    assert stats["spec_steps"] == 2


def test_lm_spec_trace_matches_reference():
    """Virtual-clock trace and per-step records equal the JAX engine's
    speculative run's, with INT4 KV (truncate and dropped preloads)."""
    jplan, pplan = _lm_plans("int4", 2)
    jlm = jax_build_lm(jplan)
    ref = _lm_ref("int4")
    jlm.attach_draft(FakeDraft(512, seed=7), 3)
    jpool = JaxVirtualPool(jlm.depth + 2)
    jtoks, jstats = jlm.generate(ref["prompt"], 8, pool=jpool)
    lm = _port_lm("int4", 2)
    lm.attach_draft(FakeDraft(512, seed=7), 3)
    pool = VirtualPool(lm.depth + 2)
    toks, stats = lm.generate(ref["prompt"], 8, pool=pool)
    np.testing.assert_array_equal(toks, jtoks)
    for k in ("spec_steps", "spec_proposed", "spec_accepted"):
        assert stats[k] == jstats[k], k
    assert untimed(pool.trace.to_json()) == untimed(jpool.trace.to_json())
    assert no_wall(pool.trace.meta["spec_steps"]) == \
        no_wall(jpool.trace.meta["spec_steps"])


# ---------------------------------------------------------------------------
# the draft model and the plan seam
# ---------------------------------------------------------------------------


def test_resident_draft_proposes_reference_tokens():
    """On the JAX draft's weights the port's draft proposes the same
    tokens: slot prefills at ragged lengths, then a batch prefill."""
    jd = JaxDraft(JCFG, b_max=2, max_len=48, seed=0)
    pd = ResidentDraft(PCFG, b_max=2, max_len=48, device="cpu")
    from_reference_resident(jd.params, pd)
    p0, p1 = _prompts(2, seed=1)
    for d in (jd, pd):
        d.prefill_slot(0, p0)
        d.prefill_slot(1, p1)
    tok = np.array([3, 99], np.int32)
    pos = np.array([len(p0), len(p1)], np.int32)
    np.testing.assert_array_equal(pd.propose(tok, pos, 3),
                                  jd.propose(tok, pos, 3))
    batch = np.random.default_rng(2).integers(0, 512, (2, 7)).astype(np.int32)
    for d in (jd, pd):
        d.prefill_batch(batch)
    pos = np.full(2, 7, np.int32)
    got = pd.propose(tok, pos, 4)
    np.testing.assert_array_equal(got, jd.propose(tok, pos, 4))
    assert got.shape == (2, 4) and got.dtype == np.int32
    assert pd.nbytes > 0


def test_plan_with_draft_arch_builds_the_resident_draft():
    """The real path, no fakes: a plan with ``draft_arch`` attaches a
    ``ResidentDraft`` in both engines' constructors, and the streams equal
    the non-speculative engines' (same seed, same weights)."""
    cfg = PB.scaled_down(port_config("tinyllama-1.1b"))
    prompts = [np.random.default_rng(0).integers(
        0, cfg.vocab_size, (6,)).astype(np.int32)]
    spec = PS.EngineSpec(arch="tinyllama-1.1b", scaled=True, offload=True,
                         placement="host", b_max=1, max_len=64)
    ref = _serve(PS.create_engine(spec, device="cpu"), Request, prompts, 5)
    eng = PS.create_engine(dataclasses.replace(
        spec, draft_arch="tinyllama-1.1b", spec_k=2), device="cpu")
    assert isinstance(eng, OffloadedServingEngine)
    assert isinstance(eng.draft, ResidentDraft) and eng._spec_k == 2
    assert eng.draft.dev == eng.dev
    assert _serve(eng, Request, prompts, 5) == ref
    assert eng.stats["spec_steps"] > 0
    batch = np.stack([prompts[0]])
    want, _ = PS.build_lm(spec, device="cpu").generate(batch, 5)
    lm = PS.build_lm(dataclasses.replace(spec, draft_arch="tinyllama-1.1b"),
                     device="cpu")
    assert isinstance(lm.draft, ResidentDraft) and lm._spec_k == 4
    toks, stats = lm.generate(batch, 5)
    np.testing.assert_array_equal(toks, want)
    assert stats["spec_steps"] > 0


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_spec_decode_attention_matches_reference(cache_dtype):
    """The verify pass's attention against the JAX function on the same
    inputs (atol 2e-5), ragged first positions."""
    rng = np.random.default_rng(0)
    b, S, s, h, hkv, dh = 3, 24, 4, 4, 2, 16
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q, kn, vn = mk(b, s, h, dh), mk(b, s, hkv, dh), mk(b, s, hkv, dh)
    kc, vc = mk(b, S, hkv, dh), mk(b, S, hkv, dh)
    pos = np.array([0, 9, S - s], np.int32)
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    jout, jk, _ = JAT.spec_decode_attention(
        jnp.asarray(q), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos))
    t = torch.from_numpy
    pk, pv = t(kc).to(cache_dtype), t(vc).to(cache_dtype)
    out, pk, _ = PAT.spec_decode_attention(t(q), pk, pv, t(kn), t(vn),
                                           t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout, np.float32),
                               atol=2e-5)
    np.testing.assert_array_equal(pk.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_spec_decode_attention_packed_matches_reference(cache_dtype):
    """Over packed rows: the JAX function over the dequantized cache with
    ``kv_roundtrip`` (each earlier fresh row at stored precision, each
    query's own row fresh), atol 2e-5; the fresh rows written packed are
    the store codec's bytes."""
    rng = np.random.default_rng(1)
    b, S, s, h, hkv, dh = 2, 32, 3, 4, 2, 16
    F = hkv * dh
    g = kv_group(F)
    mk = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q, kn, vn = mk(b, s, h, dh), mk(b, s, hkv, dh), mk(b, s, hkv, dh)
    pos = np.array([5, 17], np.int32)
    rows = {}
    for name in ("k", "v"):
        hist = mk(b, S, F)
        hist[np.arange(S)[None, :] >= pos[:, None]] = 0.0
        p, sc = quantize_kv_rows(torch.from_numpy(hist), g)
        rows[name] = PackedRows(p, sc, g, cache_dtype, (hkv, dh))
    deq = {n: r.dequantize() for n, r in rows.items()}
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    jc = {n: jnp.asarray(d.float().numpy(), jdt) for n, d in deq.items()}
    jout, _, _ = JAT.spec_decode_attention(
        jnp.asarray(q), jc["k"], jc["v"], jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos), kv_roundtrip=kv_roundtrip_traceable)
    t = torch.from_numpy
    out = PAT.spec_decode_attention_packed(t(q), rows["k"], rows["v"],
                                           t(kn), t(vn), t(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout, np.float32),
                               atol=2e-5)
    want = quantize_kv_rows(t(kn[:, :s - 1]).to(cache_dtype).reshape(
        b, s - 1, F), g)
    for r in range(b):
        loc = slice(int(pos[r]), int(pos[r]) + s - 1)
        assert torch.equal(rows["k"].packed[r, loc], want[0][r])
        assert torch.equal(rows["k"].scale[r, loc], want[1][r])


def test_spec_k_requires_draft_arch():
    with pytest.raises(PS.SpecError, match="draft_arch"):
        PS.EngineSpec(offload=True, spec_k=3).validate()
    with pytest.raises(PS.SpecError, match="spec_k"):
        PS.EngineSpec(offload=True, draft_arch="tinyllama-1.1b",
                      spec_k=0).validate()


def test_draft_vocab_must_match_target():
    with pytest.raises(PS.SpecError, match="vocab"):
        PS.EngineSpec(arch=PCFG.name, cfg=PCFG, offload=True,
                      draft_arch="tinyllama-1.1b").validate()


def test_draft_rejected_on_resident_engine():
    with pytest.raises(PS.SpecError, match="offload"):
        PS.EngineSpec(offload=False, draft_arch="tinyllama-1.1b").validate()


def test_draft_rejected_for_moe_target():
    with pytest.raises(PS.SpecError, match="moe_ffn"):
        PS.EngineSpec(arch="mixtral-8x7b", scaled=True, offload=True,
                      draft_arch="mixtral-8x7b").validate()


def test_spec_decode_capability():
    assert PS.spec_decode_capability(PCFG) is None
    moe = dataclasses.replace(PCFG, pattern=(PB.LayerSpec(PB.ATTN, PB.MOE),),
                              moe=PB.MoEConfig(num_experts=4))
    assert PS.spec_decode_capability(moe) == "moe_ffn"
    assert PS.spec_decode_capability(
        PB.scaled_down(port_config("tinyllama-1.1b"))) is None


def test_resolve_spec_k_provenance_and_json():
    """The speculation fields resolve, stamp provenance and round-trip
    through JSON exactly as the JAX package's."""
    kw = dict(arch="tinyllama-1.1b", scaled=True, offload=True,
              draft_arch="tinyllama-1.1b")
    plan = PS.EngineSpec(**kw).resolve()
    assert plan.draft_arch == "tinyllama-1.1b" and plan.spec_k == 4
    assert plan.provenance["spec_k"].startswith("auto")
    explicit = PS.EngineSpec(**kw, spec_k=2).resolve()
    assert explicit.spec_k == 2
    assert explicit.provenance["spec_k"].startswith("explicit")
    assert "draft" in explicit.summary() and "spec_k=2" in explicit.summary()
    assert PS.ResolvedPlan.from_json(plan.to_json()) == plan
    for p, k in ((plan, None), (explicit, 2)):
        assert p.to_json() == EngineSpec(**kw, spec_k=k).resolve().to_json()


def test_resolve_drops_draft_on_resident_fallback():
    plan = PS.EngineSpec(arch="tinyllama-1.1b", scaled=True,
                         placement="device",
                         draft_arch="tinyllama-1.1b").resolve()
    assert plan.engine == "resident"
    assert plan.draft_arch is None and plan.spec_k is None
    assert "dropped" in plan.provenance["draft_arch"]
    assert PS.draft_policy_for(plan) is None


def test_draft_policy_for_plan():
    plan = PS.EngineSpec(arch="tinyllama-1.1b", scaled=True, offload=True,
                         draft_arch="tinyllama-1.1b", spec_k=3).resolve()
    dp = PS.draft_policy_for(plan)
    assert isinstance(dp, PS.DraftPolicy)
    assert dp.k == 3 and dp.arch == "tinyllama-1.1b" and dp.scaled
    assert repr(dp) == "DraftPolicy('tinyllama-1.1b'(scaled), k=3)"
    with pytest.raises(PS.SpecError, match="spec_k"):
        PS.DraftPolicy("tinyllama-1.1b", True, 0)


def test_cli_flags_round_trip():
    parser = argparse.ArgumentParser()
    PS.add_spec_args(parser)
    args = parser.parse_args(["--offload", "--draft-arch", "llama3.2-1b",
                              "--spec-k", "4"])
    spec = PS.spec_from_args(args)
    assert spec.draft_arch == "llama3.2-1b" and spec.spec_k == 4
    off = PS.spec_from_args(parser.parse_args(["--offload"]))
    assert off.draft_arch is None and off.spec_k is None


# ---------------------------------------------------------------------------
# the accept rule
# ---------------------------------------------------------------------------


def test_accept_rule_examples():
    assert accept_length([1, 2, 3], [1, 2, 3, 9]) == 3
    assert accepted_tokens([1, 2, 3], [1, 2, 3, 9]) == [1, 2, 3, 9]
    assert accepted_tokens([5, 2], [1, 2, 3]) == [1]
    assert accepted_tokens([1, 9, 3], [1, 2, 3, 4]) == [1, 2]
    assert accepted_tokens([], [7]) == [7]


if given is not None:
    @given(draft=st.lists(st.integers(0, 7), min_size=0, max_size=8),
           target=st.lists(st.integers(0, 7), min_size=9, max_size=9))
    @settings(max_examples=60, deadline=None)
    def test_accepted_tokens_property(draft, target):
        """The port's rule is the JAX package's, and its invariants hold:
        the longest matching prefix plus the bonus token, 1..k+1 tokens,
        a shorter draft never accepting more."""
        from repro.core.draft import accepted_tokens as jax_accepted
        toks = accepted_tokens(draft, target)
        assert toks == jax_accepted(draft, target)
        a = accept_length(draft, target)
        assert toks == [int(t) for t in target[:a + 1]]
        assert 1 <= len(toks) <= len(draft) + 1
        assert a == len(draft) or draft[a] != target[a]
        for cut in range(len(draft)):
            assert accept_length(draft[:cut], target) == min(a, cut)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_accepted_tokens_property():
        pass
