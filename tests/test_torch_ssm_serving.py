"""Mamba2 (SSM layers: a conv halo and an f32 state per slot) through the
port's engines, against the JAX package's on the same weights, at the
scaled config on the CPU (``ssm_cases.MAMBA2``: 2 layers, prompts of 9,
37 and 20 tokens on 2 slots, the 37-token prompt taking chunk 1):

  * ``OffloadedServingEngine``: tokens, stats and the untimed virtual
    trace (the KV_LOAD/KV_SAVE bytes of the whole state and halo leaves
    among them) equal the JAX engine's across ``kv_mode`` fp32/int4 x
    ``quant`` None/int4; the real transfer threads give the same tokens;
    a preempted slot resumes to the uninterrupted tokens;
  * the resident ``ServingEngine`` and ``KVRoundtripServingEngine`` on
    the JAX resident engine's tree, and ``quant_roundtrip_params`` on it
    bit for bit the JAX function's; the halo leaf turns f32 at the first
    decode step in both packages; a free slot's state moves during
    decode and the next prefill into the slot overwrites it, in both;
  * prompts shorter than ``d_conv - 1``: one token fills the halo with
    its row and two tokens raise ``ValueError``, in both packages and
    both engines (ROADMAP Queue 3 item 17);
  * ``PipelinedLM``: in both packages it never reads ``cfg.ssm``
    (ROADMAP Queue 3 item 15): the same units and tokens from one seed
    on scaled mamba2 and scaled jamba; at mamba2's full width both raise
    ``ZeroDivisionError``;
  * ``resolve``: ``sched="online"`` and ``stages`` dropped and a draft
    refused with the JAX plan's provenance and message; the full-width
    plans of run (u) and (v) equal the JAX ones.

Tokens and traces are held equal; no tolerance is involved."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ssm_cases as C  # noqa: E402
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
                                      from_reference_resident)
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import (KVRoundtripServingEngine,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.offload_engine import OffloadedServingEngine  # noqa: E402

CASE = C.MAMBA2
PC = CASE.pc


@pytest.mark.parametrize("kv_mode,quant", C.GRID)
def test_offloaded_matches_reference(kv_mode, quant):
    ref = C.reference(CASE, kv_mode, quant)
    eng = C.port_engine(ref)
    assert isinstance(eng, OffloadedServingEngine)
    assert [u.spec.mixer for u in eng.units] == [PB.SSM, PB.SSM]
    assert eng.kv_kinds == ref["kinds"] == [{"conv": "rep",
                                             "state": "state"}] * 2
    C.virtualize(eng, VirtualPool)
    assert C.serve(CASE, eng, Request) == ref["toks"]
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == ref["stats"][k], k
    assert C.untimed(eng.trace.to_json()) == C.untimed(ref["trace"])
    # the real transfer threads give the same tokens
    assert C.serve(CASE, C.port_engine(ref), Request) == ref["toks"]


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_state_and_halo_cross_the_link_whole(kv_mode):
    """Neither leaf packs under INT4 KV; a decode save ships each live
    slot's whole halo (bf16) and state (f32); the trace's KV bytes are
    the JAX engine's."""
    ref = C.reference(CASE, kv_mode, None)
    eng = C.port_engine(ref)
    s = PC.ssm
    d_in = s.expand * PC.d_model
    conv = (s.d_conv - 1) * (d_in + 2 * s.n_groups * s.d_state) * 2
    state = d_in * s.d_state * 4
    for j in range(len(eng.units)):
        meta = eng.kvstore.leaf_meta(j)
        assert not meta["conv"].quant and not meta["state"].quant
        assert meta["state"].dtype == torch.float32
        assert eng.kvstore.save_nbytes(j, 2) == 2 * (conv + state)
        assert eng.kvstore.load_nbytes(j, 1, 40) == conv + state
    eng.shutdown()
    evs = ref["trace"]["events"]
    saves = [e["nbytes"] for e in evs if e["kind"] == "kv_save"]
    assert set(saves) >= {conv + state, 2 * (conv + state)}


@pytest.mark.parametrize("kv_mode,quant", [("fp32", None), ("int4", "int4")])
def test_preempt_resume_matches_uninterrupted(kv_mode, quant):
    """A slot preempted mid-run spills its halo and state and resumes
    from them: every request's tokens equal the uninterrupted JAX
    run's."""
    ref = C.reference(CASE, kv_mode, quant)
    eng = C.port_engine(ref)
    assert C.serve(CASE, eng, Request, preempt_after=3) == ref["toks"]
    assert eng.stats["slot_restores"] == 1


# ---------------------------------------------------------------------------
# the resident engines
# ---------------------------------------------------------------------------

_RESIDENT = {}


def _resident_reference():
    if not _RESIDENT:
        jplan, pplan = C.plans(CASE, offload=False)
        jeng = jax_create_engine(jplan)
        params = jax.tree.map(np.asarray, jeng.params)
        toks = C.serve(CASE, jeng, JaxRequest)
        _RESIDENT.update(pplan=pplan, params=params, toks=toks,
                         conv_dtype=str(jeng.caches["pat"][0]["conv"].dtype),
                         kv_toks=C.serve(CASE, JaxKV(jplan), JaxRequest))
    return _RESIDENT


@pytest.mark.parametrize("cls", ["ServingEngine", "KVRoundtripServingEngine"])
def test_resident_matches_reference(cls):
    """Tokens equal the JAX engine's; in both packages the halo leaf,
    bf16 at build, holds f32 after the first decode step (the decode's
    concatenate promotes it), so only a halo prefilled before any decode
    step is rounded to bf16."""
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
    assert eng.caches["pat"][0]["conv"].dtype == torch.bfloat16
    assert eng.caches["pat"][0]["state"].dtype == torch.float32
    assert C.serve(CASE, eng, Request) == want
    assert ref["conv_dtype"] == "float32"
    assert eng.caches["pat"][0]["conv"].dtype == torch.float32


def test_quant_roundtrip_params_match_reference():
    """``quant_roundtrip_params`` on the JAX resident tree: bit for bit
    the JAX function's; ``conv_w`` (2-D, but gcd(4, 128) < 16), the
    (H,) vectors and the norms pass through unchanged, the five
    projections and the dense FFN go through the INT4 codec."""
    from repro.serving.offload_engine import quant_roundtrip_params as jrt
    from repro_torch.core.convert import quant_roundtrip_params
    params = _resident_reference()["params"]
    want = jax.tree.map(np.asarray, jrt(CASE.jc, params))
    got = quant_roundtrip_params(PC, params)
    tab, jtab, orig = got["pat"][0], want["pat"][0], params["pat"][0]
    assert sorted(tab) == sorted(jtab)
    for n in tab:
        np.testing.assert_array_equal(np.asarray(tab[n]), jtab[n])
    for n in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "ssm_norm",
              "norm_mixer"):
        np.testing.assert_array_equal(tab[n], orig[n])
    for n in ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj",
              "w_down"):
        assert not np.array_equal(tab[n], orig[n]), n


def _leaf(e, name, slot):
    """One slot's cache leaf (every period) as f32 numpy, from either
    package's resident engine."""
    a = e.caches["pat"][0][name]
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a, np.float32)
    return a[:, slot]


def test_free_slot_state_is_overwritten_by_the_next_prefill():
    """A decode step updates every slot's state, a free one's too, in
    both packages; the next prefill into that slot writes its halo and
    state whole: the slot then holds exactly a one-sequence prefill's
    leaves (and the two packages' within 2e-5 x max)."""
    ref = _resident_reference()
    jplan, _ = C.plans(CASE, offload=False)
    jeng = jax_create_engine(jplan)
    eng = PS.create_engine(ref["pplan"], device="cpu")
    from_reference_resident(ref["params"], eng)
    p0, p1 = C.prompts(CASE)[:2]
    for e, req in ((jeng, JaxRequest), (eng, Request)):
        e.submit(req(rid=0, prompt=p0.copy(), max_new=6))
        done = []
        for _ in range(3):
            e.step(done)
        assert e.slots[1] is None
        assert np.abs(_leaf(e, "state", 1)).max() > 0
        e._prefill_into_slot(1, req(rid=1, prompt=p1.copy(), max_new=2))
    _, jone = jeng._prefill(jeng.params, {"tokens": jnp.asarray(p1)[None]},
                            jeng.max_len)
    _, pone = eng.model.prefill(eng.params,
                                {"tokens": torch.from_numpy(p1[None])},
                                eng.max_len)
    for n in ("conv", "state"):
        want = np.asarray(jone["pat"][0][n], np.float32)[:, 0]
        np.testing.assert_array_equal(_leaf(jeng, n, 1), want)
        np.testing.assert_array_equal(
            _leaf(eng, n, 1), pone["pat"][0][n].float().numpy()[:, 0])
        np.testing.assert_allclose(_leaf(eng, n, 1), want, rtol=0,
                                   atol=2e-5 * max(1, np.abs(want).max()))
    jeng.shutdown()
    eng.shutdown()


# ---------------------------------------------------------------------------
# short prompts (ROADMAP Queue 3 item 17)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offload", [False, True])
def test_short_prompts_as_in_reference(offload):
    """A one-token prompt's halo is its one row, which the stores
    broadcast over all ``d_conv - 1`` rows (the right halo is two zero
    rows and the token's): the same tokens in both packages.  A
    two-token prompt raises ``ValueError`` in both."""
    kw = dict(kv_mode="fp32", depth=1) if offload else {}
    jplan, pplan = C.plans(CASE, offload=offload, **kw)
    prompt = np.array([5], np.int32)
    jeng = jax_create_engine(jplan)
    if offload:
        res, units, routers = C.engine_weights(jeng)
        eng = PS.create_engine(pplan, device="cpu")
        from repro_torch.core.convert import from_reference_serving
        from_reference_serving(res, units, eng, routers)
    else:
        eng = PS.create_engine(pplan, device="cpu")
        from_reference_resident(jax.tree.map(np.asarray, jeng.params), eng)
    outs = []
    for e, req in ((jeng, JaxRequest), (eng, Request)):
        e.submit(req(rid=0, prompt=prompt.copy(), max_new=4))
        outs.append([list(r.out) for r in e.run()])
    assert outs[0] == outs[1]
    for e, req in ((jeng, JaxRequest), (eng, Request)):
        e.submit(req(rid=1, prompt=np.array([5, 9], np.int32), max_new=2))
        with pytest.raises(ValueError):
            e.run()
    for e in (jeng, eng):
        try:
            e.shutdown()
        except ValueError:      # the failed save, re-raised at the drain
            pass


# ---------------------------------------------------------------------------
# PipelinedLM (ROADMAP Queue 3 item 15)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("quant,kv_mode", [(None, None), ("int4", "int4")])
def test_pipelined_lm_matches_reference(arch, quant, kv_mode):
    """Both packages' batch engines draw ``mha`` units of ``wq/wk/wv/wo``
    at ``num_heads`` x ``head_dim`` and MLP (mamba2) or MoE (jamba) units
    at ``d_ff`` and never read ``cfg.ssm``: the same buffers and tokens
    from one seed (the whole scaled stacks: 2 and 16 layers)."""
    jcfg, pcfg = scaled_down(get_config(arch)), PB.scaled_down(
        port_config(arch))
    spec = dict(arch=arch, offload=True, placement="host", b_max=2,
                max_len=64, pipeline="performance", depth=1, seed=0,
                quant=quant, kv_mode=kv_mode)
    jplan = EngineSpec(cfg=jcfg, **spec).resolve()
    jlm = jax_build_lm(jplan)
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=pcfg)
    plm = PS.build_lm(pplan, device="cpu")
    ffn = "moe" if pcfg.moe else "mlp"
    assert [u.kind for u in plm.units] == \
        [u.kind for u in jlm.units] == ["mha", ffn] * pcfg.num_layers
    keys = plm.store_keys()
    assert sorted(keys) == sorted(jlm.weights.manifests)
    mha = {n.split("#")[0] for n in plm.manifests["mha[0]"].entries}
    assert mha == {"wq", "wk", "wv", "wo", "norm"}
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 21)).astype(np.int32)
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


def test_pipelined_lm_at_full_mamba2_width_raises_as_in_reference():
    """At mamba2-1.3b's full width (d 2048, ``num_heads`` 0, ``d_ff`` 0)
    both batch engines draw an empty ``mha`` unit, then divide by
    ``d_ff`` in the first MLP unit's draw: ``ZeroDivisionError``.  The
    vocabulary is cut to 256 and the depth to one layer (the error comes
    at layer 0, before any other draw)."""
    arch = "mamba2-1.3b"
    jcfg = dataclasses.replace(get_config(arch), vocab_size=256,
                               num_layers=1, num_periods=1)
    pcfg = dataclasses.replace(port_config(arch), vocab_size=256,
                               num_layers=1, num_periods=1)
    spec = dict(arch=arch, offload=True, placement="host", b_max=2,
                max_len=64, depth=1, seed=0)
    jplan = EngineSpec(cfg=jcfg, **spec).resolve()
    pplan = PS.EngineSpec(cfg=pcfg, **spec).resolve()
    assert pplan.to_json() == jplan.to_json()
    with pytest.raises(ZeroDivisionError):
        jax_build_lm(jplan)
    with pytest.raises(ZeroDivisionError):
        PS.build_lm(pplan, device="cpu")


# ---------------------------------------------------------------------------
# resolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_capabilities_gated_as_in_reference(arch):
    """Chunked prefill, stages and speculation need a dense global
    attention stack: resolve drops ``sched="online"`` and ``stages`` for
    an SSM stack in both packages with the same provenance
    (``mixer_ssm``), both refuse a draft with the same message, and the
    port's engine refuses an attached one."""
    spec = dict(arch=arch, scaled=True, offload=True, b_max=2, max_len=48)
    for kw, field in ((dict(sched="online", prefill_chunk=4), "sched"),
                      (dict(stages=2), "stages")):
        jplan = EngineSpec(**spec, **kw).resolve()
        pplan = PS.EngineSpec(**spec, **kw).resolve()
        assert pplan.to_json() == jplan.to_json()
        assert pplan.provenance == jplan.provenance
        assert "mixer_ssm" in pplan.provenance[field], field
        assert pplan.sched == "monolithic" and pplan.stages == 1
    with pytest.raises(Exception) as jerr:
        EngineSpec(**spec, draft_arch="llama3.2-1b").resolve()
    with pytest.raises(PS.SpecError) as perr:
        PS.EngineSpec(**spec, draft_arch="llama3.2-1b").resolve()
    assert str(perr.value) == str(jerr.value)
    assert "mixer_ssm" in str(perr.value)
    eng = PS.create_engine(pplan, device="cpu")
    try:
        from fake_model import FakeDraft
        with pytest.raises(PS.UnsupportedModelError):
            eng.attach_draft(FakeDraft(256), 2)
    finally:
        eng.shutdown()


def test_full_config_plans_as_in_reference():
    """What ``chip_smoke.py`` runs (u) and (v) resolve, equal in both
    packages: mamba2-1.3b INT4 resident on the default budget and
    offloaded (host, depth 8, ``fused_int4``) with ``offload=True``;
    jamba cut to its first 5 layers, INT4: disk on the default budget,
    so (v) forces the host."""
    m = "mamba2-1.3b"
    for kw, want in ((dict(), ("resident", None)),
                     (dict(offload=True), ("offloaded", "host"))):
        jplan = EngineSpec(arch=m, quant="int4", max_len=512, **kw).resolve()
        pplan = PS.EngineSpec(arch=m, quant="int4", max_len=512,
                              **kw).resolve()
        assert pplan.to_json() == jplan.to_json()
        assert pplan.engine == want[0]
        if want[1]:
            assert (pplan.placement, pplan.depth, pplan.fused_int4) == \
                (want[1], 8, True)
    j = "jamba-1.5-large-398b"
    jcfg, pcfg = (C._cut(get_config(j), 5), C._cut(port_config(j), 5))
    for placement, want in ((None, "disk"), ("host", "host")):
        kw = dict(quant="int4", b_max=4, max_len=256)
        if placement:
            kw["placement"] = placement
        jplan = EngineSpec(arch=j, cfg=jcfg, **kw).resolve()
        pplan = PS.EngineSpec(arch=j, cfg=pcfg, **kw).resolve()
        assert pplan.to_json() == jplan.to_json()
        assert (pplan.engine, pplan.placement, pplan.depth) == \
            ("offloaded", want, 1)
