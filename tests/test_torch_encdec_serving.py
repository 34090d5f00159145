"""Whisper through the port's entry points against the JAX package's, on
the CPU at the scaled config (2 encoder and 2 decoder layers, 24 frames,
d 64):

  * ``create_engine`` resolves whisper to the resident ``ServingEngine``
    and it serves five requests on two slots (slots free and refill;
    four with seeded frames, one with the zero-frame stub) to the JAX
    ``ServingEngine``'s tokens, with the JAX tree carried across
    (``core.convert.from_reference_resident``), also with a slot
    preempted and restored (its ``ck``/``cv`` rows spill and come back);
  * ``KVRoundtripServingEngine`` on whisper equals the JAX one (only the
    ``k``/``v`` slabs round-trip; the encoder rows are kind ``"rep"``);
  * direct ``OffloadedServingEngine`` construction raises
    ``UnsupportedModelError`` as in the JAX package;
  * ``launch/serve.py --arch whisper-base --scaled`` serves the JAX
    CLI's tokens and stats keys;
  * ``build_lm``: the JAX ``PipelinedLM`` builds ``mha``/``mlp`` units
    and reads neither the encoder nor the cross weights; at
    ``rope_theta`` 0 its rope angles are NaN, so its greedy tokens are
    all 0.  The port gives the same units and tokens (ROADMAP Queue 3
    item 19).

Tokens are held equal; no tolerance is involved."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import frontend_cases as C  # noqa: E402
from repro.configs import get_config, scaled_down  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import rope as JR  # noqa: E402
from repro.serving import EngineSpec as JaxSpec  # noqa: E402
from repro.serving import spec as JS  # noqa: E402
from repro.serving.spec import build_lm as jax_build_lm  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import from_reference_resident  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.models import rope as PR  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import (KVRoundtripServingEngine,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.offload_engine import OffloadedServingEngine  # noqa: E402

ARCH = "whisper-base"


def _engine(cls=None):
    ref = C.reference(ARCH)
    eng = (cls or PS.create_engine)(ref["pplan"], device="cpu")
    from_reference_resident(ref["params"], eng)
    return ref, eng


def test_create_engine_builds_the_resident_engine():
    eng = PS.create_engine(PS.EngineSpec(**C.spec(ARCH)), device="cpu")
    assert type(eng) is ServingEngine and eng.plan.engine == "resident"
    assert "enc_dec" in eng.plan.provenance["engine"]
    leaf = eng.caches["pat"][0]
    assert leaf["ck"].shape == (eng.cfg.num_periods, C.B_MAX,
                                eng.cfg.encoder_seq_len,
                                eng.cfg.num_kv_heads, eng.cfg.head_dim)
    assert leaf["k"].shape[2] == C.MAX_LEN
    assert set(eng.params["enc"]) == {"pat", "final_norm"}


def test_resident_matches_reference():
    ref, eng = _engine()
    assert C.serve(eng, Request) == ref["toks"]
    assert eng.stats["prefills"] == len(C.PROMPT_LENS) > C.B_MAX
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == ref["stats"][k], k


def test_frames_change_the_tokens():
    """The frames reach the decoder: the same prompt with the zero stub
    and with seeded frames decodes differently (so the equality above
    holds the encoder and the cross attention too)."""
    _, eng = _engine()
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, eng.cfg.vocab_size, (6,)).astype(np.int32)
    enc = 3.0 * rng.standard_normal(
        (eng.cfg.encoder_seq_len, eng.cfg.d_model)).astype(np.float32)
    b1 = eng._prefill_batch(Request(rid=0, prompt=prompt))
    b2 = eng._prefill_batch(Request(rid=1, prompt=prompt, enc_embeds=enc))
    assert not b1["enc_embeds"].any()
    x1 = eng.model.prefill(eng.params, b1, C.MAX_LEN)[1]
    x2 = eng.model.prefill(eng.params, b2, C.MAX_LEN)[1]
    # layer 0's self-attention rows come before any cross attention
    assert torch.equal(x1["pat"][0]["k"][0], x2["pat"][0]["k"][0])
    assert not torch.equal(x1["pat"][0]["k"][1], x2["pat"][0]["k"][1])
    assert not torch.equal(x1["pat"][0]["ck"], x2["pat"][0]["ck"])


def test_preempt_restore_matches_uninterrupted():
    """A slot preempted mid-run spills its rows, the encoder's ``ck``/
    ``cv`` among them, and resumes to the same tokens."""
    ref, eng = _engine()
    assert C.serve(eng, Request, preempt_after=3) == ref["toks"]
    assert eng.stats["slot_restores"] == 1
    names = [n for _, _, n, _ in eng._leaves(eng.caches)]
    assert names[:4] == ["ck", "cv", "k", "v"]


def test_kv_roundtrip_matches_reference():
    ref, eng = _engine(KVRoundtripServingEngine)
    assert eng._kv_kinds["pat"][0] == {"k": "kv", "v": "kv", "ck": "rep",
                                       "cv": "rep"}
    assert C.serve(eng, Request) == ref["kv_toks"]


def test_offloaded_engine_refuses_as_in_reference():
    plan = dataclasses.replace(C.reference(ARCH)["pplan"], engine="offloaded")
    with pytest.raises(PS.UnsupportedModelError) as e:
        OffloadedServingEngine(plan, device="cpu")
    assert e.value.capability == "enc_dec"
    jplan = dataclasses.replace(JaxSpec(**C.spec(ARCH)).resolve(),
                                engine="offloaded")
    from repro.serving.offload_engine import OffloadedServingEngine as JOff
    with pytest.raises(JS.UnsupportedModelError) as je:
        JOff(jplan)
    assert je.value.capability == e.value.capability


def test_cli_serves_the_reference_tokens(monkeypatch, capsys):
    argv = ["--arch", ARCH, "--scaled", "--requests", "3"]
    params = {}
    j = C.cli(jserve, JS, argv, monkeypatch, after=lambda eng: params.update(
        tree=jax.tree.map(np.asarray, eng.params)))
    jout = capsys.readouterr().out
    p = C.cli(pserve, PS, argv + ["--device", "cpu"], monkeypatch,
              after=lambda eng: from_reference_resident(params["tree"], eng))
    pout = capsys.readouterr().out
    assert p["out"] == j["out"] and len(p["out"]) == 3
    assert sorted(p["eng"].stats) == sorted(j["eng"].stats)
    assert "completed=3 tokens=24" in pout and "completed=3 tokens=24" in jout
    assert pout.splitlines()[0] == jout.splitlines()[0]      # the plan line


def test_rope_at_theta_zero_is_nan_in_both():
    """The source of the batch engine's zero tokens: 1 / 0**(i / half)
    is infinite for i > 0, so position 0's angle there is 0 x inf = NaN
    and every later position's is inf, whose cos and sin are NaN: every
    rotated q and k is NaN past its first slot pair, in both packages."""
    pos = np.arange(4, dtype=np.int32)
    j = np.asarray(JR.rope_angles(jnp.asarray(pos), 16, 0.0))
    p = PR.rope_angles(torch.from_numpy(pos), 16, 0.0).numpy()
    np.testing.assert_array_equal(p, j)
    assert np.isnan(p[0, 1:]).all() and np.isinf(p[1:, 1:]).all()
    assert np.isfinite(p[:, 0]).all()
    x = np.ones((1, 4, 2, 16), np.float32)
    jx = np.asarray(JR.apply_rope(jnp.asarray(x), jnp.asarray(j)))
    px = PR.apply_rope(torch.from_numpy(x), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isnan(px), np.isnan(jx))
    assert np.isnan(px[..., 1:8]).all() and np.isnan(px[..., 9:]).all()


def test_pipelined_lm_matches_reference():
    jcfg, pcfg = scaled_down(get_config(ARCH)), PB.scaled_down(
        port_config(ARCH))
    spec = dict(arch=ARCH, offload=True, placement="host", b_max=2,
                max_len=32, pipeline="performance", depth=1, seed=0)
    jplan = JaxSpec(cfg=jcfg, **spec).resolve()
    jlm = jax_build_lm(jplan)
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=pcfg)
    plm = PS.build_lm(pplan, device="cpu")
    assert [u.kind for u in plm.units] == [u.kind for u in jlm.units] == \
        ["mha", "mlp"] * pcfg.num_layers
    assert sorted(plm.store_keys()) == sorted(jlm.weights.manifests)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jtoks, _ = jlm.generate(prompt, 4)
    ptoks, _ = plm.generate(prompt, 4)
    np.testing.assert_array_equal(ptoks, np.asarray(jtoks))
    assert not np.asarray(ptoks).any()
