"""Qwen2-VL's M-RoPE in the port against the JAX package, on the CPU at
the scaled config (2 layers, d 64, 4/2 heads of 16, sections (4, 2, 2)),
on the same numpy-seeded inputs:

  * ``rope_angles`` with sections at distinct (t, h, w) positions (rtol
    1e-6), and at equal components bit-equal to 1-D rope;
  * ``_angles`` at a prompt's positions and at ragged ``(b, 1)`` decode
    positions (rtol 1e-6);
  * the whole-model ``prefill`` and ``decode_step`` with a token batch and
    with an ``"embeds"`` batch: hidden states within 1e-4 x max (f32
    prefill) and 2e-2 x max (decode over bf16 caches), equal next tokens;
  * ``create_engine`` resolves qwen2-vl to the resident ``ServingEngine``,
    which serves the JAX ``ServingEngine``'s tokens (five requests on two
    slots, and with a slot preempted and restored);
  * ``launch/serve.py --arch qwen2-vl-72b --scaled`` serves the JAX CLI's
    tokens and stats keys;
  * ``build_lm``: the same units and tokens as the JAX ``PipelinedLM``,
    which runs 1-D rope (ROADMAP Queue 3 item 19).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import frontend_cases as C  # noqa: E402
from repro.configs import get_config, scaled_down  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rope as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineSpec as JaxSpec  # noqa: E402
from repro.serving import spec as JS  # noqa: E402
from repro.serving.spec import build_lm as jax_build_lm  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import from_reference_resident  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.models import rope as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "qwen2-vl-72b"
JC = scaled_down(get_config(ARCH))
PC = PB.scaled_down(port_config(ARCH))
SECTIONS = PC.mrope_sections
DH, D = PC.head_dim, PC.d_model
BF16_REL = 2e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 11), (3, 2, 7)])
@pytest.mark.parametrize("cfg", ["scaled", "full"])
def test_mrope_angles_match_reference_at_distinct_positions(shape, cfg):
    """Each section rotates by its own component: t, h and w distinct."""
    c = PC if cfg == "scaled" else port_config(ARCH)
    pos = np.random.default_rng(2).integers(0, 4096, shape).astype(np.int32)
    want = np.asarray(JR.rope_angles(jnp.asarray(pos), c.head_dim,
                                     c.rope_theta, c.mrope_sections))
    got = PR.rope_angles(torch.from_numpy(pos), c.head_dim, c.rope_theta,
                         c.mrope_sections).numpy()
    assert got.shape == shape[1:] + (c.head_dim // 2,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # section i takes component i: change h, and only its slots move
    pos2 = pos.copy()
    pos2[1] += 1
    moved = PR.rope_angles(torch.from_numpy(pos2), c.head_dim, c.rope_theta,
                           c.mrope_sections).numpy() != got
    t, h, _ = c.mrope_sections
    assert moved[..., t:t + h].all()
    assert not moved[..., :t].any() and not moved[..., t + h:].any()


def test_mrope_at_equal_components_is_1d_rope():
    pos = torch.arange(40, dtype=torch.int32)
    one = PR.rope_angles(pos, DH, PC.rope_theta)
    three = PR.rope_angles(pos.expand(3, 40), DH, PC.rope_theta, SECTIONS)
    assert torch.equal(one, three)
    want = np.asarray(JR.rope_angles(jnp.broadcast_to(jnp.arange(40),
                                                      (3, 40)),
                                     DH, PC.rope_theta, SECTIONS))
    np.testing.assert_allclose(three.numpy(), want, rtol=1e-6, atol=0)


def test_mrope_rejects_bad_positions():
    with pytest.raises(ValueError, match="positions"):
        PR.rope_angles(torch.arange(5), DH, PC.rope_theta, SECTIONS)
    with pytest.raises(ValueError, match="sections"):
        PR.rope_angles(torch.zeros(3, 5, dtype=torch.int32), DH,
                       PC.rope_theta, (4, 2, 1))


@pytest.mark.parametrize("positions", [list(range(9)), [[5], [0], [17]],
                                       [3]])
def test_angles_match_reference(positions):
    """A prompt's positions, ragged (b, 1) decode positions and an int
    decode position's (1,)."""
    pos = np.array(positions, np.int32)
    want = np.asarray(JT._angles(JC, jnp.asarray(pos)))
    got = PT._angles(PC, torch.from_numpy(pos)).numpy()
    assert got.shape == pos.shape + (DH // 2,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _tree():
    tree = jax.tree.map(np.asarray, JT.init_params(
        JC, jax.random.PRNGKey(0), jnp.float32))
    return (jax.tree.map(jnp.asarray, tree),
            PT.to_device(jax.tree.map(np.array, tree), "cpu"))


def _jax_hidden(jp, batch, mode, caches=None):
    """The reference's ``prefill``/``decode_step`` body up to the final
    norm (the hidden states the port's ``_head`` takes)."""
    key = "embeds" if "embeds" in batch else (
        "tokens" if mode == "prefill" else "token")
    b, s = batch[key].shape[:2]
    if mode == "prefill":
        angles, pos = JT._angles(JC, jnp.arange(s)), None
    else:
        pos = batch["pos"]
        angles, s = JT._angles(JC, pos[:, None]), 1
    ctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode=mode, angles=angles,
                 pos=pos, batch_size=b)
    x = JT._inputs_to_x(jp, JC, ctx, batch)
    x, _, _ = JT._run_stack(jp, x, ctx, caches, JC, JC.pattern,
                            JC.remainder, remat=False)
    return x


@pytest.mark.parametrize("inputs", ["tokens", "embeds"])
def test_whole_model_matches_reference(inputs, monkeypatch):
    jp, pp = _tree()
    rng = np.random.default_rng(41)
    b, s, L = 2, 9, 32
    if inputs == "tokens":
        a = rng.integers(0, PC.vocab_size, (b, s)).astype(np.int32)
        d = rng.integers(0, PC.vocab_size, (b, 1)).astype(np.int32)
        pk, dk = "tokens", "token"
    else:
        a = rng.standard_normal((b, s, D)).astype(np.float32)
        d = rng.standard_normal((b, 1, D)).astype(np.float32)
        pk, dk = "embeds", "embeds"
    seen, head = [], PT._head

    def grab(params, x, cfg):
        seen.append(x)
        return head(params, x, cfg)
    monkeypatch.setattr(PT, "_head", grab)
    jtok, jcache = JT.prefill(jp, {pk: jnp.asarray(a)}, JC, Dist.local(), L)
    ptok, pcache = PT.prefill(pp, {pk: torch.from_numpy(a)}, PC, L)
    assert _rel(seen[-1].numpy(), _jax_hidden(jp, {pk: jnp.asarray(a)},
                                              "prefill")) <= 1e-4
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    jbf = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jcache)
    pbf = {g: tuple({n: torch.from_numpy(np.asarray(
        t.astype(jnp.float32))).to(torch.bfloat16) for n, t in tab.items()}
        for tab in jbf[g]) for g in ("pat", "rem")}
    pos = np.array([s, 4], np.int32)
    jd = {dk: jnp.asarray(d), "pos": jnp.asarray(pos)}
    jtok2, _ = JT.decode_step(jp, jd, jbf, JC, Dist.local())
    ptok2, _ = PT.decode_step(pp, {dk: torch.from_numpy(d),
                                   "pos": torch.from_numpy(pos)}, pbf, PC)
    assert _rel(seen[-1].numpy(), _jax_hidden(jp, jd, "decode", jbf)) \
        <= BF16_REL
    np.testing.assert_array_equal(ptok2.numpy(), np.asarray(jtok2))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _engine():
    ref = C.reference(ARCH)
    eng = PS.create_engine(ref["pplan"], device="cpu")
    from_reference_resident(ref["params"], eng)
    return ref, eng


def test_resident_matches_reference():
    ref, eng = _engine()
    assert type(eng) is ServingEngine and eng.plan.engine == "resident"
    assert "embeds" in eng.plan.provenance["engine"]
    assert C.serve(eng, Request) == ref["toks"]
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == ref["stats"][k], k


def test_preempt_restore_matches_uninterrupted():
    ref, eng = _engine()
    assert C.serve(eng, Request, preempt_after=3) == ref["toks"]
    assert eng.stats["slot_restores"] == 1


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


def test_pipelined_lm_matches_reference():
    spec = dict(arch=ARCH, offload=True, placement="host", b_max=2,
                max_len=32, pipeline="performance", depth=1, seed=0)
    jplan = JaxSpec(cfg=JC, **spec).resolve()
    jlm = jax_build_lm(jplan)
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=PC)
    plm = PS.build_lm(pplan, device="cpu")
    assert [u.kind for u in plm.units] == [u.kind for u in jlm.units] == \
        ["mha", "mlp"] * PC.num_layers
    prompt = np.random.default_rng(1).integers(
        0, JC.vocab_size, (2, 7)).astype(np.int32)
    jtoks, _ = jlm.generate(prompt, 4)
    ptoks, _ = plm.generate(prompt, 4)
    np.testing.assert_array_equal(ptoks, np.asarray(jtoks))
