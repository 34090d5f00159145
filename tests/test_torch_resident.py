"""The port's resident serving engines against the JAX package's, on the
CPU at ``scaled_down`` sizes: ``ServingEngine`` and
``KVRoundtripServingEngine`` with the JAX engine's parameter tree loaded
(``core/convert.from_reference_resident``) serve ragged requests, more
than the slots, to the JAX engines' greedy tokens, on tinyllama and on
llama3.2-1b (tied embeddings), also with a slot preempted and resumed.
Inside the port, the resident engines' tokens equal the offloaded
engine's bit for bit (the JAX package's own invariant,
``tests/test_serving_offload.py``).  ``AdaptiveDepth`` re-sizes the
window step by step exactly as the JAX engine does on a virtual clock
whose link charges a fixed bandwidth.  Tolerances: tokens and depths
exact; prefill cache rows within 2e-5 (f32 attention sums in another
order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.core.pipeline import VirtualPool as JaxVirtualPool  # noqa: E402
from repro.core.tasks import Trace as JaxTrace  # noqa: E402
from repro.core.tasks import VirtualClock as JaxVirtualClock  # noqa: E402
from repro.core.transfer import split_views  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineSpec as JaxSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving.engine import KVRoundtripServingEngine as JaxKV  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import (from_reference_resident,  # noqa: E402
                                      from_reference_serving)
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.core.tasks import Trace, VirtualClock  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import (KVRoundtripServingEngine,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.offload_engine import OffloadedServingEngine  # noqa: E402
from repro_torch.serving.spec import (AdaptiveDepth, EngineSpec,  # noqa: E402
                                      ResolvedPlan, create_engine)

ARCHS = ("tinyllama-1.1b", "llama3.2-1b")
B_MAX, MAX_LEN = 2, 64
PROMPT_LENS = (6, 11, 6, 11, 6)          # few lengths: few JAX prefill compiles
MAX_NEW = (7, 4, 9, 3, 6)


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in PROMPT_LENS]


def _serve(eng, req_cls, preempt_after=None):
    """Submit every request and drive ``step`` to idle; with
    ``preempt_after``, the first occupied slot is preempted after that
    many steps and resumes from its spilled rows."""
    for i, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=n))
    done, steps = [], 0
    while not eng.idle():
        eng.step(done)
        steps += 1
        if steps == preempt_after:
            eng.preempt_slot(next(i for i, r in enumerate(eng.slots)
                                  if r is not None))
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


def _spec(arch, **kw):
    return dict(arch=arch, scaled=True, b_max=B_MAX, max_len=MAX_LEN,
                seed=0, **kw)


_RUNS = {}


def _reference(arch):
    """The JAX resident and KV-roundtrip engines' tokens and the resident
    parameter tree as numpy arrays, once per architecture."""
    if arch not in _RUNS:
        jplan = JaxSpec(**_spec(arch, offload=False)).resolve()
        jeng = jax_create_engine(jplan)
        params = jax.tree.map(np.asarray, jeng.params)
        toks = _serve(jeng, JaxRequest)
        stats = dict(jeng.stats)
        kv_toks = _serve(JaxKV(jplan), JaxRequest)
        _RUNS[arch] = dict(pplan=ResolvedPlan.from_json(jplan.to_json()),
                           params=params, toks=toks, kv_toks=kv_toks,
                           stats=stats)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_matches_reference(arch):
    ref = _reference(arch)
    eng = create_engine(ref["pplan"], device="cpu")
    assert type(eng) is ServingEngine
    from_reference_resident(ref["params"], eng)
    assert _serve(eng, Request) == ref["toks"]
    assert eng.stats["prefills"] == len(PROMPT_LENS) > B_MAX
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == ref["stats"][k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_roundtrip_matches_reference(arch):
    ref = _reference(arch)
    eng = KVRoundtripServingEngine(ref["pplan"], device="cpu")
    from_reference_resident(ref["params"], eng)
    assert _serve(eng, Request) == ref["kv_toks"]


@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_resume_matches_uninterrupted(arch):
    """Preempt a slot mid-run: its rows spill to the host and come back
    into a slot, and no token changes."""
    ref = _reference(arch)
    eng = create_engine(ref["pplan"], device="cpu")
    from_reference_resident(ref["params"], eng)
    assert _serve(eng, Request, preempt_after=3) == ref["toks"]
    assert eng.stats["slot_restores"] == 1


@pytest.mark.parametrize("kv_mode,depth", [("fp32", 1), ("fp32", 2),
                                           ("int4", 1), ("int4", 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_resident_equals_offloaded(arch, kv_mode, depth):
    """Inside the port, on its own weights from one seed: the offloaded
    engine's tokens equal the resident engine's (``kv_mode="fp32"``) or
    the KV-roundtrip reference's (``kv_mode="int4"``) bit for bit."""
    res_cls = ServingEngine if kv_mode == "fp32" else \
        KVRoundtripServingEngine
    res = res_cls(EngineSpec(**_spec(arch, offload=False)).resolve(),
                  device="cpu")
    off = create_engine(EngineSpec(**_spec(
        arch, offload=True, kv_mode=kv_mode, depth=depth,
        quant=None)).resolve(), device="cpu")
    assert isinstance(off, OffloadedServingEngine)
    assert _serve(off, Request) == _serve(res, Request)


def test_init_draws_per_unit():
    """The resident tree and the offloaded engine's unit-at-a-time draws
    hold the same numbers (``table_params`` per unit, ``draw_tables``
    on threads, ``init_params`` stacked)."""
    cfg = PB.scaled_down(port_config("tinyllama-1.1b"))
    tree = PT.init_params(cfg, 3)
    for (part, q, p), t in PT.draw_tables(cfg, 3, PT.table_keys(cfg),
                                          workers=2):
        for name, a in t.items():
            np.testing.assert_array_equal(tree[part][q][name][p], a)
    emb = PT.table_params(cfg, 3, "embed")
    np.testing.assert_array_equal(emb["emb"], tree["embed"]["emb"])
    assert not np.array_equal(tree["pat"][0]["wq"][0],
                              tree["pat"][0]["wq"][1])
    assert tree["pat"][0]["norm_mixer"].max() == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_decode_match_reference(arch):
    """``models.transformer.prefill``/``decode_step`` against the JAX
    functions on the same parameters: the same next tokens, and the
    prefill cache slabs within 2e-5 (zeros past the prompt)."""
    jcfg, pcfg = scaled_down(get_config(arch)), PB.scaled_down(
        port_config(arch))
    params = _reference(arch)["params"]
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(
        np.int32)
    jnt, jc = JT.prefill(params, {"tokens": jnp.asarray(tokens)}, jcfg,
                         Dist.local(), MAX_LEN)
    pnt, pc = PT.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, pcfg,
                         MAX_LEN)
    np.testing.assert_array_equal(pnt.numpy(), np.asarray(jnt))
    for n in ("k", "v"):
        np.testing.assert_allclose(pc["pat"][0][n].numpy(),
                                   np.asarray(jc["pat"][0][n]), atol=2e-5,
                                   rtol=0)
        assert (pc["pat"][0][n][:, :, 9:] == 0).all()
    # a decode step at ragged positions over bf16 caches
    jcache = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jc)
    pcache = {g: tuple({n: c.bfloat16() for n, c in t.items()}
                       for t in pc[g]) for g in ("pat", "rem")}
    pos = np.array([9, 4], np.int32)
    tok = np.asarray(jnt)[:, None]
    jnt2, _ = JT.decode_step(params, {"token": jnp.asarray(tok),
                                      "pos": jnp.asarray(pos)}, jcache,
                             jcfg, Dist.local())
    pnt2, pcache2 = PT.decode_step(tparams, {"token": torch.from_numpy(tok),
                                             "pos": torch.from_numpy(pos)},
                                   pcache, pcfg)
    np.testing.assert_array_equal(pnt2.numpy(), np.asarray(jnt2))
    assert pcache2 is pcache and (pcache["pat"][0]["k"][:, 1, 4] != 0).any()


# ---------------------------------------------------------------------------
# AdaptiveDepth on a virtual clock
# ---------------------------------------------------------------------------

SIM_BW = 2e6                  # the simulated link: bytes per virtual second


def _link_cost():
    """Per-task virtual cost: a transfer takes its bytes over ``SIM_BW``,
    slowed 6x from the 30th weight load and 2x faster than nominal from
    the 70th (the link the adaptive window must follow); compute 2 ms."""
    loads = [0]

    def cost(task):
        kind = task.kind.value
        if kind == "weight_load":
            loads[0] += 1
        if kind in ("weight_load", "kv_load", "kv_save"):
            slow = 1.0 if loads[0] < 30 else 6.0 if loads[0] < 70 else 0.5
            return slow * task.nbytes / SIM_BW
        return 2e-3
    return cost


def _virtual_depths(eng, pool_cls, trace_cls, clock_cls):
    """Run ``eng`` on a fresh virtual-clock pool and trace; returns the
    list the window's per-step depths are recorded into."""
    n = eng.sched.pool.n_workers
    eng.sched.pool.shutdown()
    clock = clock_cls()
    trace = trace_cls(clock=clock)
    eng.trace = eng.sched.trace = trace
    eng.sched.pool = eng._kv_pool = pool_cls(n, trace=trace,
                                             cost_fn=_link_cost(),
                                             clock=clock)
    depths, set_depth = [], eng.sched.set_depth
    eng.sched.set_depth = lambda d: depths.append(set_depth(d)) or depths[-1]
    return depths


def test_adaptive_depth_matches_reference():
    """Six layers, INT4 weights and KV: the JAX and the port's offloaded
    engines, the port on the JAX weights, re-size the window to the same
    depth at every decode step and give the same tokens; the sequence
    deepens and shrinks as the link slows and recovers."""
    kw = dict(num_layers=6, num_periods=6)
    jcfg = scaled_down(get_config("tinyllama-1.1b"), **kw)
    pcfg = PB.scaled_down(port_config("tinyllama-1.1b"), **kw)
    spec = JaxSpec(arch="tinyllama-6l", cfg=jcfg, offload=True,
                   placement="host", b_max=B_MAX, max_len=MAX_LEN,
                   quant="int4", kv_mode="int4", depth_policy="adaptive",
                   sim_bw=SIM_BW * 1e3, seed=0)
    jplan = spec.resolve()
    pplan = dataclasses.replace(ResolvedPlan.from_json(jplan.to_json()),
                                cfg=pcfg)
    jeng = jax_create_engine(jplan)
    resident = {part: {n: np.asarray(a) for n, a in
                       jeng.resident[part].items()}
                for part in ("embed", "final_norm")}
    units = {u.key: {n: np.array(a) for n, a in split_views(
        jeng.host.get(u.key), jeng.weights.manifests[u.key]).items()}
        for u in jeng.units}
    jd = _virtual_depths(jeng, JaxVirtualPool, JaxTrace, JaxVirtualClock)
    jtoks = _serve(jeng, JaxRequest)
    peng = create_engine(pplan, device="cpu")
    assert isinstance(peng.preload_policy, AdaptiveDepth)
    from_reference_serving(resident, units, peng)
    pd = _virtual_depths(peng, VirtualPool, Trace, VirtualClock)
    assert _serve(peng, Request) == jtoks
    assert pd == jd and len(pd) == peng.stats["decode_steps"]
    assert len(set(pd)) >= 3, pd
    for k in ("preload_depth", "depth_resizes", "tokens_out"):
        assert peng.stats[k] == jeng.stats[k], k


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_create_engine_takes_a_spec_and_dispatches():
    eng = create_engine(EngineSpec(**_spec("tinyllama-1.1b")), device="cpu")
    assert type(eng) is ServingEngine and eng.plan.engine == "resident"
    enc = create_engine(EngineSpec(**_spec("whisper-base")), device="cpu")
    assert type(enc) is ServingEngine and enc.plan.engine == "resident"
    assert "ck" in enc.caches["pat"][0] and "enc" in enc.params
    moe = create_engine(EngineSpec(**_spec("mixtral-8x7b",
                                           moe_quant="int4")), device="cpu")
    assert type(moe) is ServingEngine and "w_gate#q" in moe.params["pat"][0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_engine(EngineSpec(**_spec("tinyllama-1.1b")))


@pytest.mark.parametrize("argv", [
    ["--arch", "tinyllama-1.1b"],
    ["--arch", "llama3.2-1b", "--offload", "--quant", "int4", "--kv-mode",
     "int4", "--depth-policy", "adaptive"]], ids=["resident", "adaptive"])
def test_serve_cli_serves(argv, capsys):
    """``launch.serve`` end to end on the CPU at the scaled size: every
    request completes, and an offloaded plan prints its pipeline line."""
    eng = pserve.main(argv + ["--scaled", "--requests", "3", "--device",
                              "cpu"])
    out = capsys.readouterr().out
    assert "completed=3 tokens=24" in out and out.startswith("plan: ")
    assert ("pipeline[performance] depth=" in out) == ("--offload" in argv)
    assert eng.stats["tokens_out"] == 24
