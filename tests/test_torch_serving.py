"""The port's serving stack against the JAX package's, on the scaled-down
tinyllama config: ``OffloadedServingEngine`` built from the same resolved
plan, with the JAX engine's weights loaded into it
(``core/convert.from_reference_serving``), serves the same requests —
ragged prompts, more requests than slots, so slots free and refill and
positions go ragged — to the same greedy tokens, across kv_mode {fp32,
int4} x quant {None, int4} at preload depth 1 and 2.  On a virtual-clock
pool both engines record the same trace, task for task and byte for
byte.  Preempting a slot and resuming it changes no token.  The layer
math (``models/layers.py``) matches ``apply_layer`` unit by unit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.core.pipeline import VirtualPool as JaxVirtualPool  # noqa: E402
from repro.core.transfer import split_views  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import from_reference_serving  # noqa: E402
from repro_torch.core.kvstore import (PackedRows, kv_group,  # noqa: E402
                                      quantize_kv_rows)
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.offload_engine import OffloadedServingEngine  # noqa: E402
from repro_torch.serving.spec import (ResolvedPlan, SpecError,  # noqa: E402
                                      UnsupportedModelError, create_engine)

JCFG = scaled_down(get_config("tinyllama-1.1b"))
PCFG = PB.scaled_down(port_config("tinyllama-1.1b"))
B_MAX, MAX_LEN = 2, 64
PROMPT_LENS = (6, 11, 6, 11, 6)          # few lengths: few JAX prefill compiles
MAX_NEW = (7, 4, 9, 3, 6)
GRID = [  # kv_mode, quant, depth
    ("fp32", None, 1), ("fp32", "int4", 2),
    ("int4", None, 2), ("int4", "int4", 1),
]


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, JCFG.vocab_size, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _plans(kv_mode, quant, depth, **kw):
    spec = EngineSpec(arch=JCFG.name, scaled=True, offload=True,
                      placement="host", b_max=B_MAX, max_len=MAX_LEN,
                      pipeline="performance", quant=quant, kv_mode=kv_mode,
                      depth=depth, seed=0, **kw)
    jplan = spec.resolve()
    return jplan, ResolvedPlan.from_json(jplan.to_json())


def _virtualize(eng, pool_cls):
    """Run an engine's transfers on a virtual-clock pool (deterministic
    trace): replaces the scheduler's and the slot spills' pool."""
    n = eng.sched.pool.n_workers
    eng.sched.pool.shutdown()
    pool = pool_cls(n, trace=eng.trace)
    eng.sched.pool = eng._kv_pool = pool


def _serve(eng, req_cls):
    for i, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=n))
    done = eng.run()
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


_RUNS = {}


def _reference(kv_mode, quant, depth):
    """The JAX engine's run on a virtual pool (tokens, trace JSON) and its
    weights as numpy arrays, computed once per configuration."""
    key = (kv_mode, quant, depth)
    if key not in _RUNS:
        jplan, pplan = _plans(kv_mode, quant, depth)
        jeng = jax_create_engine(jplan)
        res = {part: {n: np.asarray(a) for n, a in jeng.resident[part].items()}
               for part in ("embed", "final_norm")}
        units = {u.key: {n: np.array(a) for n, a in split_views(
            jeng.host.get(u.key), jeng.weights.manifests[u.key]).items()}
            for u in jeng.units}
        _virtualize(jeng, JaxVirtualPool)
        toks = _serve(jeng, JaxRequest)
        _RUNS[key] = dict(pplan=pplan, resident=res, units=units, toks=toks,
                          trace=jeng.trace.to_json(), depth=jeng.sched.depth,
                          stats=dict(jeng.stats))
    return _RUNS[key]


def _port_engine(ref, **plan_kw):
    eng = create_engine(dataclasses.replace(ref["pplan"], **plan_kw),
                        device="cpu")
    from_reference_serving(ref["resident"], ref["units"], eng)
    return eng


@pytest.mark.parametrize("kv_mode,quant,depth", GRID)
def test_serving_matches_reference(kv_mode, quant, depth):
    ref = _reference(kv_mode, quant, depth)
    eng = _port_engine(ref)
    assert eng.sched.depth == ref["depth"]
    assert eng.kvstore.kv_mode == kv_mode
    _virtualize(eng, VirtualPool)
    assert _serve(eng, Request) == ref["toks"]
    assert eng.stats["prefills"] == len(PROMPT_LENS) > B_MAX
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == ref["stats"][k], k
    # the same schedule, task for task: names, kinds, bytes, live extents
    # (the timestamps are virtual, offset by each trace's wall-clock origin)
    untimed = lambda tr: [{k: v for k, v in e.items()
                           if k not in ("t_start", "t_end")}
                          for e in tr["events"]]
    assert untimed(eng.trace.to_json()) == untimed(ref["trace"])
    per_kind = eng.trace.report()["per_kind"]
    assert per_kind["kv_load"]["bytes"] > 0 and per_kind["kv_save"]["bytes"]
    # and on the real transfer threads, the same tokens
    assert _serve(_port_engine(ref), Request) == ref["toks"]


@pytest.mark.parametrize("kv_mode,depth", [("fp32", 1), ("int4", 2)])
def test_preempt_resume_matches_uninterrupted(kv_mode, depth):
    """Preempt a slot mid-run, let it resume from its spilled rows
    (packed rows spill packed): every request's tokens equal the
    uninterrupted run's."""
    ref = _reference(kv_mode, "int4" if kv_mode == "fp32" else None, depth)
    eng = _port_engine(ref)
    for i, (p, n) in enumerate(zip(_prompts(), MAX_NEW)):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=n))
    done = []
    for _ in range(3):
        eng.step(done)
    eng.preempt_slot(0)
    while not eng.idle():
        eng.step(done)
    eng.shutdown()
    assert {r.rid: r.out for r in done} == ref["toks"]
    assert eng.stats["slot_restores"] == 1


def test_entry_points_default_to_cuda():
    """Without a card, the serving entry points raise unless asked for
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    _, pplan = _plans("int4", "int4", 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_engine(pplan)
    with pytest.raises(RuntimeError, match="CUDA"):
        OffloadedServingEngine(pplan)


def test_gates_name_later_slices():
    """Device-resident INT4 KV still raises; chunked prefill
    (``sched="online"|"offline"``), pipeline stages, speculation and MoE
    stacks now build (an unknown draft arch is a plan error)."""
    _, pplan = _plans("fp32", None, 1)
    rp = lambda **kw: dataclasses.replace(pplan, **kw)
    with pytest.raises(NotImplementedError):
        create_engine(rp(kv_mode="int4", cache_on="device"), device="cpu")
    with pytest.raises(SpecError):
        create_engine(rp(draft_arch="x", spec_k=2), device="cpu")
    eng = create_engine(rp(stages=2), device="cpu")
    assert eng.n_stages == 2
    eng.shutdown()
    for sched, cls in (("online", "OnlineSLO"),
                       ("offline", "OfflineThroughput")):
        eng = create_engine(rp(sched=sched, prefill_chunk=4), device="cpu")
        assert type(eng.sched_policy).__name__ == cls
        assert eng.sched_policy.chunk_cap() == 4
        eng.shutdown()
    moe = dataclasses.replace(PCFG, pattern=(PB.LayerSpec(PB.ATTN, PB.MOE),),
                              moe=PB.MoEConfig(num_experts=2,
                                               expert_d_ff=64))
    eng = create_engine(rp(cfg=moe), device="cpu")
    assert all(u.moe and len(u.expert_keys) == 2 for u in eng.units)
    eng.shutdown()
    with pytest.raises(UnsupportedModelError):
        create_engine(rp(cfg=dataclasses.replace(PCFG, rope_theta=0.0)),
                      device="cpu")
    with pytest.raises(TypeError):
        create_engine(PCFG, device="cpu")


@pytest.mark.parametrize("quant", [None, "int4"])
def test_own_init_lays_out_the_reference_buffers(quant):
    """Without reference weights the port draws its own: the same unit
    keys, manifests (names, shapes, dtypes, offsets) and resident shapes
    as the JAX engine, and a run gives in-range tokens."""
    ref = _reference("fp32", "int4", 2) if quant else \
        _reference("fp32", None, 1)
    eng = create_engine(ref["pplan"], device="cpu")
    assert [u.key for u in eng.units] == sorted(ref["units"])
    for u in eng.units:
        got = {n: (tuple(s), np.dtype(d)) for n, (_, s, d) in
               eng.weights.manifests[u.key].entries.items()}
        want = {n: (a.shape, a.dtype) for n, a in ref["units"][u.key].items()}
        assert got == want
    for part, tab in ref["resident"].items():
        assert {n: tuple(t.shape) for n, t in eng.resident[part].items()} \
            == {n: a.shape for n, a in tab.items()}
    toks = _serve(eng, Request)
    assert sorted(toks) == list(range(len(PROMPT_LENS)))
    assert all(0 <= t < PCFG.vocab_size for out in toks.values()
               for t in out)


# ---------------------------------------------------------------------------
# models/layers.py against the JAX apply_layer, unit by unit
# ---------------------------------------------------------------------------


def _layer_weights(quant):
    """One layer's tensors: (JAX params, port params).  INT4: the JAX
    side gets what its transfer thread hands compute (dequantized
    weights), the port the packed pairs."""
    from repro.core.transfer import _fused_dequant, quantize_unit
    rng = np.random.default_rng(5)
    tab = JL.layer_table(JCFG, JCFG.pattern[0])
    w = {n: (rng.standard_normal(pd.shape) * (0.1 if pd.scale == 0 else
                                              1 / np.sqrt(pd.shape[0])))
         .astype(np.float32) for n, pd in tab.items()}
    if not quant:
        return ({n: jnp.asarray(a) for n, a in w.items()},
                {n: torch.from_numpy(a) for n, a in w.items()})
    q = quantize_unit(w)
    jw = {}
    for n, a in q.items():
        if n.endswith("#q"):
            s = q[n[:-2] + "#s"]
            jw[n[:-2]] = _fused_dequant(jnp.asarray(a), jnp.asarray(s),
                                        a.shape[0] // s.shape[0])
        elif not n.endswith("#s"):
            jw[n] = jnp.asarray(a)
    return jw, {n: torch.from_numpy(np.array(a)) for n, a in q.items()}


@pytest.mark.parametrize("quant", [None, "int4"])
def test_apply_layer_prefill_matches_reference(quant):
    jw, pw = _layer_weights(quant)
    x = np.random.default_rng(6).standard_normal((1, 9, 64)).astype(
        np.float32)
    jctx = JL.Ctx(cfg=JCFG, dist=Dist.local(), mode="prefill",
                  angles=JT._angles(JCFG, jnp.arange(9)), cache_len=MAX_LEN,
                  batch_size=1)
    jx, jcache, _ = JL.apply_layer(jw, jnp.asarray(x), jctx, None,
                                   JCFG.pattern[0])
    pctx = PL.Ctx(cfg=PCFG, mode="prefill",
                  angles=PT._angles(PCFG, torch.arange(9)))
    px, pcache, _ = PL.apply_layer(pw, torch.from_numpy(x), pctx, None,
                                PCFG.pattern[0])
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=2e-5, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(pcache[n][0].numpy(),
                                   np.asarray(jcache[n])[0, :9], atol=2e-5,
                                   rtol=0)
        assert (np.asarray(jcache[n])[0, 9:] == 0).all()


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
@pytest.mark.parametrize("quant", [None, "int4"])
def test_apply_layer_decode_matches_reference(kv_mode, quant):
    """A decode step at ragged positions over a bf16 cache, or over the
    packed rows of the same cache, against the JAX step over its
    (dequantized) bf16 cache."""
    from repro.core.kvstore import dequantize_kv_rows as jax_dequant
    jw, pw = _layer_weights(quant)
    rng = np.random.default_rng(7)
    b, S, hkv, dh = 3, 32, JCFG.num_kv_heads, JCFG.head_dim
    pos = np.array([5, 0, 30], np.int32)
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    cache = {n: rng.standard_normal((b, S, hkv, dh)).astype(np.float32)
             for n in ("k", "v")}
    if kv_mode == "int4":
        packed = {n: quantize_kv_rows(torch.from_numpy(a).bfloat16()
                                      .reshape(b, S, -1)) for n, a in
                  cache.items()}
        g = kv_group(hkv * dh)
        pcache = {n: PackedRows(p, s, g, torch.bfloat16, (hkv, dh))
                  for n, (p, s) in packed.items()}
        jcache = {n: jnp.asarray(jax_dequant(p.numpy(), s.numpy(), g)
                                 .reshape(b, S, hkv, dh))
                  for n, (p, s) in packed.items()}
    else:
        jcache = {n: jnp.asarray(a).astype(jnp.bfloat16)
                  for n, a in cache.items()}
        pcache = {n: torch.from_numpy(a).bfloat16() for n, a in cache.items()}
    jctx = JL.Ctx(cfg=JCFG, dist=Dist.local(), mode="decode",
                  angles=JT._angles(JCFG, jnp.asarray(pos)[:, None]),
                  pos=jnp.asarray(pos), batch_size=b)
    jx, jnew, _ = JL.apply_layer(jw, jnp.asarray(x), jctx, jcache,
                                 JCFG.pattern[0])
    pp = torch.from_numpy(pos)
    pctx = PL.Ctx(cfg=PCFG, mode="decode",
                  angles=PT._angles(PCFG, pp[:, None]), pos=pp)
    px, prows, _ = PL.apply_layer(pw, torch.from_numpy(x), pctx, pcache,
                               PCFG.pattern[0])
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=2e-5, rtol=0)
    for n in ("k", "v"):
        want = np.asarray(jnew[n], np.float32)[np.arange(b), pos]
        assert prows[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(prows[n][:, 0].float().numpy(), want)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_draw_cache_shares_one_draw(family, monkeypatch):
    """Offloaded engines built inside one ``DrawCache`` draw and pack the
    model once: a second build of the same model and seed (another
    scheduler; two stages for the dense model) draws nothing, and each serves the tokens of
    its plan's engine built without the cache; the cache empties on exit, and a
    resident plan refuses it."""
    from repro_torch.serving.offload_engine import DrawCache
    _, pplan = _plans("fp32", "int4", 1)
    if family == "moe":
        pplan = dataclasses.replace(pplan, cfg=dataclasses.replace(
            PCFG, pattern=(PB.LayerSpec(PB.ATTN, PB.MOE),),
            moe=PB.MoEConfig(num_experts=2, expert_d_ff=64)))
    kws = [{}, {"sched": "online", "prefill_chunk": 4}]
    if family == "dense":       # an MoE unit's expert loads are unstaged
        kws.append({"stages": 2})
    plans = [dataclasses.replace(pplan, **kw) for kw in kws]
    want = [_serve(create_engine(p, device="cpu"), Request) for p in plans]
    draw, drawn = PT.draw_tables, []

    def counted(cfg, seed, keys, workers=0):
        keys = list(keys)
        drawn.append(len(keys))
        return draw(cfg, seed, keys, workers)
    monkeypatch.setattr(PT, "draw_tables", counted)
    with DrawCache() as draws:
        engines = [create_engine(p, device="cpu", draws=draws)
                   for p in plans]
        assert len(drawn) == 1 and drawn[0] > 0
        assert [_serve(eng, Request) for eng in engines] == want
    assert not draws._kept
    res = dataclasses.replace(pplan, engine="resident", quant=None)
    with pytest.raises(SpecError, match="DrawCache"):
        create_engine(res, device="cpu", draws=DrawCache())
