"""The port's chunked prefill and traffic layer against the JAX package's,
on the CPU.

  * Chunked prefill (``sched="online"`` at chunk 2 and 3, and
    ``"offline"``) on a three-layer scaled tinyllama (b_max 2, max_len
    64), for ``kv_mode`` fp32/int4 x depth 1/2: the port's
    ``OffloadedServingEngine`` on the JAX engine's weights serves the
    same tokens, counts the same ``stats`` and, on a virtual-clock pool,
    records the same trace (names, kinds, bytes, extents) as the JAX
    engine.  Inside the port, chunked equals monolithic: the same tokens
    and the same stored KV rows; the last prompt position's hidden state
    within 2e-5 x max|h| (the CPU's matmul changes its arithmetic for
    chunks of a few rows, so bit equality holds only for larger chunks,
    checked at chunk 16).
  * ``apply_layer_chunk`` and ``chunk_prefill_attention`` against the
    JAX functions at atol 2e-5.
  * ``ArrivalTrace`` JSON, ``TrafficSim`` and ``replay_traffic`` equal
    the JAX package's exactly (virtual clock).
  * ``run_trace`` drives the port's online engine to the monolithic
    engine's tokens; the resident engine drops the policy."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.core import replay as JR  # noqa: E402
from repro.core.pipeline import VirtualPool as JaxVirtualPool  # noqa: E402
from repro.core.transfer import split_views  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import attention as JAT  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import EngineSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving import workload as JW  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import replay as PR  # noqa: E402
from repro_torch.core.convert import from_reference_serving  # noqa: E402
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.core.tasks import Trace, VirtualClock  # noqa: E402
from repro_torch.models import attention as PAT  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving import workload as PW  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

JCFG = scaled_down(get_config("tinyllama-1.1b"), num_layers=3,
                   num_periods=3)
PCFG = PB.scaled_down(port_config("tinyllama-1.1b"), num_layers=3,
                      num_periods=3)
B_MAX, MAX_LEN, MAX_NEW = 2, 64, 5
SCHEDS = [("online", 2), ("online", 3), ("offline", None)]
ATOL = 2e-5


def _prompts(n=4):
    """Lengths 6, 7, 8, 9 (tests/test_traffic.py's)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, JCFG.vocab_size, (6 + i,)).astype(np.int32)
            for i in range(n)]


def _plans(kv_mode, depth, sched="monolithic", chunk=None):
    jplan = EngineSpec(arch=JCFG.name, scaled=True, cfg=JCFG, offload=True,
                       placement="host", b_max=B_MAX, max_len=MAX_LEN,
                       pipeline="performance", kv_mode=kv_mode, depth=depth,
                       seed=0, sched=sched, prefill_chunk=chunk).resolve()
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=PCFG)
    return jplan, pplan


def _virtualize(eng, pool_cls):
    n = eng.sched.pool.n_workers
    eng.sched.pool.shutdown()
    pool = pool_cls(n, trace=eng.trace)
    eng.sched.pool = eng._kv_pool = pool


def _serve(eng, req_cls, prompts=None, max_new=MAX_NEW):
    for i, p in enumerate(_prompts() if prompts is None else prompts):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=max_new))
    done = eng.run()
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}, done


def _untimed(trace_json):
    return [{k: v for k, v in e.items() if k not in ("t_start", "t_end")}
            for e in trace_json["events"]]


_RUNS, _WEIGHTS = {}, {}


def _reference(kv_mode, depth, sched, chunk):
    """The JAX engine's virtual-pool run (tokens, stats, trace) and, once,
    its weights as numpy arrays (every configuration draws the same
    weights from seed 0)."""
    key = (kv_mode, depth, sched, chunk)
    if key not in _RUNS:
        jplan, pplan = _plans(kv_mode, depth, sched, chunk)
        jeng = jax_create_engine(jplan)
        if not _WEIGHTS:
            _WEIGHTS["resident"] = {
                part: {n: np.asarray(a) for n, a in
                       jeng.resident[part].items()}
                for part in ("embed", "final_norm")}
            _WEIGHTS["units"] = {
                u.key: {n: np.array(a) for n, a in split_views(
                    jeng.host.get(u.key),
                    jeng.weights.manifests[u.key]).items()}
                for u in jeng.units}
        _virtualize(jeng, JaxVirtualPool)
        toks, _ = _serve(jeng, JaxRequest)
        _RUNS[key] = dict(pplan=pplan, toks=toks, stats=dict(jeng.stats),
                          trace=jeng.trace.to_json(),
                          depth=jeng.sched.depth)
    return _RUNS[key]


def _port_engine(pplan, hidden=None):
    eng = PS.create_engine(pplan, device="cpu")
    from_reference_serving(_WEIGHTS["resident"], _WEIGHTS["units"], eng)
    if hidden is not None:            # the last position at every head
        head = eng._head
        eng._head = lambda x: (hidden.append(x[:, -1].clone()), head(x))[1]
    return eng


_STATS = ("prefills", "prefill_chunks", "decode_steps", "tokens_out",
          "slot_saves", "slot_restores", "preload_depth")


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
@pytest.mark.parametrize("sched,chunk", SCHEDS)
def test_chunked_prefill_matches_reference(sched, chunk, kv_mode, depth):
    ref = _reference(kv_mode, depth, sched, chunk)
    eng = _port_engine(ref["pplan"])
    assert type(eng.sched_policy).__name__ == (
        "OnlineSLO" if sched == "online" else "OfflineThroughput")
    assert eng.sched.depth == ref["depth"] == depth
    _virtualize(eng, VirtualPool)
    toks, _ = _serve(eng, Request)
    assert toks == ref["toks"]
    for k in _STATS:
        assert eng.stats[k] == ref["stats"][k], k
    assert eng.stats["prefill_chunks"] > 0
    assert _untimed(eng.trace.to_json()) == _untimed(ref["trace"])
    # and on the real transfer threads, the same tokens
    assert _serve(_port_engine(ref["pplan"]), Request)[0] == ref["toks"]


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
@pytest.mark.parametrize("sched,chunk", SCHEDS)
def test_chunked_equals_monolithic_in_port(sched, chunk, kv_mode):
    """Same weights: the chunked engine's tokens, stored KV rows (bf16 or
    packed INT4, before any decode step) and last-prompt-position hidden
    states against the monolithic engine's."""
    _reference(kv_mode, 1, sched, chunk)            # loads the weights
    runs = {}
    for name, (s, c) in (("mono", ("monolithic", None)),
                         ("chunked", (sched, chunk))):
        hidden = []
        _, pplan = _plans(kv_mode, 1, s, c)
        eng = _port_engine(pplan, hidden)
        toks, _ = _serve(eng, Request)
        # one more prompt alone: its prefill's rows and one decode row
        # (rows past them were never written by the chunked engine; the
        # monolithic one stores the prompt's zero-padded extent there)
        eng2 = _port_engine(pplan, hidden)
        p = _prompts()[3]
        _serve(eng2, Request, prompts=[p], max_new=1)
        rows = [[a[0, :len(p) + 1].clone()
                 for a in eng2.kvstore._arrays(j, n)]
                for j in range(len(eng2.units)) for n in ("k", "v")]
        runs[name] = (toks, rows, hidden)
    (tm, rm, hm), (tc, rc, hc) = runs["mono"], runs["chunked"]
    assert tc == tm
    assert all(torch.equal(a, b) for ra, rb in zip(rm, rc)
               for a, b in zip(ra, rb))
    # the prefills' heads, in admission order (decode heads are batched)
    first = lambda hs: [h for h in hs if h.shape[0] == 1]
    for a, b in zip(first(hm), first(hc)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=ATOL * float(a.abs().max()))


def test_chunked_hidden_state_bit_equal_at_chunk_16():
    """A 37-token prompt in chunks of 16 (16 + 16 + 5): the last prompt
    position's hidden state is bit-equal to the monolithic prefill's."""
    _reference("fp32", 1, "online", 2)
    prompt = np.random.default_rng(3).integers(
        0, JCFG.vocab_size, (37,)).astype(np.int32)
    heads = {}
    for s, c in (("monolithic", None), ("online", 16)):
        hidden = []
        eng = _port_engine(_plans("fp32", 1, s, c)[1], hidden)
        out, _ = _serve(eng, Request, prompts=[prompt], max_new=1)
        heads[s] = (out, hidden[0])
        assert eng.stats["prefill_chunks"] == (3 if c else 0)
    assert heads["online"][0] == heads["monolithic"][0]
    assert torch.equal(heads["online"][1], heads["monolithic"][1])


def test_chunk_stats_and_prefix_freed():
    _reference("fp32", 1, "online", 2)
    _, pplan = _plans("fp32", 1, "online", 4)
    eng = _port_engine(pplan)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=MAX_NEW))
    done, peak_prefix = [], 0
    while not eng.idle():
        eng.step(done)
        if eng._chunk is not None:
            peak_prefix = max(peak_prefix, len(eng._chunk["prefix"]))
    eng.shutdown()
    assert eng._chunk is None                   # the prefix went with it
    assert peak_prefix == len(eng.units)        # one entry per mha unit
    assert eng.stats["prefills"] == 4
    assert eng.stats["prefill_chunks"] == sum(-(-len(p) // 4)
                                              for p in _prompts())
    assert eng.resident_bytes == sum(
        a.nbytes for tab in _WEIGHTS["resident"].values()
        for a in tab.values())


def test_burst_preemption_with_chunked_prefill():
    """More requests than slots under OnlineSLO: the chunk slot cannot be
    preempted, a decoding slot can, and every stream equals monolithic
    serving (tests/test_traffic.py's scenario)."""
    ref = _reference("fp32", 1, "monolithic", None)
    want, _ = _serve(_port_engine(ref["pplan"]), Request, max_new=6)
    eng = _port_engine(_plans("fp32", 1, "online", 2)[1])
    for i, p in enumerate(_prompts()):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=6))
    eng._epoch += 1
    done, preempted = [], False
    while not eng.idle():
        eng.step(done)
        cslot = eng._chunk_slot()
        if cslot is not None and not preempted:
            with pytest.raises(AssertionError):
                eng.preempt_slot(cslot)
        if (not preempted and eng._chunk_slot() is None
                and all(x is not None and x.out for x in eng.slots)):
            eng.preempt_slot(0)
            preempted = True
    eng.shutdown()
    assert preempted
    assert {r.rid: list(r.out) for r in done} == want
    t_first = {r.rid: r.t_first_token for r in done}
    assert max(t_first[0], t_first[1]) <= min(t_first[2], t_first[3])


# ---------------------------------------------------------------------------
# the layer math
# ---------------------------------------------------------------------------


def _layer_weights(quant):
    """One layer's tensors: (JAX params, port params).  INT4: the JAX side
    gets the dequantized weights its transfer thread hands compute, the
    port the packed pairs."""
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
@pytest.mark.parametrize("c0,c", [(0, 5), (5, 3), (8, 1), (3, 9)])
def test_apply_layer_chunk_matches_reference(quant, c0, c):
    jw, pw = _layer_weights(quant)
    rng = np.random.default_rng(6 + c0)
    x = rng.standard_normal((1, c, 64)).astype(np.float32)
    hkv, dh = JCFG.num_kv_heads, JCFG.head_dim
    pk = rng.standard_normal((1, c0, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((1, c0, hkv, dh)).astype(np.float32)
    jctx = JL.Ctx(cfg=JCFG, dist=Dist.local(), mode="prefill",
                  angles=JT._angles(JCFG, jnp.arange(c0, c0 + c)),
                  batch_size=1)
    jx, jk, jv = JL.apply_layer_chunk(
        jw, jnp.asarray(x), jctx, jnp.asarray(pk) if c0 else None,
        jnp.asarray(pv) if c0 else None, c0)
    pctx = PL.Ctx(cfg=PCFG, mode="prefill",
                  angles=PT._angles(PCFG, torch.arange(c0, c0 + c)))
    px, k, v = PL.apply_layer_chunk(
        pw, torch.from_numpy(x), pctx, torch.from_numpy(pk) if c0 else None,
        torch.from_numpy(pv) if c0 else None, c0)
    for a, b in ((px, jx), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("sq,c0,h,hkv,dh", [(7, 0, 4, 2, 16),
                                            (4, 9, 4, 2, 16),
                                            (1, 20, 8, 2, 32),
                                            (16, 32, 4, 4, 8)])
def test_chunk_prefill_attention_matches_reference(sq, c0, h, hkv, dh):
    rng = np.random.default_rng(sq + c0)
    q = rng.standard_normal((2, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((2, c0 + sq, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, c0 + sq, hkv, dh)).astype(np.float32)
    want = JAT.chunk_prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), q_offset=c0)
    got = PAT.chunk_prefill_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), q_offset=c0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# workload layer: arrival traces, TrafficSim, replay_traffic
# ---------------------------------------------------------------------------

_COSTS = dict(sweep_s=1.0, tok_s=0.02, prefill_tok_s=0.05)


def _ramp(mod):
    return mod.ramp_trace(16, 0.3, 3.0, seed=7, prompt_len=(24, 48),
                          max_new=8)


@pytest.mark.parametrize("kind", ["poisson", "ramp"])
def test_arrival_trace_matches_reference_and_round_trips(kind):
    if kind == "poisson":
        make = lambda m: m.poisson_trace(12, 0.7, seed=0, vocab=128256,
                                         prompt_len=(32, 160), max_new=16)
    else:
        make = lambda m: m.ramp_trace(8, 0.5, 4.0, seed=11,
                                      prompt_len=(4, 9), max_new=3)
    pt, jt = make(PW), make(JW)
    assert pt.to_json() == jt.to_json()
    assert PW.ArrivalTrace.from_json(pt.to_json()).to_json() == pt.to_json()
    assert (PW.ArrivalTrace.from_json(json.dumps(jt.to_json())).to_json()
            == jt.to_json())
    reqs = pt.requests()
    assert [r.rid for r in reqs] == [r.rid for r in jt.requests()]
    assert all(isinstance(r, Request) for r in reqs)


@pytest.mark.parametrize("sched,chunk", [("monolithic", 0), ("online", 16),
                                         ("online", 4), ("offline", 0)])
def test_traffic_sim_matches_reference(sched, chunk):
    p = PW.TrafficSim(_ramp(PW), b_max=2, sched=sched, chunk=chunk,
                      costs=PW.SimCosts(**_COSTS)).run()
    j = JW.TrafficSim(_ramp(JW), b_max=2, sched=sched, chunk=chunk,
                      costs=JW.SimCosts(**_COSTS)).run()
    assert p.trace.to_json() == j.trace.to_json()
    assert p.done == j.done
    assert (p.tokens_out, p.sweeps, p.span_s, p.tok_per_s) == (
        j.tokens_out, j.sweeps, j.span_s, j.tok_per_s)
    assert p.report() == j.report()


def test_replay_traffic_matches_reference():
    rec_p = PW.TrafficSim(_ramp(PW), b_max=2, sched="monolithic",
                          costs=PW.SimCosts(**_COSTS)).run()
    rec_j = JW.TrafficSim(_ramp(JW), b_max=2, sched="monolithic",
                          costs=JW.SimCosts(**_COSTS)).run()
    for kw in ({}, dict(sched="online", chunk=16), dict(b_max=3),
               dict(costs={"sweep_s": 0.5}), dict(sched="offline")):
        p, j = PR.replay_traffic(rec_p.trace, **kw), \
            JR.replay_traffic(rec_j.trace, **kw)
        assert p.trace.to_json() == j.trace.to_json(), kw
        assert p.span_s == j.span_s
    assert (PR.replay_traffic(rec_p.trace).trace.meta["latency"]
            == rec_p.trace.meta["latency"])
    with pytest.raises(PR.ReplayError):                # no traffic block
        PR.replay_traffic(Trace(clock=VirtualClock()))


def test_latency_series_matches_reference():
    reqs = []
    for k in range(3):
        r = Request(rid=k, prompt=np.zeros(3, np.int32))
        r.t_arrive, r.t_first_token, r.t_done = 1.0 + k, 2.5 + k, 4.0 + 2 * k
        r.t_tokens = [2.5 + k, 3.0 + k, 3.75 + k]
        reqs.append(r)
    assert PW.latency_series(reqs) == JW.latency_series(reqs)


def test_run_trace_online_engine_matches_monolithic():
    """run_trace drives the port's online engine through a seeded arrival
    trace to the monolithic engine's tokens; latency fields are coherent
    and land in the engine's trace."""
    ref = _reference("fp32", 1, "monolithic", None)
    at = PW.ramp_trace(4, 5.0, 50.0, seed=1, prompt_len=(6, 10), max_new=4,
                       vocab=PCFG.vocab_size)
    eng = _port_engine(_plans("fp32", 1, "online", 3)[1])
    done = PW.run_trace(eng, at, time_scale=1e-3)
    eng.shutdown()
    mono = _port_engine(ref["pplan"])
    for a in sorted(at.arrivals, key=lambda a: a.t):
        mono.submit(Request(rid=a.rid, prompt=np.asarray(a.prompt, np.int32),
                            max_new=a.max_new))
    want = {r.rid: list(r.out) for r in mono.run()}
    mono.shutdown()
    assert {r.rid: list(r.out) for r in done} == want
    for r in done:
        assert r.t_arrive <= r.t_submit + 1e-9
        assert r.t_done >= r.t_first_token >= r.t_arrive
        assert len(r.t_tokens) == len(r.out)
    lat = eng.trace.report()["latency"]
    assert lat["ttft"]["count"] == 4 and lat["tbt"]["count"] > 0


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


def test_sched_policies_match_reference():
    from repro.serving import spec as JS
    for sched, chunk in (("online", None), ("online", 5), ("offline", None),
                         ("offline", 7), ("monolithic", None)):
        jplan, pplan = _plans("fp32", 1, sched, chunk)
        jp, pp = JS.sched_policy_for(jplan), PS.sched_policy_for(pplan)
        assert repr(pp) == repr(jp)
        assert (pp.name, pp.chunked, pp.chunk_cap()) == (
            jp.name, jp.chunked, jp.chunk_cap())
    for cls in (PS.OnlineSLO, PS.OfflineThroughput):
        with pytest.raises(PS.SpecError):
            cls(0)


def test_resident_engine_drops_sched():
    """The resident engine never chunks: an explicitly resident spec
    rejects ``sched``, and a plan that resolves to the resident engine
    drops it with the JAX package's provenance and serves with the shared
    timing fields stamped."""
    from repro.serving import spec as JS
    kw = dict(arch="tinyllama-1.1b", scaled=True, b_max=2, max_len=64)
    with pytest.raises(PS.SpecError):
        PS.EngineSpec(offload=False, sched="online", prefill_chunk=4,
                      **kw).validate()
    plan = PS.EngineSpec(sched="online", prefill_chunk=4, **kw).resolve()
    assert plan.to_json() == JS.EngineSpec(
        sched="online", prefill_chunk=4, **kw).resolve().to_json()
    assert plan.engine == "resident" and plan.sched == "monolithic"
    assert "dropped" in plan.provenance["sched"]
    eng = PS.create_engine(plan, device="cpu")
    assert isinstance(eng, ServingEngine)
    _, done = _serve(eng, Request, prompts=_prompts())
    assert eng.stats["prefill_chunks"] == 0
    for r in done:
        assert r.t_arrive > 0 and r.t_first_token >= r.t_arrive
        assert r.t_done >= r.t_first_token
        assert len(r.t_tokens) == len(r.out)
