"""The port's offloaded MoE serving against the JAX package's, on the CPU:
``OffloadedServingEngine`` with routed-union expert streaming, built
from the same resolved plan and loaded with the JAX engine's weights
(``core/convert.from_reference_serving``: units, experts and routers),
serves the same requests to the same greedy tokens across kv_mode {fp32,
int4} x quant {None, int4} x preload depth {1, 2}, on a virtual-clock
pool (the same trace as the JAX engine, task for task: the expert
WEIGHT_LOADs named ``w[<key>]`` with their bytes) and on real threads.
The per-expert load counts equal the JAX engine's, and the expert bytes
are the union loads times the per-expert bytes, below the bank's.  The
INT4 engine's tokens equal a resident engine on
``quant_roundtrip_params``.  Configs: the scaled llama4-scout (4
experts, top-1, a shared expert) and a two-layer Mixtral-style config
(4 experts, top-2, capacity factor 1.25)."""
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
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import (from_reference_resident,  # noqa: E402
                                      from_reference_serving,
                                      quant_roundtrip_params)
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.spec import ResolvedPlan, create_engine  # noqa: E402

B_MAX, MAX_LEN = 2, 48
MAX_NEW = (5, 3, 4)


def _cfgs(which):
    if which == "llama4":
        return (scaled_down(get_config("llama4-scout-17b-a16e")),
                PB.scaled_down(port_config("llama4-scout-17b-a16e")))
    j = scaled_down(get_config("mixtral-8x7b"), num_layers=2, num_periods=2)
    p = PB.scaled_down(port_config("mixtral-8x7b"), num_layers=2,
                       num_periods=2)
    return (dataclasses.replace(j, moe=dataclasses.replace(
                j.moe, capacity_factor=1.25)),
            dataclasses.replace(p, moe=dataclasses.replace(
                p.moe, capacity_factor=1.25)))


def _prompts(vocab, n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (6 + 2 * i,)).astype(np.int32)
            for i in range(n)]


def _serve(eng, req_cls, vocab):
    for i, p in enumerate(_prompts(vocab)):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=MAX_NEW[i]))
    done = eng.run()
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


def _virtualize(eng, pool_cls):
    n = eng.sched.pool.n_workers
    eng.sched.pool.shutdown()
    pool = pool_cls(n, trace=eng.trace)
    eng.sched.pool = eng._kv_pool = pool


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


def _reference(which, kv_mode, quant, depth, fused=True):
    key = (which, kv_mode, quant, depth, fused)
    if key not in _RUNS:
        jcfg, pcfg = _cfgs(which)
        spec = EngineSpec(arch=jcfg.name, cfg=jcfg, offload=True,
                          placement="host", b_max=B_MAX, max_len=MAX_LEN,
                          pipeline="performance", quant=quant,
                          kv_mode=kv_mode, depth=depth, fused_int4=fused,
                          seed=0)
        jplan = spec.resolve()
        jeng = jax_create_engine(jplan)
        weights = _weights(jeng)
        _virtualize(jeng, JaxVirtualPool)
        toks = _serve(jeng, JaxRequest, jcfg.vocab_size)
        _RUNS[key] = dict(
            pplan=dataclasses.replace(
                ResolvedPlan.from_json(jplan.to_json()), cfg=pcfg),
            weights=weights, toks=toks, trace=jeng.trace.to_json(),
            depth=jeng.sched.depth, stats=dict(jeng.stats),
            load_counts=dict(jeng.weights.load_counts),
            vocab=jcfg.vocab_size)
    return _RUNS[key]


def _port_engine(ref):
    eng = create_engine(ref["pplan"], device="cpu")
    from_reference_serving(*ref["weights"][:2], eng, ref["weights"][2])
    return eng


def _untimed(tr):
    return [{k: v for k, v in e.items() if k not in ("t_start", "t_end")}
            for e in tr["events"]]


GRID = [(kv, quant, depth) for kv in ("fp32", "int4")
        for quant in (None, "int4") for depth in (1, 2)]


@pytest.mark.parametrize("kv_mode,quant,depth", GRID)
def test_moe_serving_matches_reference(kv_mode, quant, depth):
    ref = _reference("llama4", kv_mode, quant, depth)
    eng = _port_engine(ref)
    assert eng.sched.depth == ref["depth"]
    assert all(u.moe and len(u.expert_keys) == 4 for u in eng.units)
    _virtualize(eng, VirtualPool)
    assert _serve(eng, Request, ref["vocab"]) == ref["toks"]
    for k in ("prefills", "decode_steps", "tokens_out"):
        assert eng.stats[k] == ref["stats"][k], k
    assert _untimed(eng.trace.to_json()) == _untimed(ref["trace"])
    assert eng.weights.load_counts == ref["load_counts"]
    # and on the real transfer threads, the same tokens
    assert _serve(_port_engine(ref), Request, ref["vocab"]) == ref["toks"]


def _expert_keys(eng):
    return [k for u in eng.units if u.moe for k in u.expert_keys]


@pytest.mark.parametrize("quant,fused", [(None, True), ("int4", True),
                                         ("int4", False)])
def test_union_loads_and_stack_bytes(quant, fused):
    """Top-2 over 4 experts, two layers: the expert loads per key equal
    the JAX engine's; the traced expert WEIGHT_LOAD bytes are the loads
    times each expert's bytes, below the bank's; ``moe_stack_bytes`` is
    the loads times the bytes of the tensors the combine takes — f32
    (the JAX engine's stat) at quant None and unfused INT4, the packed
    bytes under fused INT4."""
    ref = _reference("mixtral", "fp32", quant, 1, fused)
    eng = _port_engine(ref)
    _virtualize(eng, VirtualPool)
    assert _serve(eng, Request, ref["vocab"]) == ref["toks"]
    assert _untimed(eng.trace.to_json()) == _untimed(ref["trace"])
    keys = _expert_keys(eng)
    loads = {k: eng.weights.load_counts.get(k, 0) for k in keys}
    assert loads == {k: ref["load_counts"].get(k, 0) for k in keys}
    per = {k: eng.weights.nbytes(k) for k in keys}
    traced = sum(e.nbytes for e in eng.trace.events()
                 if e.kind == "weight_load" and "/exp[" in e.name)
    assert traced == sum(loads[k] * per[k] for k in keys) > 0
    n_moe = sum(1 for u in eng.units if u.moe)
    passes = eng.stats["prefills"] + eng.stats["decode_steps"]
    assert traced < passes * n_moe * 4 * max(per.values())
    assert sum(loads.values()) < passes * n_moe * 4
    cfg = eng.cfg
    f32 = 4 * 3 * cfg.d_model * cfg.moe.expert_d_ff
    if quant == "int4" and fused:
        assert eng.stats["moe_stack_bytes"] == traced < sum(loads.values()) \
            * f32
    else:
        assert eng.stats["moe_stack_bytes"] == sum(loads.values()) * f32 \
            == ref["stats"]["moe_stack_bytes"]


def test_decode_loads_routed_union_only():
    """b=1, top-1: exactly ONE expert per MoE unit per decode step (the
    JAX package's own invariant), counted on the port's store."""
    jcfg, pcfg = _cfgs("llama4")
    jplan = EngineSpec(arch=jcfg.name, cfg=jcfg, offload=True,
                       placement="host", b_max=1, max_len=MAX_LEN,
                       seed=0).resolve()
    eng = create_engine(dataclasses.replace(
        ResolvedPlan.from_json(jplan.to_json()), cfg=pcfg), device="cpu")
    eng.submit(Request(rid=0, prompt=_prompts(pcfg.vocab_size, 1)[0],
                       max_new=4))
    eng._admit()
    snap = dict(eng.weights.load_counts)
    done = []
    while eng.slots[0] is not None:
        eng._decode_step(done)
    eng.shutdown()
    n_moe = sum(1 for u in eng.units if u.moe)
    loads = sum(eng.weights.load_counts.get(k, 0) - snap.get(k, 0)
                for k in _expert_keys(eng))
    assert len(done) == 1
    assert loads == eng.stats["decode_steps"] * n_moe > 0


@pytest.mark.parametrize("which", ["llama4", "mixtral"])
def test_int4_offloaded_equals_resident_on_roundtrip(which):
    """The INT4 offloaded engine (fused: packed experts into the
    ``int4_matmul`` path) decodes the tokens of a resident engine whose
    streamed leaves went through the INT4 codec
    (``quant_roundtrip_params``), on the same weights."""
    ref = _reference(which, "fp32", "int4", 1)
    jcfg, pcfg = _cfgs(which)
    from repro.serving import ServingEngine as JaxServing
    params = jax.tree.map(np.asarray, JaxServing(
        jcfg, b_max=B_MAX, max_len=MAX_LEN, seed=0).params)
    rplan = dataclasses.replace(ref["pplan"], engine="resident",
                                quant=None, fused_int4=True)
    res = create_engine(rplan, device="cpu")
    from_reference_resident(quant_roundtrip_params(pcfg, params), res)
    assert _serve(res, Request, ref["vocab"]) == ref["toks"]
    assert _serve(_port_engine(ref), Request, ref["vocab"]) == ref["toks"]


def test_route_hook_records_and_holds_routing():
    """``eng.route`` is every MoE gate's top-k: an engine that records
    its gates and a second engine held to the recorded ids (weights from
    its own logits) serve the reference's tokens, gate for gate; a route
    that sends every row to expert 0 loads no other expert."""
    from repro_torch.models.moe import router_topk
    ref = _reference("llama4", "fp32", None, 1)
    calls = []

    def record(key, logits, k):
        w, ids = router_topk(logits, k)
        calls.append((key, ids.clone()))
        return w, ids

    eng = _port_engine(ref)
    eng.route = record
    assert _serve(eng, Request, ref["vocab"]) == ref["toks"]
    assert calls
    held = iter(calls)

    def hold(key, logits, k):
        ref_key, ids = next(held)
        assert ref_key == key
        return torch.softmax(logits.gather(-1, ids), -1), ids

    eng = _port_engine(ref)
    eng.route = hold
    assert _serve(eng, Request, ref["vocab"]) == ref["toks"]
    assert next(held, None) is None

    eng = _port_engine(ref)
    eng.route = lambda key, logits, k: (
        torch.ones((logits.shape[0], k)) / k,
        torch.zeros((logits.shape[0], k), dtype=torch.long))
    _serve(eng, Request, ref["vocab"])
    loaded = {k for k, n in eng.weights.load_counts.items()
              if n and "/exp[" in k}
    assert loaded and all(k.endswith("/exp[0]") for k in loaded)
