"""The port's MoE layer against the JAX package's, on the CPU: the same
numpy inputs through ``repro.models.moe`` and ``repro_torch.models.moe``
(router top-k with exact ties, sort-based dispatch with overflow drops,
the full-bank and routed-union combines, the dense oracle), the layer
(``apply_moe_ffn`` with a shared expert), the INT4 stack helpers
(bit-identical packed bytes and scales), ``prepare_moe_params`` and
``quant_roundtrip_params``; then the resident engines on MoE stacks —
``ServingEngine``, ``KVRoundtripServingEngine`` and ``moe_quant="int4"``
— on the JAX engines' weights, to the JAX engines' tokens.  Inside the
port: the union combine equals the full bank bit for bit, and the
offloaded engine's own per-expert draws equal the resident tree's.

Tolerances: ids, slots and packed bytes exact; f32 outputs within
2e-5 x max|reference| (PyTorch's and XLA's CPU products sum in other
orders); tokens exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.quant import int4 as JQ  # noqa: E402
from repro.serving import EngineSpec as JaxSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServing  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving.engine import KVRoundtripServingEngine as JaxKV  # noqa: E402
from repro.serving.offload_engine import \
    quant_roundtrip_params as jax_roundtrip  # noqa: E402
from repro.serving.spec import quant_policy_for as jax_qpolicy  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import (from_reference_resident,  # noqa: E402
                                      quant_roundtrip_params)
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.quant import int4 as PQ  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import (KVRoundtripServingEngine,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.spec import ResolvedPlan, create_engine  # noqa: E402
from repro_torch.serving.spec import quant_policy_for  # noqa: E402

RTOL = 2e-5
B_MAX, MAX_LEN = 2, 48


def _close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def _params(rng, d, f, E, shared=0):
    p = dict(wg=rng.standard_normal((d, E)).astype(np.float32) * 0.5,
             w_gate=rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
             w_up=rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
             w_down=rng.standard_normal((E, f, d)).astype(np.float32) * 0.1)
    if shared:
        p.update(ws_gate=rng.standard_normal((d, shared)).astype(np.float32),
                 ws_up=rng.standard_normal((d, shared)).astype(np.float32),
                 ws_down=rng.standard_normal((shared, d)).astype(np.float32))
    return p


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _tied_logits(rng, T, E):
    """Logits with exact ties: every row repeats a few values."""
    vals = rng.standard_normal((T, 3)).astype(np.float32)
    return vals[:, rng.integers(0, 3, (T, E))[0]]


# ---------------------------------------------------------------------------
# router, dispatch, combine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (6, 3)])
def test_router_topk_ties_match_reference(E, k):
    rng = np.random.default_rng(E * 10 + k)
    logits = _tied_logits(rng, 32, E)
    assert any(len(set(r)) < E for r in logits.tolist())
    jw, jids = JM.router_topk(jnp.asarray(logits), k)
    pw, pids = PM.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    _close(pw.numpy(), jw)


@pytest.mark.parametrize("T,k,E,capacity", [(8, 1, 2, 4), (12, 2, 4, 2),
                                            (16, 2, 8, 1), (5, 3, 4, 9)])
def test_dispatch_indices_match_reference(T, k, E, capacity):
    rng = np.random.default_rng(T + capacity)
    ids = rng.integers(0, max(1, E // 2), (T, k)).astype(np.int32)
    je, js, jv = JM._dispatch_indices(jnp.asarray(ids), E, capacity)
    pe, ps, pv = PM._dispatch_indices(torch.from_numpy(ids).long(), E,
                                      capacity)
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


MOE_CASES = [  # T, d, f, E, k, capacity_factor, tied logits
    (24, 16, 32, 4, 2, 4.0, False),     # no drops
    (24, 16, 32, 4, 2, 0.5, False),     # overflow drops
    (32, 16, 24, 8, 2, 0.25, True),     # drops and ties
    (16, 8, 16, 4, 1, 1.25, True),      # top-1 with ties
]


def _tie_params(rng, d, E, p):
    """A router whose logits tie: duplicated columns."""
    wg = p["wg"].copy()
    wg[:, E // 2:] = wg[:, :E - E // 2][:, :E // 2]
    return {**p, "wg": wg}


@pytest.mark.parametrize("T,d,f,E,k,cf,tied", MOE_CASES)
def test_moe_ffn_matches_reference(T, d, f, E, k, cf, tied):
    rng = np.random.default_rng(T * d + E)
    p = _params(rng, d, f, E)
    if tied:
        p = _tie_params(rng, d, E, p)
    x = rng.standard_normal((T, d)).astype(np.float32)
    jcfg = JMoE(num_experts=E, top_k=k, expert_d_ff=f, capacity_factor=cf)
    pcfg = PB.MoEConfig(num_experts=E, top_k=k, expert_d_ff=f,
                        capacity_factor=cf)
    jout, jaux = JM.moe_ffn(jnp.asarray(x), {n: jnp.asarray(a)
                                             for n, a in p.items()}, jcfg)
    pout, paux = PM.moe_ffn(torch.from_numpy(x), _t(p), pcfg)
    _close(pout.numpy(), jout)
    _close(paux.numpy(), jaux)
    capacity = int(cf * T * k / E) + 1
    _, _, valid = PM._dispatch_indices(
        PM.router_topk(torch.from_numpy(x) @ _t(p)["wg"], k)[1], E, capacity)
    assert bool(valid.all()) == (cf == 4.0)     # the drop cases drop


@pytest.mark.parametrize("T,d,f,E,k,cf,tied", MOE_CASES)
def test_moe_ffn_union_equals_full_bank(T, d, f, E, k, cf, tied):
    """The compact combine over the remapped routed union equals the
    full-bank ``moe_ffn`` bit for bit inside the port, and the JAX
    package's union combine within tolerance."""
    rng = np.random.default_rng(T * d + E + 1)
    p = _params(rng, d, f, E)
    if tied:
        p = _tie_params(rng, d, E, p)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    cfg = PB.MoEConfig(num_experts=E, top_k=k, expert_d_ff=f,
                       capacity_factor=cf)
    full, _ = PM.moe_ffn(x, _t(p), cfg)
    w, ids = PM.router_topk((x @ _t(p)["wg"]).float(), k)
    union = np.unique(ids.numpy())
    ids_u = torch.from_numpy(np.searchsorted(union, ids.numpy()))
    capacity = int(cf * T * k / E) + 1
    stacks = {n: torch.from_numpy(p[n][union])
              for n in ("w_gate", "w_up", "w_down")}
    out = PM.moe_ffn_union(x, w, ids_u, stacks, capacity)
    assert torch.equal(out, full)
    # per-expert lists (the offloaded engine's form) give the same bits
    lists = {n: list(t) for n, t in stacks.items()}
    assert torch.equal(PM.moe_ffn_union(x, w, ids_u, lists, capacity), full)
    jout = JM.moe_ffn_union(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            jnp.asarray(ids_u.numpy()),
                            {n: jnp.asarray(a.numpy())
                             for n, a in stacks.items()}, capacity)
    _close(out.numpy(), jout)


@pytest.mark.parametrize("E,k", [(4, 1), (8, 2)])
def test_dense_oracle_matches_reference(E, k):
    rng = np.random.default_rng(E + k)
    T, d, f = 24, 16, 32
    p = _params(rng, d, f, E)
    x = rng.standard_normal((T, d)).astype(np.float32)
    jcfg = JMoE(num_experts=E, top_k=k, expert_d_ff=f)
    pcfg = PB.MoEConfig(num_experts=E, top_k=k, expert_d_ff=f,
                        capacity_factor=float(E))
    joracle = JM.moe_ffn_dense_oracle(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()}, jcfg)
    poracle = PM.moe_ffn_dense_oracle(torch.from_numpy(x), _t(p), pcfg)
    _close(poracle.numpy(), joracle)
    nodrop, _ = PM.moe_ffn(torch.from_numpy(x), _t(p), pcfg)
    _close(nodrop.numpy(), poracle.numpy())


def test_packed_experts_through_int4_matmul_plain_version():
    """Packed expert stacks (``w_gate#q``/``#s``) combine as the
    dequantized f32 stacks do."""
    rng = np.random.default_rng(3)
    T, d, f, E, k = 12, 64, 32, 4, 2
    p = _params(rng, d, f, E)
    cfg = PB.MoEConfig(num_experts=E, top_k=k, expert_d_ff=f)
    tp = _t(p)
    packed = {"wg": tp["wg"]}
    deq = {"wg": tp["wg"]}
    for n in ("w_gate", "w_up", "w_down"):
        q, s = PQ.quantize_int4_stack(tp[n])
        packed[n + "#q"], packed[n + "#s"] = q, s
        deq[n] = PQ.dequantize_int4_stack(q, s)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    a, _ = PM.moe_ffn(x, packed, cfg)
    b, _ = PM.moe_ffn(x, deq, cfg)
    _close(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _layer_cfgs():
    """(JAX cfg, port cfg): the scaled llama4-scout (4 experts, top-1, a
    shared expert; capacity factor 4, no drops) and a Mixtral-style
    config at 2 layers (4 experts, top-2, capacity factor 1.25)."""
    out = [(scaled_down(get_config("llama4-scout-17b-a16e")),
            PB.scaled_down(port_config("llama4-scout-17b-a16e")))]
    for c in (get_config("mixtral-8x7b"),):
        j = scaled_down(c, num_layers=2, num_periods=2)
        j = dataclasses.replace(j, moe=dataclasses.replace(
            j.moe, capacity_factor=1.25))
        p = PB.scaled_down(port_config("mixtral-8x7b"), num_layers=2,
                           num_periods=2)
        p = dataclasses.replace(p, moe=dataclasses.replace(
            p.moe, capacity_factor=1.25))
        out.append((j, p))
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["llama4_shared", "mixtral"])
def test_apply_moe_ffn_matches_reference(which):
    jcfg, pcfg = _layer_cfgs()[which]
    assert pcfg.moe.top_k == jcfg.moe.top_k
    rng = np.random.default_rng(which)
    tab = PL.layer_table(pcfg, pcfg.pattern[0])
    jtab = JL.layer_table(jcfg, jcfg.pattern[0])
    assert {n: pd.shape for n, pd in tab.items()} == \
        {n: pd.shape for n, pd in jtab.items()}
    p = {n: (rng.standard_normal(pd.shape)
             / np.sqrt(pd.shape[-2] if len(pd.shape) > 1 else 1)
             ).astype(np.float32) for n, pd in tab.items()}
    x = rng.standard_normal((2, 7, pcfg.d_model)).astype(np.float32)
    jctx = JL.Ctx(cfg=jcfg, dist=Dist.local(), mode="prefill",
                  batch_size=2)
    jx, jaux = JL.apply_moe_ffn({n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x), jctx)
    px, paux = PL.apply_moe_ffn(_t(p), torch.from_numpy(x),
                                PL.Ctx(cfg=pcfg, mode="prefill"))
    _close(px.numpy(), jx)
    _close(paux.numpy(), jaux)


# ---------------------------------------------------------------------------
# INT4 stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64, 32), (2, 3, 256, 48),
                                   (3, 48, 10), (4, 128, 64)])
def test_int4_stack_helpers_bit_identical(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    w = rng.standard_normal(shape).astype(np.float32)
    assert PQ.stack_eligible(shape) == JQ.stack_eligible(shape)
    assert PQ.stack_group(shape[-2]) == JQ.stack_group(shape[-2])
    jq, js = JQ.quantize_int4_stack(jnp.asarray(w))
    pq, ps = PQ.quantize_int4_stack(torch.from_numpy(w))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        PQ.dequantize_int4_stack(pq, ps).numpy(),
        np.asarray(JQ.dequantize_int4_stack(jq, js, jnp.float32)))
    assert not PQ.stack_eligible(shape[-2:])


def _resident_tree(jcfg, seed=0):
    params = jax.tree.map(
        np.asarray, JaxServing(jcfg, b_max=B_MAX, max_len=MAX_LEN,
                               seed=seed).params)
    return params


def test_prepare_moe_params_matches_reference():
    jcfg, pcfg = _layer_cfgs()[0]
    params = _resident_tree(jcfg)
    jout = jax_qpolicy(None, "fp32", "int4").prepare_moe_params(
        jax.tree.map(jnp.asarray, params))
    pout = quant_policy_for(None, "fp32", "int4").prepare_moe_params(
        PT.to_device(params, "cpu"))
    for q, (jt, pt) in enumerate(zip(jout["pat"], pout["pat"])):
        assert sorted(jt) == sorted(pt)
        assert "w_gate#q" in pt and "w_gate" not in pt and "wg" in pt
        for n in pt:
            np.testing.assert_array_equal(pt[n].numpy(), np.asarray(jt[n]),
                                          err_msg=n)
    assert quant_policy_for(None, "fp32", None).prepare_moe_params(
        pout) is pout


@pytest.mark.parametrize("which", [0, 1], ids=["llama4_shared", "mixtral"])
def test_quant_roundtrip_params_bit_identical(which):
    jcfg, pcfg = _layer_cfgs()[which]
    params = _resident_tree(jcfg)
    jrt = jax.tree.map(np.asarray, jax_roundtrip(jcfg, params))
    prt = quant_roundtrip_params(pcfg, params)
    for part in ("embed", "final_norm"):
        assert prt[part] is params[part]
    for jt, pt in zip(jrt["pat"], prt["pat"]):
        for n in jt:
            np.testing.assert_array_equal(pt[n], jt[n], err_msg=n)
        assert not np.array_equal(pt["w_gate"], params["pat"][0]["w_gate"])
        np.testing.assert_array_equal(pt["wg"], params["pat"][0]["wg"])


# ---------------------------------------------------------------------------
# resident engines on MoE stacks
# ---------------------------------------------------------------------------


def _prompts(vocab, n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (6 + i,)).astype(np.int32)
            for i in range(n)]


def _serve(eng, req_cls, vocab):
    for i, p in enumerate(_prompts(vocab)):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=4))
    done = eng.run()
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


_RUNS = {}


def _reference(which):
    """The JAX resident, KV-roundtrip and moe_quant engines' tokens and
    the resident tree as numpy arrays, once per config."""
    if which not in _RUNS:
        jcfg, pcfg = _layer_cfgs()[which]
        spec = dict(arch=jcfg.name, cfg=jcfg, b_max=B_MAX, max_len=MAX_LEN,
                    seed=0, offload=False)
        jplan = JaxSpec(**spec).resolve()
        jeng = jax_create_engine(jplan)
        params = jax.tree.map(np.asarray, jeng.params)
        v = jcfg.vocab_size
        qplan = JaxSpec(**spec, moe_quant="int4").resolve()
        oplan = JaxSpec(**{**spec, "offload": True}, placement="host",
                        depth=1).resolve()
        qeng = jax_create_engine(qplan)
        _RUNS[which] = dict(
            pcfg=pcfg, params=params, vocab=v,
            pplan=dataclasses.replace(
                ResolvedPlan.from_json(jplan.to_json()), cfg=pcfg),
            qplan=dataclasses.replace(
                ResolvedPlan.from_json(qplan.to_json()), cfg=pcfg),
            oplan=dataclasses.replace(
                ResolvedPlan.from_json(oplan.to_json()), cfg=pcfg),
            qparams=jax.tree.map(np.asarray, qeng.params),
            toks=_serve(jeng, JaxRequest, v),
            kv_toks=_serve(JaxKV(jplan), JaxRequest, v),
            q_toks=_serve(qeng, JaxRequest, v))
    return _RUNS[which]


@pytest.mark.parametrize("which", [0, 1], ids=["llama4_shared", "mixtral"])
def test_resident_moe_matches_reference(which):
    ref = _reference(which)
    eng = create_engine(ref["pplan"], device="cpu")
    assert type(eng) is ServingEngine
    from_reference_resident(ref["params"], eng)
    assert _serve(eng, Request, ref["vocab"]) == ref["toks"]


@pytest.mark.parametrize("which", [0, 1], ids=["llama4_shared", "mixtral"])
def test_kv_roundtrip_moe_matches_reference(which):
    ref = _reference(which)
    eng = KVRoundtripServingEngine(ref["pplan"], device="cpu")
    from_reference_resident(ref["params"], eng)
    assert _serve(eng, Request, ref["vocab"]) == ref["kv_toks"]


@pytest.mark.parametrize("which", [0, 1], ids=["llama4_shared", "mixtral"])
def test_moe_quant_matches_reference(which):
    """``moe_quant="int4"``: the routed stacks packed once (bit-identical
    to the JAX engine's), the tokens the JAX engine's, and the resident
    expert bytes below 1/6 of f32."""
    ref = _reference(which)
    eng = create_engine(ref["qplan"], device="cpu")
    assert eng.plan.moe_quant == "int4"
    for pt, jt, ft in zip(eng.params["pat"], ref["qparams"]["pat"],
                          ref["params"]["pat"]):
        assert sorted(pt) == sorted(jt) and "w_gate" not in pt
        packed = f32 = 0
        for n in ("w_gate", "w_up", "w_down"):
            packed += pt[n + "#q"].nbytes + pt[n + "#s"].nbytes
            f32 += ft[n].nbytes
        assert packed * 6 < f32
    # on the JAX weights: packed bytes equal, tokens equal
    eng = create_engine(ref["pplan"], device="cpu")
    from_reference_resident(ref["params"], eng)
    eng.params = quant_policy_for(None, "fp32", "int4").prepare_moe_params(
        eng.params)
    for pt, jt in zip(eng.params["pat"], ref["qparams"]["pat"]):
        for n in pt:
            np.testing.assert_array_equal(pt[n].numpy(), jt[n], err_msg=n)
    assert _serve(eng, Request, ref["vocab"]) == ref["q_toks"]


def test_per_expert_draws_equal_the_resident_tree():
    """The offloaded engine draws a MoE layer as its table without the
    expert stacks plus one draw per expert; stacked, they are the tree
    ``init_params`` gives the resident engine."""
    _, pcfg = _layer_cfgs()[0]
    tree = PT.init_params(pcfg, 5)
    base = PT.table_params(pcfg, 5, "pat", 0, 1, experts=False)
    assert "w_gate" not in base and "wg" in base and "ws_gate" in base
    for n, a in base.items():
        np.testing.assert_array_equal(a, tree["pat"][0][n][1])
    for e in range(pcfg.moe.num_experts):
        ex = PT.expert_params(pcfg, 5, "pat", 0, 1, e)
        assert sorted(ex) == ["w_down", "w_gate", "w_up"]
        for n, a in ex.items():
            np.testing.assert_array_equal(a, tree["pat"][0][n][1, e])
    keys = [("pat", 0, 1, None), ("pat", 0, 1, 2), ("pat", 0, 1)]
    drawn = dict(PT.draw_tables(pcfg, 5, keys, workers=2))
    np.testing.assert_array_equal(drawn[keys[1]]["w_up"],
                                  tree["pat"][0]["w_up"][1, 2])
    np.testing.assert_array_equal(drawn[keys[2]]["w_down"],
                                  tree["pat"][0]["w_down"][1])


def test_resident_equals_offloaded_in_port():
    """The port's own draws: the resident and the offloaded engine on one
    seed give the same tokens on MoE (fp32 weights and KV)."""
    ref = _reference(1)
    res = _serve(create_engine(ref["pplan"], device="cpu"), Request,
                 ref["vocab"])
    off = create_engine(ref["oplan"], device="cpu")
    assert off.plan.engine == "offloaded"
    assert off.units[0].moe and len(off.units[0].expert_keys) == 4
    assert _serve(off, Request, ref["vocab"]) == res
