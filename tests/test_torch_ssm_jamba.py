"""Jamba (SSM layers with dense and MoE feed-forwards beside a global
attention layer) through the port's engines, against the JAX package's
on the same weights, at the scaled config cut to its period's first 5
layers (``ssm_cases.JAMBA``: SSM+dense, SSM+MoE, SSM+dense, SSM+MoE,
attention+dense; 4 experts, top-2, dropless) on the CPU:

  * ``OffloadedServingEngine``: tokens, stats and the untimed virtual
    trace equal the JAX engine's across ``kv_mode`` fp32/int4 x
    ``quant`` None/int4 (the SSM+MoE units run the mixer through
    ``apply_layer`` and the routed union through ``_compute_moe``); the
    real transfer threads give the same tokens; a preempted slot resumes
    to the uninterrupted tokens;
  * under ``kv_mode="int4"`` only the attention layer's rows pack;
  * the resident ``ServingEngine`` and ``KVRoundtripServingEngine`` on
    the JAX resident engine's tree, the same 5 layers as one period.

Tokens and traces are held equal; no tolerance is involved."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import ssm_cases as C  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving.engine import KVRoundtripServingEngine as JaxKV  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.core.convert import from_reference_resident  # noqa: E402
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.engine import (KVRoundtripServingEngine,  # noqa: E402
                                        ServingEngine)

CASE = C.JAMBA
PC = CASE.pc


@pytest.mark.parametrize("kv_mode,quant", C.GRID)
def test_offloaded_matches_reference(kv_mode, quant):
    ref = C.reference(CASE, kv_mode, quant)
    eng = C.port_engine(ref)
    assert [(u.spec.mixer, u.moe) for u in eng.units] == [
        (PB.SSM, False), (PB.SSM, True), (PB.SSM, False), (PB.SSM, True),
        (PB.ATTN, False)]
    assert eng.kv_kinds == ref["kinds"]
    C.virtualize(eng, VirtualPool)
    assert C.serve(CASE, eng, Request) == ref["toks"]
    for k in ("prefills", "decode_steps", "tokens_out", "slot_saves"):
        assert eng.stats[k] == ref["stats"][k], k
    assert C.untimed(eng.trace.to_json()) == C.untimed(ref["trace"])
    assert C.serve(CASE, C.port_engine(ref), Request) == ref["toks"]


def test_only_the_attention_layer_packs():
    ref = C.reference(CASE, "int4", "int4")
    eng = C.port_engine(ref)
    packed = [sorted(n for n, m in eng.kvstore.leaf_meta(j).items()
                     if m.quant) for j in range(len(eng.units))]
    assert packed == [[], [], [], [], ["k", "v"]]
    eng.shutdown()


def test_preempt_resume_matches_uninterrupted():
    ref = C.reference(CASE, "int4", "int4")
    eng = C.port_engine(ref)
    assert C.serve(CASE, eng, Request, preempt_after=3) == ref["toks"]
    assert eng.stats["slot_restores"] == 1


_RESIDENT = {}


@pytest.mark.parametrize("cls", ["ServingEngine", "KVRoundtripServingEngine"])
def test_resident_matches_reference(cls):
    case = C.JAMBA_PERIOD
    if not _RESIDENT:
        jplan, pplan = C.plans(case, offload=False)
        jeng = jax_create_engine(jplan)
        _RESIDENT.update(pplan=pplan,
                         params=jax.tree.map(np.asarray, jeng.params),
                         toks=C.serve(case, jeng, JaxRequest),
                         kv_toks=C.serve(case, JaxKV(jplan), JaxRequest))
    ref = _RESIDENT
    if cls == "ServingEngine":
        eng = PS.create_engine(ref["pplan"], device="cpu")
        assert type(eng) is ServingEngine
        want = ref["toks"]
    else:
        eng = KVRoundtripServingEngine(ref["pplan"], device="cpu")
        want = ref["kv_toks"]
    from_reference_resident(ref["params"], eng)
    assert C.serve(case, eng, Request) == want
