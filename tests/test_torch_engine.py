"""The port's PipelinedLM against the JAX package's, built from the same
resolved plan with the port's weights loaded from the JAX engine
(``core/convert.py``): greedy tokens are equal, and on a virtual-clock
pool both engines record the same trace (every task, its bytes and live
extent).  The port's own ``_build(seed)`` gives byte-identical merged
buffers.  Config of tests/test_engine.py (d_model=128, d_ff=256)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ATTN, DENSE, LayerSpec, ModelConfig  # noqa: E402
from repro.core.engine import PipelinedLM as JaxLM  # noqa: E402
from repro.core.pipeline import VirtualPool as JaxVirtualPool  # noqa: E402
from repro.core.transfer import split_views  # noqa: E402
from repro.serving.spec import EngineSpec  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.core.convert import from_reference  # noqa: E402
from repro_torch.core.pipeline import VirtualPool  # noqa: E402
from repro_torch.serving.spec import ResolvedPlan, SpecError, build_lm  # noqa: E402

KW = dict(name="pipo-tiny", num_layers=3, d_model=128, num_heads=4,
          num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
JCFG = ModelConfig(**KW, pattern=(LayerSpec(ATTN, DENSE),))
PCFG = PB.ModelConfig(**KW, pattern=(PB.LayerSpec(PB.ATTN, PB.DENSE),))
B, PROMPT, GEN, MAX_LEN = 2, 12, 6, 48


def _plans(tmp, placement, pipeline, quant, fused, depth, cache_on="host"):
    spec = EngineSpec(arch="pipo-tiny", cfg=JCFG, offload=True,
                      placement=placement, b_max=B, max_len=MAX_LEN,
                      pipeline=pipeline, quant=quant, fused_int4=fused,
                      depth=depth, cache_on=cache_on, seed=0,
                      disk_root=str(tmp / "jax_disk"))
    jplan = spec.resolve()
    pplan = dataclasses.replace(ResolvedPlan.from_json(jplan.to_json()),
                                cfg=PCFG, disk_root=str(tmp / "port_disk"))
    return jplan, pplan


def _reference_weights(jlm):
    """The JAX engine's embedding and per-unit tensors as numpy arrays."""
    units = {}
    for u in jlm.units:
        if jlm.placement == "host":
            buf = jlm.host.get(u.key)
        elif jlm.placement == "disk":
            buf = jlm.disk.get(u.key)
        else:
            buf = np.asarray(jlm.device.get(u.key))
        units[u.key] = {k: np.array(v) for k, v in
                        split_views(buf, jlm.manifests[u.key]).items()}
    return np.asarray(jlm.device.get("emb")), units


def _prompt():
    return np.random.default_rng(0).integers(
        0, 512, (B, PROMPT)).astype(np.int32)


GRID = [  # placement, pipeline, quant, fused_int4, depth, cache_on
    ("host", "performance", None, True, 1, "host"),
    ("host", "performance", None, True, 2, "host"),
    ("host", "sequential", None, True, 1, "host"),
    ("host", "memory", None, True, 1, "host"),
    ("device", "performance", None, True, 1, "host"),
    ("disk", "performance", None, True, 2, "host"),
    ("host", "performance", "int4", True, 1, "host"),
    ("host", "performance", "int4", True, 2, "host"),
    ("disk", "sequential", "int4", True, 1, "host"),
    ("device", "performance", "int4", False, 1, "host"),
    ("host", "sequential", "int4", False, 1, "host"),
    ("disk", "performance", "int4", False, 2, "host"),
    ("host", "performance", None, True, 1, "device"),
    ("host", "sequential", "int4", True, 1, "device"),
]


@pytest.mark.parametrize("placement,pipeline,quant,fused,depth,cache_on", GRID)
def test_port_matches_reference(tmp_path, placement, pipeline, quant, fused,
                                depth, cache_on):
    jplan, pplan = _plans(tmp_path, placement, pipeline, quant, fused, depth,
                          cache_on)
    jlm = JaxLM(jplan)
    jpool = JaxVirtualPool(3)
    jtoks, _ = jlm.generate(_prompt(), GEN, pool=jpool)

    plm = build_lm(pplan, device="cpu")
    from_reference(*_reference_weights(jlm), plm)
    ppool = VirtualPool(3)
    ptoks, _ = plm.generate(_prompt(), GEN, pool=ppool)
    np.testing.assert_array_equal(ptoks, jtoks)
    # the same schedule, task for task: kinds, names, bytes, live extents
    assert ppool.trace.to_json() == jpool.trace.to_json()
    jrep, prep = jpool.trace.report(), ppool.trace.report()
    for kind in ("weight_load", "kv_load", "kv_save"):
        assert prep["per_kind"][kind]["bytes"] == \
            jrep["per_kind"][kind]["bytes"], kind

    # the real transfer threads give the same tokens
    plm2 = build_lm(pplan, device="cpu")
    from_reference(*_reference_weights(jlm), plm2)
    toks_threads, stats = plm2.generate(_prompt(), GEN)
    np.testing.assert_array_equal(toks_threads, jtoks)
    assert 0 < stats["compute_busy"] <= 1.0


@pytest.mark.parametrize("quant", [None, "int4"])
def test_own_build_is_byte_identical(tmp_path, quant):
    """``_build(seed)`` draws the JAX engine's tensors in its order from
    one numpy generator (and INT4-packs them bit for bit)."""
    jplan, pplan = _plans(tmp_path, "host", "performance", quant, True, 1)
    jlm = JaxLM(jplan)
    plm = build_lm(pplan, device="cpu")
    np.testing.assert_array_equal(plm.device.get("emb").numpy(),
                                  np.asarray(jlm.device.get("emb")))
    assert [u.key for u in plm.units] == [u.key for u in jlm.units]
    for u in jlm.units:
        np.testing.assert_array_equal(plm.host.get(u.key).numpy(),
                                      jlm.host.get(u.key))
        assert plm.manifests[u.key].entries == jlm.manifests[u.key].entries
    # and, with no weights loaded from the reference, the same tokens
    jtoks, _ = jlm.generate(_prompt(), GEN)
    ptoks, _ = plm.generate(_prompt(), GEN)
    np.testing.assert_array_equal(ptoks, jtoks)


def test_plan_json_roundtrip_and_gates(tmp_path):
    jplan, pplan = _plans(tmp_path, "host", "performance", None, True, 1)
    assert ResolvedPlan.from_json(pplan.to_json()) == pplan
    with pytest.raises(SpecError):
        ResolvedPlan.from_json({**pplan.to_json(), "bogus": 1})
    with pytest.raises(NotImplementedError, match="next slice"):
        build_lm(dataclasses.replace(pplan, kv_mode="int4"), device="cpu")
    with pytest.raises(SpecError):
        build_lm(dataclasses.replace(pplan, kv_mode="int4",
                                     cache_on="device"), device="cpu")
    with pytest.raises(NotImplementedError):
        build_lm(dataclasses.replace(pplan, draft_arch="x", spec_k=2),
                 device="cpu")
    moe = dataclasses.replace(PCFG, pattern=(PB.LayerSpec(PB.ATTN, PB.MOE),),
                              moe=PB.MoEConfig(num_experts=2))
    with pytest.raises(NotImplementedError):
        build_lm(dataclasses.replace(pplan, cfg=moe), device="cpu")


def test_entry_points_default_to_cuda(tmp_path):
    """Without a card, an entry point that was not asked for the CPU
    raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    _, pplan = _plans(tmp_path, "host", "performance", None, True, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_lm(pplan)


def _device_store(device=None):
    from repro_torch.core.offload import DeviceStore
    return DeviceStore() if device is None else DeviceStore(device)


def _kv_store(device=None):
    from repro_torch.core.kvstore import TieredKVStore
    shape = ((B, MAX_LEN, 2, 32), np.float32)
    kw = {} if device is None else {"device": device}
    return TieredKVStore([{"k": shape, "v": shape}], [{"k": "kv", "v": "kv"}],
                         b_max=B, max_len=MAX_LEN, **kw)


@pytest.mark.parametrize("make", [_device_store, _kv_store],
                         ids=["DeviceStore", "TieredKVStore"])
def test_stores_default_to_cuda(make):
    """The device tier and the KV store's load target default to CUDA:
    without a card they raise unless asked for the CPU."""
    assert make("cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
