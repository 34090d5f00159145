"""The stores' members the JAX package's callers read, in the port
against the JAX package, on the CPU: ``Store.bytes_used`` and
``Store.__contains__`` over one put/overwrite/delete sequence in the
Host, Device (the port's on the CPU) and Disk stores; ``TieredKVStore.
has_kv`` per unit on scaled jamba and gemma3 stacks, in both engines'
stores and through the staged facade; ``TieredWeightStore.sim_floor``;
``core.transfer.int4_roundtrip`` (bit-equal) and ``models.common.
swiglu`` (within 1e-6 x max, f32)."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ATTN, DENSE, LayerSpec, ModelConfig  # noqa: E402
from repro.core import offload as JO  # noqa: E402
from repro.core import transfer as JT  # noqa: E402
from repro.models.common import swiglu as jax_swiglu  # noqa: E402
from repro.serving import EngineSpec  # noqa: E402
from repro.serving import create_engine as jax_create_engine  # noqa: E402
from repro.serving.spec import build_lm as jax_build_lm  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.core import offload as PO  # noqa: E402
from repro_torch.core import transfer as PT  # noqa: E402
from repro_torch.models.common import swiglu  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402


def _stores(kind, tmp_path):
    if kind == "host":
        return JO.HostStore(), PO.HostStore()
    if kind == "device":
        return JO.DeviceStore(), PO.DeviceStore("cpu")
    return (JO.DiskStore(str(tmp_path / "jax")),
            PO.DiskStore(str(tmp_path / "port")))


def _state(store, keys):
    return (store.bytes_used, store.peak_bytes,
            tuple(k in store for k in keys))


@pytest.mark.parametrize("kind", ["host", "device", "disk"])
def test_store_bytes_used_and_contains(kind, tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 32)).astype(np.float32)
    b = rng.integers(0, 255, (100,)).astype(np.uint8)
    a2 = rng.standard_normal((16, 8)).astype(np.float32)
    keys = ("u0/a", "u0/b", "u1/a")
    ops = [("put", "u0/a", a), ("put", "u0/b", b), ("put", "u0/a", a2),
           ("delete", "u0/b", None), ("delete", "u1/a", None),
           ("put", "u1/a", a), ("delete", "u0/a", None)]
    jst, pst = _stores(kind, tmp_path)
    assert _state(pst, keys) == _state(jst, keys) == (0, 0, (False,) * 3)
    for op, key, arr in ops:
        for st in (jst, pst):
            st.put(key, arr) if op == "put" else st.delete(key)
        assert _state(pst, keys) == _state(jst, keys), (op, key)
    assert pst.bytes_used == a.nbytes or kind == "disk"


def _serving_plans(arch, **kw):
    jplan = EngineSpec(arch=arch, scaled=True, offload=True,
                       placement="host", b_max=2, max_len=64,
                       **kw).resolve()
    return jplan, PS.ResolvedPlan.from_json(jplan.to_json())


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "gemma3-4b"])
def test_has_kv_serving_units(arch):
    jplan, pplan = _serving_plans(arch)
    jeng = jax_create_engine(jplan)
    peng = PS.create_engine(pplan, device="cpu")
    want = [jeng.kvstore.has_kv(j) for j in range(len(jeng.kvstore))]
    got = [peng.kvstore.has_kv(j) for j in range(len(peng.kvstore))]
    jeng.shutdown()
    peng.shutdown()
    assert got == want and len(got) == len(peng.units)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "gemma3-4b"])
def test_has_kv_pipelined_units(arch):
    """The batch engine's units alternate mixer and feed-forward: only
    the mixers' units keep a cache."""
    spec = dict(arch=arch, scaled=True, offload=True, placement="host",
                b_max=2, max_len=32, depth=1)
    jlm = jax_build_lm(EngineSpec(**spec))
    plm = PS.build_lm(PS.EngineSpec(**spec), device="cpu")
    want = [jlm.kvstore.has_kv(j) for j in range(len(jlm.kvstore))]
    got = [plm.kvstore.has_kv(j) for j in range(len(plm.kvstore))]
    assert got == want
    assert True in got and False in got


KW = dict(name="pipo-tiny", num_layers=3, d_model=128, num_heads=4,
          num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)


def test_has_kv_through_the_staged_facade():
    """``stages=2`` splits the three units 2 + 1: the facade routes
    ``has_kv`` to the owning stage's store, as the JAX package's does."""
    jcfg = ModelConfig(**KW, pattern=(LayerSpec(ATTN, DENSE),))
    pcfg = PB.ModelConfig(**KW, pattern=(PB.LayerSpec(PB.ATTN, PB.DENSE),))
    jplan = EngineSpec(arch=jcfg.name, cfg=jcfg, offload=True,
                       placement="host", b_max=2, max_len=64,
                       stages=2).resolve()
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=pcfg)
    jeng = jax_create_engine(jplan)
    peng = PS.create_engine(pplan, device="cpu")
    assert "has_kv" in type(peng.kvstore)._UNIT_METHODS
    assert [len(st) for st in peng.kvstore.stores] == [2, 1]
    got = [peng.kvstore.has_kv(j) for j in range(3)]
    want = [jeng.kvstore.has_kv(j) for j in range(3)]
    jeng.shutdown()
    peng.shutdown()
    assert got == want == [True] * 3
    with pytest.raises(IndexError):
        peng.kvstore.has_kv(3)


ELIGIBLE = [(128, 64), (96, 32), (256, 10), (48, 6)]
INELIGIBLE = [(64,), (128, 7), (8, 16), (2, 16, 8)]


@pytest.mark.parametrize("shape", ELIGIBLE + INELIGIBLE)
def test_int4_roundtrip_bit_equal(shape):
    arr = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32) * 0.05
    want = np.asarray(JT.int4_roundtrip(arr))
    got = PT.int4_roundtrip(arr)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if shape in INELIGIBLE:
        assert got is arr
    else:
        assert not np.array_equal(got, arr)
    t = PT.int4_roundtrip(torch.from_numpy(arr))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_convert_uses_the_one_int4_roundtrip():
    from repro_torch.core import convert
    assert convert.int4_roundtrip is PT.int4_roundtrip
    assert not hasattr(convert, "_int4_roundtrip")


@pytest.mark.parametrize("m,d,f", [(1, 64, 128), (5, 128, 352), (16, 96, 64)])
def test_swiglu_matches_jax(m, d, f):
    rng = np.random.default_rng(m * d + f)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32)
                 for s in ((m, d), (d, f), (d, f)))
    wd = rng.standard_normal((f, d)).astype(np.float32)
    want = np.asarray(jax_swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    got = swiglu(*map(torch.from_numpy, (x, wg, wu, wd))).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_sim_floor_holds_a_load_to_the_link_rate():
    """A load of N bytes takes at least N / ``sim_bw`` seconds: ``load``
    sleeps through ``sim_floor``."""
    nbytes, bw = 1 << 20, 20e6            # about 52 ms
    host = PO.HostStore()
    ws = PT.TieredWeightStore(placement="host", host=host,
                              device=PO.DeviceStore("cpu"), disk=None,
                              sim_bw=bw)
    ws.put("u0", {"w": np.ones(nbytes // 4, np.float32)})
    assert ws.nbytes("u0") == nbytes and ws.sim_bw == bw
    t0 = time.perf_counter()
    out = ws.load("u0")
    assert time.perf_counter() - t0 >= nbytes / bw
    assert float(out["w"].sum()) == nbytes // 4
    t0 = time.perf_counter()
    ws.sim_floor(nbytes // 2, t0)
    assert time.perf_counter() - t0 >= nbytes / 2 / bw
    t0 = time.perf_counter()
    PT.TieredWeightStore(placement="host", host=host, device=None,
                         disk=None).sim_floor(nbytes, t0)
    assert time.perf_counter() - t0 < nbytes / bw
