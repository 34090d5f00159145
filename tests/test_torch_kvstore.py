"""The port's KV store and INT4 row codec against the JAX package's, on
the same numpy rows: codec output bit for bit, the store's packed and
scale arrays after the same saves bit for bit, the same byte accounting,
packed loads, and bit-exact truncate / spill / restore round trips
(the cases of tests/test_kvstore.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import kvstore as J  # noqa: E402
from repro.core.offload import HostStore as JaxHostStore  # noqa: E402
from repro_torch.core import kvstore as P  # noqa: E402
from repro_torch.core.offload import HostStore  # noqa: E402

B_MAX, MAX_LEN, FEAT = 4, 40, (2, 16)
F = int(np.prod(FEAT))
DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rows(seed, shape, spread=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if spread:                       # per-row magnitudes over 6 decades
        x *= 10.0 ** rng.uniform(-3, 3, shape[:-1] + (1,)).astype(np.float32)
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("F_", [64, 96, 256, 48, 2])
def test_codec_bit_identical(F_):
    """quantize / dequantize / kv_group equal the JAX codec bit for bit,
    including all-zero rows, exact half-step values and bf16 inputs."""
    g = P.kv_group(F_)
    assert g == J.kv_group(F_)
    x = _rows(F_, (6, 9, F_))
    x[0, 0] = 0.0                                   # an all-zero row
    x[1, 1] = 0.0
    x[1, 1, :2] = [7.0, -3.5]                       # q = 7 and a half step
    jp, js = J.quantize_kv_rows(x, g)
    pp, ps = P.quantize_kv_rows(x, g)
    np.testing.assert_array_equal(pp.numpy(), jp)
    np.testing.assert_array_equal(_bits(ps.numpy()), _bits(js))
    jd = J.dequantize_kv_rows(jp, js, g, jnp.float32)
    pd = P.dequantize_kv_rows(pp, ps, g, torch.float32)
    np.testing.assert_array_equal(_bits(pd.numpy()), _bits(jd))
    jb = np.asarray(J.dequantize_kv_rows(jp, js, g), np.float32)
    np.testing.assert_array_equal(P.dequantize_kv_rows(pp, ps, g).float()
                                  .numpy(), jb)
    assert (P.kv_roundtrip_rows(torch.zeros(3, F_)) == 0).all()
    # rows cast to bf16 first (the serving cache's compute dtype)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    jp, js = J.quantize_kv_rows(xb, g)
    pp, ps = P.quantize_kv_rows(torch.from_numpy(x).bfloat16(), g)
    np.testing.assert_array_equal(pp.numpy(), jp)
    np.testing.assert_array_equal(_bits(ps.numpy()), _bits(js))


def test_eligibility_matches_reference():
    for kind, feat in (("kv", (2, 16)), ("rep", (2, 16)), ("kv", (3,)),
                       ("state", (4, 8, 16)), ("kv", (1,)), ("kv", (3, 2))):
        assert P.kv_eligible(kind, feat) == J.kv_eligible(kind, feat)


def _stores(kv_mode, dtype, n_units=2, feat=FEAT):
    jdt, pdt = DTYPES[dtype]
    shape = (B_MAX, MAX_LEN) + feat
    kinds = [{"k": "kv", "v": "kv"} for _ in range(n_units)]
    js = J.TieredKVStore([{"k": (shape, jdt), "v": (shape, jdt)}
                          for _ in range(n_units)], kinds, b_max=B_MAX,
                         max_len=MAX_LEN, kv_mode=kv_mode)
    ps = P.TieredKVStore([{"k": (shape, pdt), "v": (shape, pdt)}
                          for _ in range(n_units)], kinds, b_max=B_MAX,
                         max_len=MAX_LEN, kv_mode=kv_mode, device="cpu")
    return js, ps


def _save_sequence(st, torch_side, feat=FEAT):
    """save_prefill_batch, then a slot's save_prefill, then decode saves
    at ragged positions, the same on both stores."""
    cv = (lambda a: torch.from_numpy(a)) if torch_side else (lambda a: a)
    batch = _rows(1, (B_MAX, 17) + feat)
    for j in range(len(st)):
        st.save_prefill_batch(j, {"k": cv(batch), "v": cv(2 * batch)}, 13)
        slot = _rows(2 + j, (MAX_LEN,) + feat)
        slot[21:] = 0
        st.save_prefill(j, 2, {"k": cv(slot), "v": cv(-slot)})
    pos = np.array([13, 13, 21, 13], np.int32)
    for t in range(3):
        new = _rows(10 + t, (3, 1) + feat)
        for j in range(len(st)):
            st.save_decode(j, {"k": cv(new), "v": cv(new * 0.5)},
                           active=[0, 2], pos=pos + t)


def _leaf_arrays(st, j, name, torch_side):
    leaf = st._units[j][name]
    if torch_side:
        arrs = (leaf.packed, leaf.scale) if isinstance(leaf, P._QuantLeaf) \
            else (leaf,)
        return [a.float().numpy() if a.dtype == torch.bfloat16
                else a.numpy() for a in arrs]
    arrs = (leaf.packed, leaf.scale) if isinstance(leaf, J._QuantLeaf) \
        else (leaf.arr,)
    return [np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else a
            for a in arrs]


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_store_arrays_and_bytes_match_reference(kv_mode, dtype):
    js, ps = _stores(kv_mode, dtype)
    _save_sequence(js, False)
    _save_sequence(ps, True)
    for j in range(2):
        assert ps.leaf_meta(j)["k"].quant == js.leaf_meta(j)["k"].quant \
            == (kv_mode == "int4")
        assert ps.leaf_meta(j)["k"].group == js.leaf_meta(j)["k"].group
        for name in ("k", "v"):
            for pa, ja in zip(_leaf_arrays(ps, j, name, True),
                              _leaf_arrays(js, j, name, False)):
                np.testing.assert_array_equal(_bits(pa), _bits(ja))
    for lb, ll in ((1, 1), (2, 13), (3, 24), (B_MAX, MAX_LEN), (None, None)):
        assert ps.load_nbytes(0, lb, ll) == js.load_nbytes(0, lb, ll)
        assert ps.dequant_nbytes(0, lb, ll) == js.dequant_nbytes(0, lb, ll)
    for lb in (1, 3, None):
        for rows in (1, 4):
            assert ps.save_nbytes(0, lb, rows) == js.save_nbytes(0, lb, rows)
    for lb, length in ((1, None), (4, 13), (2, 7)):
        assert ps.prefill_save_nbytes(0, lb, length) == \
            js.prefill_save_nbytes(0, lb, length)
    assert ps.host_nbytes() == js.host_nbytes()
    assert ps.slab_nbytes(1) == js.slab_nbytes(1)
    assert ps.max_live_load_nbytes(3, 20) == js.max_live_load_nbytes(3, 20)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int4_load_ships_packed_rows(dtype):
    """An INT4 load returns the live packed rows and scales (the kernel
    dequantizes them); dequantized, they equal the reference's load over
    the live extent, with zeros beyond it; ``dequant_bytes_total``
    counts what the reference counts."""
    js, ps = _stores("int4", dtype)
    _save_sequence(js, False)
    _save_sequence(ps, True)
    for lb, ll in ((3, 24), (1, 5), (B_MAX, 32)):
        got = ps.load(0, lb, ll)
        want = js.load(0, lb, ll)
        for name in ("k", "v"):
            rows = got[name]
            assert isinstance(rows, P.PackedRows)
            cap = min(MAX_LEN, -(-(ll + 1) // 32) * 32)
            assert rows.packed.shape == (B_MAX, cap, F // 2)
            assert rows.scale.shape == (B_MAX, cap, F // rows.group)
            assert rows.dtype == DTYPES[dtype][1]
            deq = rows.dequantize().float().numpy()
            ref = np.asarray(want[name], np.float32)
            np.testing.assert_array_equal(deq[:lb, :ll], ref[:lb, :ll])
            assert (deq[lb:] == 0).all() and (deq[:, ll:] == 0).all()
    assert ps.dequant_bytes_total == js.dequant_bytes_total > 0


def test_fp32_load_matches_reference():
    js, ps = _stores("fp32", "bf16")
    _save_sequence(js, False)
    _save_sequence(ps, True)
    got, want = ps.load(1, 3, 24), js.load(1, 3, 24)
    for name in ("k", "v"):
        assert got[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[name].float().numpy()[:, :24],
                                      np.asarray(want[name], np.float32)[:, :24])
        assert (got[name][:, 24:] == 0).all()
    assert ps.dequant_bytes_total == 0


def test_int4_bytes_shrink_vs_fp32():
    _, fp = _stores("fp32", "f32")
    _, q4 = _stores("int4", "f32")
    assert q4.slab_nbytes(0) < 0.5 * fp.slab_nbytes(0)
    assert q4.load_nbytes(0, 2, 8) < 0.5 * fp.load_nbytes(0, 2, 8)
    assert q4.host_nbytes() < 0.5 * fp.host_nbytes()


def _slot_arrays(st, torch_side=True):
    return [a.copy() for j in range(len(st))
            for name in ("k", "v") for a in _leaf_arrays(st, j, name,
                                                         torch_side)]


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_spill_restore_lossless(kv_mode):
    """A slot spilled, clobbered and restored is bit for bit what it was,
    and the spill keys are the reference's."""
    js, ps = _stores(kv_mode, "bf16")
    _save_sequence(ps, True)
    _save_sequence(js, False)
    before = _slot_arrays(ps)
    host, jhost = HostStore(), JaxHostStore()
    ps.spill(host, "e1/slot7", 2)
    js.spill(jhost, "e1/slot7", 2)
    assert sorted(host.keys()) == sorted(jhost.keys())
    zero = torch.zeros((MAX_LEN,) + FEAT)
    for j in range(2):
        ps.save_prefill(j, 2, {"k": zero, "v": zero + 1})
    assert any(not np.array_equal(a, b)
               for a, b in zip(_slot_arrays(ps), before))
    ps.restore(host, "e1/slot7", 2)
    for a, b in zip(_slot_arrays(ps), before):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_truncate_then_append_bit_exact(kv_mode):
    """A slot truncated back to its accepted prefix and re-appended is
    bit-identical to one that never saw the rejected rows, and the
    truncated tail is exact zeros (tests/test_kvstore.py)."""
    KEEP, APPEND = 8, 4
    junk = torch.from_numpy(_rows(7, (MAX_LEN,) + FEAT))
    clean = junk.clone()
    clean[KEEP:] = 0
    fresh = torch.from_numpy(_rows(8, (APPEND,) + FEAT))
    other = torch.from_numpy(_rows(9, (MAX_LEN,) + FEAT))
    _, st_t = _stores(kv_mode, "f32")
    _, st_ref = _stores(kv_mode, "f32")
    for st, rows in ((st_t, junk), (st_ref, clean)):
        for j in range(2):
            st.save_prefill(j, 1, {"k": rows, "v": rows})
            st.save_prefill(j, 0, {"k": other, "v": other})
    st_t.truncate(1, KEEP)
    for st in (st_t, st_ref):
        for t in range(APPEND):
            dec = torch.zeros((2, 1) + FEAT)
            dec[1, 0] = fresh[t]
            pos = np.full(B_MAX, KEEP + t, np.int32)
            for j in range(2):
                st.save_decode(j, {"k": dec, "v": dec}, active=[1], pos=pos)
    live = KEEP + APPEND
    for j in range(2):
        for name in ("k", "v"):
            for a, b in zip(_leaf_arrays(st_t, j, name, True),
                            _leaf_arrays(st_ref, j, name, True)):
                np.testing.assert_array_equal(a[1, :live], b[1, :live])
                assert (a[1, live:] == 0).all()
            got, ref = st_t.load(j)[name], st_ref.load(j)[name]
            if kv_mode == "int4":
                got, ref = got.dequantize(), ref.dequantize()
            np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_truncate_clamps_and_zeroes(kv_mode):
    _, st = _stores(kv_mode, "f32")
    rows = torch.from_numpy(_rows(11, (MAX_LEN,) + FEAT))
    st.save_prefill(0, 2, {"k": rows, "v": rows})
    before = _slot_arrays(st)
    st.truncate(2, MAX_LEN + 99)                 # beyond the slab: no-op
    for a, b in zip(_slot_arrays(st), before):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    st.truncate(2, -5)                           # below zero: full wipe
    for a in _slot_arrays(st):
        assert (a[2] == 0).all()


def test_store_defaults_to_cuda_and_rejects_unknown_mode():
    with pytest.raises(ValueError):
        P.TieredKVStore([], [], b_max=1, max_len=8, kv_mode="int8",
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.TieredKVStore([], [], b_max=1, max_len=8, kv_mode="int4")
