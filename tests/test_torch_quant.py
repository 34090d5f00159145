"""INT4 layouts and merged buffers: the port against the JAX package,
bit for bit (integer and exactly rounded arithmetic)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import transfer as jax_transfer  # noqa: E402
from repro.quant import int4 as jax_int4  # noqa: E402
from repro_torch.core import transfer  # noqa: E402
from repro_torch.quant import int4  # noqa: E402


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("K,N,group", [(128, 64, 128), (256, 384, 128),
                                       (2048, 256, 128), (96, 10, 32),
                                       (64, 8, 16)])
def test_quantize_pack_dequant_bit_identical(K, N, group):
    rng = np.random.default_rng(K * N)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    # exact halves of a scale step exercise round-half-to-even
    w[0, :4] = [0.5, -0.5, 1.5, 2.5]
    w[group - 1, :2] = [7.0, -7.0]
    jp, js = jax_int4.quantize_int4(jnp.asarray(w), group)
    tp, ts = int4.quantize_int4(torch.from_numpy(w), group)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(_bits(js), _bits(ts.numpy()))
    jd = jax_int4.dequantize_int4(jp, js, jnp.float32, group)
    td = int4.dequantize_int4(tp, ts, torch.float32, group)
    np.testing.assert_array_equal(_bits(jd), _bits(td.numpy()))


def test_pack_unpack_roundtrip_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.integers(-8, 8, (32, 18)).astype(np.int32)
    jp = np.asarray(jax_int4.pack_int4(jnp.asarray(q)))
    tp = int4.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(int4.unpack_int4(tp).numpy(), q)
    np.testing.assert_array_equal(
        np.asarray(jax_int4.unpack_int4(jnp.asarray(jp))),
        int4.unpack_int4(tp).numpy())


@pytest.mark.parametrize("K", [128, 96, 48, 2048, 5632, 40])
def test_groups_match_reference(K):
    assert int4.stack_group(K) == jax_int4.stack_group(K)
    for N in (2, 3, 64):
        a = np.zeros((K, N), np.float32)
        assert transfer.int4_group(a) == jax_transfer.int4_group(a)
    assert transfer.int4_group(np.zeros(K)) is None


def _unit(rng, quant: bool):
    t = {"wq": (rng.standard_normal((128, 128)) * 0.1).astype(np.float32),
         "wk": (rng.standard_normal((128, 64)) * 0.1).astype(np.float32),
         "norm": np.zeros(128, np.float32),
         "odd": np.arange(7, dtype=np.uint8)}
    if quant:
        for name in ("wq", "wk"):
            p, s = jax_int4.quantize_int4(jnp.asarray(t.pop(name)))
            t[name + "#q"], t[name + "#s"] = np.asarray(p), np.asarray(s)
    return t


@pytest.mark.parametrize("quant", [False, True])
def test_merge_tensors_byte_identical(quant):
    t = _unit(np.random.default_rng(1), quant)
    jbuf, jman = jax_transfer.merge_tensors(t)
    tbuf, tman = transfer.merge_tensors(t)
    np.testing.assert_array_equal(jbuf, tbuf)
    assert (tman.entries, tman.total_bytes) == (jman.entries,
                                                jman.total_bytes)
    # torch inputs merge to the same bytes
    tbuf2, tman2 = transfer.merge_tensors(
        {k: torch.from_numpy(v) for k, v in t.items()})
    np.testing.assert_array_equal(tbuf2, jbuf)
    assert tman2.entries == jman.entries


def test_split_views_roundtrip():
    """Views back out of the merged tensor equal the inputs, aligned
    entries as zero-copy views and a misaligned one as a copy."""
    t = _unit(np.random.default_rng(2), True)
    t["zz_after_odd"] = np.arange(5, dtype=np.float32)
    buf, man = transfer.merge_tensors(t)
    views = transfer.split_views(torch.from_numpy(buf), man)
    assert set(views) == set(t)
    for name, a in t.items():
        np.testing.assert_array_equal(views[name].numpy(), a)
    base = torch.from_numpy(buf).data_ptr()
    assert views["norm"].data_ptr() == base + man.entries["norm"][0]
