"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode) and jnp oracles, on the same numpy inputs.

Shape sweeps and tolerances follow tests/test_kernels.py: atol 2e-5 for
both fp32 attentions, rtol 1e-5 with atol 1e-5 * max|ref| for the fp32
INT4 matmul (the two sides sum in different orders), atol 1e-6 for the
INT4-KV decode against the fp decode over the dequantized cache, and
2e-2 where caches are bf16 (test_kernels.py's bf16 tolerance).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.kvstore import dequantize_kv_rows as jax_dequant_rows  # noqa: E402
from repro.core.kvstore import kv_group, quantize_kv_rows  # noqa: E402
from repro.kernels.decode_attention import decode_attention_kernel  # noqa: E402
from repro.kernels.decode_attention import decode_attention_int4_kernel  # noqa: E402
from repro.models.attention import decode_attention as jax_decode_step  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.int4_matmul import int4_matmul as jax_int4  # noqa: E402
from repro.kernels.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.quant.int4 import quantize_int4 as jax_quantize  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention_int4 import decode_attention_int4  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.decode_attention_int4 import CHUNK, chunk_plan  # noqa: E402
from repro_torch.kernels.int4_matmul import decode_plan, fill, int4_matmul  # noqa: E402
from repro_torch.kernels.int4_matmul import MAX_CLUSTER, prefill_plan  # noqa: E402
from repro_torch.quant.int4 import unpack_int4  # noqa: E402


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (8, 128, 256),
                                   (256, 512, 128), (64, 384, 256)])
def test_int4_matmul_matches_pallas(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = _normal(rng, M, K)
    w = _normal(rng, K, N, scale=0.1)
    packed, scale = jax_quantize(jnp.asarray(w))
    ref = np.asarray(jax_int4(jnp.asarray(x), packed, scale,
                              block_m=min(128, M), block_n=min(128, N),
                              interpret=True))
    out = int4_matmul(_t(x), _t(packed), _t(scale)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("M,K,N,group", [(1, 256, 64, 128), (3, 96, 10, 32),
                                         (16, 64, 6, 32), (5, 512, 200, 128)])
def test_int4_matmul_ragged_shapes_match_oracle(M, K, N, group):
    """Shapes the Pallas kernel refuses (M not a block multiple, small
    groups, odd packed widths) against the jnp oracle."""
    from repro.kernels.ref import int4_matmul_ref as jax_ref
    rng = np.random.default_rng(7)
    x = _normal(rng, M, K)
    w = _normal(rng, K, N, scale=0.1)
    packed, scale = jax_quantize(jnp.asarray(w), group)
    ref = np.asarray(jax_ref(jnp.asarray(x), packed, scale, group))
    out = int4_matmul(_t(x), _t(packed), _t(scale), group=group).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


MAIN_KN = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))


def test_int4_split_plan_covers_k():
    """The K splits of both paths: whole groups, every group covered by a
    cluster of at most 8 blocks; at the decode shapes (M = 4) a block for
    about every other SM of a 132-SM card (a full card is slower there:
    see decode_plan), at the batch-prefill shapes (M = 512) one per SM at
    least."""
    for K, N in MAIN_KN:
        n_groups = K // 128
        lg, splits, gps = decode_plan(4, K, N, 128, 132)
        assert (splits - 1) * gps < n_groups <= splits * gps
        assert splits <= MAX_CLUSTER and 0 <= lg <= 5
        assert -(-(N // 2) // (8 << lg)) * splits >= fill(132) // 2
        splits, gps = prefill_plan(512, K, N, 128, 132)
        assert (splits - 1) * gps < n_groups <= splits * gps
        assert splits <= MAX_CLUSTER
        assert -(-N // 128) * 8 * splits >= fill(132)


@pytest.mark.parametrize("M", [1, 4, 16, 17, 37, 160, 512])
@pytest.mark.parametrize("K,N,group", [(2048, 256, 128), (5632, 2048, 128),
                                       (96, 10, 32), (64, 6, 32),
                                       (384, 200, 8)])
def test_int4_plans_cover_every_group(M, K, N, group):
    """Plans at the serving shapes and odd widths: whole groups, no empty
    split, at most 8 blocks per cluster, lanes per row a power of two."""
    n_groups = K // group
    plans = [prefill_plan(M, K, N, group, 132)]
    if M <= 16:
        lg, *rest = decode_plan(M, K, N, group, 132)
        assert 0 <= lg <= 5
        plans.append(tuple(rest))
    for splits, gps in plans:
        assert 1 <= splits <= MAX_CLUSTER
        assert (splits - 1) * gps < n_groups <= splits * gps


def _tf32(a):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: PTX cvt.rna.tf32.f32."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tc_int4_matmul(x, packed, scale, group, terms=2):
    """The tensor-core path's arithmetic in numpy: x split into TF32
    terms (x_hi, then x_lo from the f32 remainder), exact integer q, each
    8-deep step's products summed in f32 into the group accumulator (x_lo
    first), the group folded into the output as fma(scale, acc_g, acc),
    groups in order."""
    q = unpack_int4(torch.from_numpy(np.array(packed))).numpy()
    q = q.astype(np.float32)
    hi = _tf32(x)
    parts = [hi] if terms == 1 else [_tf32(x - hi), hi]
    scale = np.asarray(scale, np.float32)
    M, K = x.shape
    acc = np.zeros((M, q.shape[1]), np.float32)
    for g0 in range(0, K, group):
        accg = np.zeros_like(acc)
        for k in range(g0, g0 + group, 8):
            for a in parts:
                accg = accg + a[:, k:k + 8] @ q[k:k + 8]
        acc = (scale[g0 // group].astype(np.float64) * accg + acc
               ).astype(np.float32)
    return acc


@pytest.mark.parametrize("K", [2048, 5632])
def test_int4_tensor_core_split_holds_tolerance(K):
    """The prefill design before any card: two TF32 terms over exact
    integer weights with the per-group scale fold hold rtol 1e-5 and atol
    1e-5 * max|ref| against the Pallas kernel (interpret mode) at the
    main-path depths; one TF32 term does not."""
    rng = np.random.default_rng(K)
    M, N = 64, 128
    x = _normal(rng, M, K)
    packed, scale = jax_quantize(jnp.asarray(_normal(rng, K, N, scale=0.05)))
    ref = np.asarray(jax_int4(jnp.asarray(x), packed, scale, block_m=64,
                              block_n=128, interpret=True))
    tol = dict(rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(_tc_int4_matmul(x, packed, scale, 128), ref,
                               **tol)
    one = _tc_int4_matmul(x, packed, scale, 128, terms=1)
    assert not np.allclose(one, ref, **tol)


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("window", [0, 13])
@pytest.mark.parametrize("blocks", [(16, 16), (32, 64)])
def test_flash_attention_matches_pallas(h, hkv, window, blocks):
    bq, bk = blocks
    rng = np.random.default_rng(h * 10 + hkv + window)
    b, s, dh = 2, 64, 16
    q, k, v = (_normal(rng, b, s, h, dh), _normal(rng, b, s, hkv, dh),
               _normal(rng, b, s, hkv, dh))
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window,
                               block_q=bq, block_k=bk, interpret=True))
    out = flash_attention(_t(q), _t(k), _t(v), causal=True,
                          window=window).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("sq,sk,q_offset,causal,window",
                         [(45, 65, 20, True, 0), (77, 77, 0, True, 0),
                          (30, 50, 20, True, 9), (50, 70, 0, False, 0)])
def test_flash_attention_ragged_shapes_match_oracle(sq, sk, q_offset, causal,
                                                    window):
    """Chunked-prefill and tail shapes the Pallas kernel refuses, against
    the jnp oracle."""
    rng = np.random.default_rng(sq + sk)
    b, h, hkv, dh = 2, 8, 2, 32
    q, k, v = (_normal(rng, b, sq, h, dh), _normal(rng, b, sk, hkv, dh),
               _normal(rng, b, sk, hkv, dh))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw))
    out = flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("pos", [0, 63, 127])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
def test_decode_attention_matches_pallas(pos, h, hkv):
    rng = np.random.default_rng(pos + h)
    b, S, dh = 2, 128, 16
    q, kc, vc = (_normal(rng, b, h, dh), _normal(rng, b, S, hkv, dh),
                 _normal(rng, b, S, hkv, dh))
    ref = np.asarray(decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), pos, block_s=32,
        interpret=True))
    out = decode_attention(_t(q), _t(kc), _t(vc), pos).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("S,pos", [(128, [0, 127, 63]), (100, [99, 0, 41]),
                                   (77, [5, 76, 76])])
def test_decode_attention_ragged_pos_row_by_row(S, pos):
    """A (b,) pos: each row equals the JAX oracle run on that row alone
    with its own scalar position (tails not a multiple of any block)."""
    rng = np.random.default_rng(S)
    b, h, hkv, dh = len(pos), 8, 2, 16
    q, kc, vc = (_normal(rng, b, h, dh), _normal(rng, b, S, hkv, dh),
                 _normal(rng, b, S, hkv, dh))
    out = decode_attention(_t(q), _t(kc), _t(vc),
                           torch.tensor(pos, dtype=torch.int32)).numpy()
    for r, p in enumerate(pos):
        ref = np.asarray(jax_decode_ref(jnp.asarray(q[r:r + 1, None]),
                                        jnp.asarray(kc[r:r + 1]),
                                        jnp.asarray(vc[r:r + 1]), p))[:, 0]
        np.testing.assert_allclose(out[r:r + 1], ref, atol=2e-5)


def test_use_kernels_false_is_plain_path():
    """``use_kernels(False)`` routes every op to its plain version and
    counts no launch; CPU tensors never launch either."""
    rng = np.random.default_rng(0)
    q, kc, vc = (_normal(rng, 2, 4, 16), _normal(rng, 2, 32, 2, 16),
                 _normal(rng, 2, 32, 2, 16))
    ops.reset_launches()
    a = ops.decode_attention_op(_t(q), _t(kc), _t(vc), 20)
    ops.use_kernels(False)
    try:
        b = ops.decode_attention_op(_t(q), _t(kc), _t(vc), 20)
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sum(ops.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# decode over packed INT4 KV rows, and decode over bf16 caches
# ---------------------------------------------------------------------------


def _packed_cache(rng, b, S, hkv, dh):
    """(packed, scale) of random K and V rows, and their group."""
    F = hkv * dh
    g = kv_group(F)
    out = [quantize_kv_rows(_normal(rng, b, S, F), g) for _ in range(2)]
    return out[0], out[1], g


def _deq(pk_sc, g, shape, dtype=jnp.float32):
    return jnp.asarray(jax_dequant_rows(*pk_sc, g, dtype).reshape(shape))


@pytest.mark.parametrize("pos", [0, 63, 127])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
def test_decode_int4_matches_pallas(pos, h, hkv):
    """The plain INT4-KV decode against the Pallas INT4 kernel in
    interpret mode and the fp kernel over the dequantized cache (atol
    1e-6), and against the oracle (2e-5): test_kernels.py:77-106."""
    rng = np.random.default_rng(pos + 10 * h)
    b, S, dh = 2, 128, 16
    q = _normal(rng, b, h, dh)
    (kq, ks), (vq, vs), g = _packed_cache(rng, b, S, hkv, dh)
    out = decode_attention_int4(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), pos,
                                hkv=hkv, group=g).numpy()
    pallas = np.asarray(decode_attention_int4_kernel(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq),
        jnp.asarray(vs), pos, hkv=hkv, group=g, block_s=32, interpret=True))
    kd = _deq((kq, ks), g, (b, S, hkv, dh))
    vd = _deq((vq, vs), g, (b, S, hkv, dh))
    fp = np.asarray(decode_attention_kernel(jnp.asarray(q), kd, vd, pos,
                                            block_s=32, interpret=True))
    oracle = np.asarray(jax_decode_ref(jnp.asarray(q)[:, None], kd, vd,
                                       pos))[:, 0]
    np.testing.assert_allclose(out, pallas, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, fp, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, oracle, atol=2e-5, rtol=0)


@pytest.mark.parametrize("hkv,dh", [(2, 16), (3, 16), (4, 16)])
def test_decode_int4_ragged_pos_row_by_row(hkv, dh):
    """A (b,) pos: each row equals the Pallas INT4 kernel run on that row
    alone at its own scalar position.  F = 48 gives g = 16; F = 64 gives
    g = 32, one group spanning two heads."""
    rng = np.random.default_rng(hkv)
    pos = [127, 0, 45, 96]
    b, S, h = len(pos), 128, 2 * hkv
    q = _normal(rng, b, h, dh)
    (kq, ks), (vq, vs), g = _packed_cache(rng, b, S, hkv, dh)
    out = decode_attention_int4(
        _t(q), _t(kq), _t(ks), _t(vq), _t(vs),
        torch.tensor(pos, dtype=torch.int32), hkv=hkv, group=g).numpy()
    for r, p in enumerate(pos):
        sl = slice(r, r + 1)
        ref = np.asarray(decode_attention_int4_kernel(
            jnp.asarray(q[sl]), jnp.asarray(kq[sl]), jnp.asarray(ks[sl]),
            jnp.asarray(vq[sl]), jnp.asarray(vs[sl]), p, hkv=hkv, group=g,
            block_s=32, interpret=True))
        np.testing.assert_allclose(out[sl], ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("S,pos", [(64, [0, 63, 17]), (77, [76, 5, 40])])
def test_decode_int4_fresh_row_matches_decode_step(cache, S, pos):
    """The fresh-row form (the engines' decode step): attend packed rows
    < pos and the step's own row at pos, every value at the cache dtype
    — against the JAX step: dequantize the rows to the cache dtype, then
    ``models.attention.decode_attention`` writes the fresh row at the
    ragged pos and attends (atol 2e-5 at f32, 2e-2 at bf16)."""
    rng = np.random.default_rng(S)
    b, h, hkv, dh = len(pos), 8, 2, 16
    jdt, pdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[cache]
    q = _normal(rng, b, h, dh)
    (kq, ks), (vq, vs), g = _packed_cache(rng, b, S, hkv, dh)
    kn, vn = _normal(rng, b, hkv, dh), _normal(rng, b, hkv, dh)
    out = decode_attention_int4(
        _t(q), _t(kq), _t(ks), _t(vq), _t(vs),
        torch.tensor(pos, dtype=torch.int32), hkv=hkv, group=g,
        k_new=_t(kn), v_new=_t(vn), cache_dtype=pdt).numpy()
    ref, _, _ = jax_decode_step(
        jnp.asarray(q)[:, None], _deq((kq, ks), g, (b, S, hkv, dh), jdt),
        _deq((vq, vs), g, (b, S, hkv, dh), jdt), jnp.asarray(kn)[:, None],
        jnp.asarray(vn)[:, None], jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(out, np.asarray(ref, np.float32)[:, 0],
                               atol=2e-5 if cache == "f32" else 2e-2, rtol=0)


@pytest.mark.parametrize("S,pos", [(128, [0, 127, 63]), (77, [5, 76, 40])])
def test_decode_attention_bf16_caches(S, pos):
    """bf16 caches (the serving cache) against the JAX decode step over
    the same bf16 cache, row by row at ragged positions (atol 2e-2)."""
    rng = np.random.default_rng(S + 1)
    b, h, hkv, dh = len(pos), 8, 2, 16
    q = _normal(rng, b, h, dh)
    kc, vc = (np.asarray(jnp.asarray(_normal(rng, b, S, hkv, dh))
                         .astype(jnp.bfloat16)) for _ in range(2))
    out = decode_attention(_t(q), torch.from_numpy(
        np.asarray(kc, np.float32)).bfloat16(), torch.from_numpy(
        np.asarray(vc, np.float32)).bfloat16(),
        torch.tensor(pos, dtype=torch.int32)).numpy()
    p = np.asarray(pos)
    rows = np.arange(b)
    ref, _, _ = jax_decode_step(
        jnp.asarray(q)[:, None], jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kc[rows, p])[:, None], jnp.asarray(vc[rows, p])[:, None],
        jnp.asarray(p, jnp.int32))
    np.testing.assert_allclose(out, np.asarray(ref, np.float32)[:, 0],
                               atol=2e-2, rtol=0)


def test_decode_int4_op_plain_path_and_shape_checks():
    """``use_kernels(False)`` routes the INT4-KV op to its plain version
    with no launch; malformed inputs raise before any dispatch."""
    rng = np.random.default_rng(3)
    q = _t(_normal(rng, 2, 4, 16))
    (kq, ks), (vq, vs), g = _packed_cache(rng, 2, 32, 2, 16)
    args = (q, _t(kq), _t(ks), _t(vq), _t(vs), 20)
    ops.reset_launches()
    a = ops.decode_attention_int4_op(*args, hkv=2, group=g)
    ops.use_kernels(False)
    try:
        b_ = ops.decode_attention_int4_op(*args, hkv=2, group=g)
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert sum(ops.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        decode_attention_int4(*args, hkv=4, group=g)
    with pytest.raises(ValueError):
        decode_attention_int4(*args, hkv=2, group=g, k_new=q[:, :2])


def _chunked_decode(q, kq, ks, vq, vs, pos, hkv, group, k_new=None,
                    v_new=None):
    """The S split of ``csrc/decode_attention_int4.cu`` in torch (f32):
    each rank of ``chunk_plan`` walks its run of CHUNK-position chunks
    with an online softmax (empty ranks keep m = -1e30, l = 0), then the
    partials combine in rank order as merge_partials / finalize_partials
    do."""
    from repro_torch.core.kvstore import _dequant_impl
    b, h, dh = q.shape
    S = kq.shape[1]
    g = h // hkv
    kd, vd = (_dequant_impl(p, s_, group).reshape(b, S, hkv, dh)
              for p, s_ in ((kq, ks), (vq, vs)))
    ranks, cpr = chunk_plan(S, k_new is not None)
    out = torch.zeros(b, h, dh)
    neg = torch.tensor(-1e30)
    for r in range(b):
        p = int(pos[r])
        n_hist = min(p, S) if k_new is not None else min(p + 1, S)
        kr, vr = kd[r, :n_hist], vd[r, :n_hist]
        if k_new is not None:
            kr = torch.cat([kr, k_new[r][None]])
            vr = torch.cat([vr, v_new[r][None]])
        n_chunks = -(-kr.shape[0] // CHUNK)
        for kh in range(hkv):
            qs = q[r, kh * g:(kh + 1) * g]
            parts = []
            for rk in range(ranks):
                m, l = torch.full((g,), -1e30), torch.zeros(g)
                acc = torch.zeros(g, dh)
                for c in range(rk * cpr, min(rk * cpr + cpr, n_chunks)):
                    kt = kr[c * CHUNK:(c + 1) * CHUNK, kh]
                    vt = vr[c * CHUNK:(c + 1) * CHUNK, kh]
                    sc = (qs @ kt.T) / np.sqrt(dh)
                    m_new = torch.maximum(m, sc.amax(1))
                    alpha = torch.where(m > -5e29, torch.exp(m - m_new),
                                        torch.zeros(()))
                    pr = torch.exp(sc - m_new[:, None])
                    l = l * alpha + pr.sum(1)
                    acc = acc * alpha[:, None] + pr @ vt
                    m = m_new
                parts.append((m, l, acc))
            mm = neg
            for m, _, _ in parts:
                mm = torch.maximum(mm, m)
            ll, oo = torch.zeros(g), torch.zeros(g, dh)
            for m, l, acc in parts:
                cr = torch.exp(m - mm)
                ll = ll + l * cr
                oo = oo + acc * cr[:, None]
            out[r, kh * g:(kh + 1) * g] = oo / torch.clamp_min(ll, 1e-30)[
                :, None]
    return out


# (S, pos, hkv, dh): ragged pos with 0, pos inside the first chunk, S not
# a multiple of the chunk, g = 16 (F = 48), a group spanning two heads
# (F = 64, dh = 16), and S long enough that a rank walks several chunks
SPLIT_CASES = [(128, [0, 127, 63, 31], 4, 64), (77, [76, 5, 0], 2, 16),
               (33, [32, 0, 17], 3, 16), (64, [63, 2, 33], 4, 16),
               (300, [299, 0, 150, 40], 2, 16)]


@pytest.mark.parametrize("S,pos,hkv,dh", SPLIT_CASES)
def test_chunked_decode_int4_matches_pallas(S, pos, hkv, dh):
    """The kernel's chunked decode and rank-order combine against the
    Pallas INT4 kernel (interpret mode) run on each row alone at its own
    scalar position, and the JAX oracle over the dequantized cache (atol
    1e-6 and 2e-5)."""
    rng = np.random.default_rng(S + hkv)
    b, h = len(pos), 2 * hkv
    q = _normal(rng, b, h, dh)
    (kq, ks), (vq, vs), g = _packed_cache(rng, b, S, hkv, dh)
    out = _chunked_decode(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), pos, hkv,
                          g).numpy()
    kd = _deq((kq, ks), g, (b, S, hkv, dh))
    vd = _deq((vq, vs), g, (b, S, hkv, dh))
    for r, p in enumerate(pos):
        sl = slice(r, r + 1)
        ref = np.asarray(decode_attention_int4_kernel(
            jnp.asarray(q[sl]), jnp.asarray(kq[sl]), jnp.asarray(ks[sl]),
            jnp.asarray(vq[sl]), jnp.asarray(vs[sl]), p, hkv=hkv, group=g,
            block_s=32 if S % 32 == 0 else S, interpret=True))
        np.testing.assert_allclose(out[sl], ref, atol=1e-6, rtol=0)
        oracle = np.asarray(jax_decode_ref(jnp.asarray(q[sl])[:, None],
                                           kd[sl], vd[sl], p))[:, 0]
        np.testing.assert_allclose(out[sl], oracle, atol=2e-5, rtol=0)


@pytest.mark.parametrize("S,pos,hkv,dh", SPLIT_CASES)
def test_chunked_decode_int4_fresh_row_matches_decode_step(S, pos, hkv, dh):
    """The chunked form with the fresh row (the last position, in the
    chunk after the packed rows < pos) against the JAX decode step over
    the dequantized cache (atol 2e-5)."""
    rng = np.random.default_rng(S + 7 * hkv)
    b, h = len(pos), 2 * hkv
    q = _normal(rng, b, h, dh)
    (kq, ks), (vq, vs), g = _packed_cache(rng, b, S, hkv, dh)
    kn, vn = _normal(rng, b, hkv, dh), _normal(rng, b, hkv, dh)
    out = _chunked_decode(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), pos, hkv,
                          g, _t(kn), _t(vn)).numpy()
    ref, _, _ = jax_decode_step(
        jnp.asarray(q)[:, None], _deq((kq, ks), g, (b, S, hkv, dh)),
        _deq((vq, vs), g, (b, S, hkv, dh)), jnp.asarray(kn)[:, None],
        jnp.asarray(vn)[:, None], jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(out, np.asarray(ref)[:, 0], atol=2e-5, rtol=0)


def test_decode_int4_wrapper_takes_views_and_int_pos():
    """The wrapper's host side: q and fresh rows as strided views, an int
    pos and a (b,) int32 tensor give the plain version's result."""
    rng = np.random.default_rng(11)
    b, h, hkv, dh, S = 3, 8, 2, 16, 40
    q = _t(_normal(rng, b, h + 2, dh))[:, :h]
    (kq, ks), (vq, vs), g = _packed_cache(rng, b, S, hkv, dh)
    kn = _t(_normal(rng, b, 1, 2 * hkv, dh))[:, 0, :hkv]
    args = (q, _t(kq), _t(ks), _t(vq), _t(vs))
    kw = dict(hkv=hkv, group=g, k_new=kn, v_new=kn)
    a = decode_attention_int4(*args, 20, **kw)
    b_ = decode_attention_int4(*args, torch.full((b,), 20, dtype=torch.int32),
                               **kw)
    c = decode_attention_int4(q.contiguous(), *args[1:], 20,
                              hkv=hkv, group=g, k_new=kn.contiguous(),
                              v_new=kn.contiguous())
    torch.testing.assert_close(a, b_, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
