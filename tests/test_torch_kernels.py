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
from repro_torch.kernels.decode_attention import (  # noqa: E402
    CLUSTER, TILE, rank_runs, row_len)
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


def _tc_flash(q, k, v, causal=True, window=0, q_offset=0, terms=3,
              wr=1, splits=1):
    """``csrc/flash_attention.cu``'s arithmetic in numpy: 16 query rows
    at a time, key tiles of 32 from the first the rows can attend to the
    last, each 8-deep step of Q.K and of P.V summed in f32 from TF32
    terms (lo*hi, hi*lo, hi*hi, small terms first; ``terms=1``: hi*hi
    alone), scores scaled by the f32 1/sqrt(dh) and masked by position,
    the online softmax with its alpha rescale, out = o / max(l, 1e-30).
    With ``splits`` > 1 the rows' block (``wr`` row tiles) splits its
    tiles into contiguous rank ranges; each rank walks its share of the
    rows' tiles to (m, l, o), and the ranks merge in rank order: m the
    largest, each rank's l and o scaled by exp(m_rank - m), summed, out =
    o / max(l, 1e-30)."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qh = q.transpose(0, 2, 1, 3)                      # (b, h, sq, dh)
    kh, vh = (np.repeat(t.transpose(0, 2, 1, 3), g, axis=1) for t in (k, v))
    scale = np.float32(1.0 / np.sqrt(dh))
    neg = np.float32(-1e30)

    def products(a, b_):
        ah, bh = _tf32(a), _tf32(b_)
        if terms == 1:
            return [(ah, bh)]
        return [(_tf32(a - ah), bh), (ah, _tf32(b_ - bh)), (ah, bh)]

    def tiles(r0):
        nr = min(16, sq - r0)
        if nr <= 0:
            return range(0)
        k_hi = min(sk - 1, q_offset + r0 + nr - 1) if causal else sk - 1
        k_lo = max(0, q_offset + r0 - window + 1) if window else 0
        return range(k_lo // 32, k_hi // 32 + 1) if k_hi >= k_lo else range(0)

    def walk(qt, qp, ts):
        m = np.full((b, h, 16), neg)
        l = np.zeros((b, h, 16), np.float32)
        o = np.zeros((b, h, 16, dh), np.float32)
        for t in ts:
            t0 = 32 * t
            kt = np.zeros((b, h, 32, dh), np.float32)
            vt = np.zeros_like(kt)
            n = min(32, sk - t0)
            kt[:, :, :n], vt[:, :, :n] = (kh[:, :, t0:t0 + n],
                                          vh[:, :, t0:t0 + n])
            s = np.zeros((b, h, 16, 32), np.float32)
            for d0 in range(0, dh, 8):
                for a, b_ in products(qt[..., d0:d0 + 8],
                                      kt[..., d0:d0 + 8].swapaxes(-1, -2)):
                    s = s + a @ b_
            kp = (t0 + np.arange(32))[None, :]
            ok = kp < sk
            if causal:
                ok = ok & (kp <= qp)
            if window:
                ok = ok & (qp - kp < window)
            s = np.where(ok, s * scale, neg)
            m_new = np.maximum(m, s.max(-1))
            alpha = np.where(m > neg / 2, np.exp(m - m_new), np.float32(0))
            p = np.where(ok, np.exp(s - m_new[..., None]), np.float32(0))
            l = l * alpha + p.sum(-1, dtype=np.float32)
            o = o * alpha[..., None]
            for c0 in range(0, 32, 8):
                for a, b_ in products(p[..., c0:c0 + 8], vt[..., c0:c0 + 8, :]):
                    o = o + a @ b_
            m = m_new
        return m, l, o

    out = np.zeros((b, h, sq, dh), np.float32)
    for r0 in range(0, sq, 16):
        nr = min(16, sq - r0)
        qt = np.zeros((b, h, 16, dh), np.float32)
        qt[:, :, :nr] = qh[:, :, r0:r0 + nr]
        qp = (q_offset + r0 + np.arange(16))[:, None]
        mine = tiles(r0)
        rb0 = r0 // (16 * wr) * 16 * wr             # the block's row tiles
        union = [t for r in range(rb0, rb0 + 16 * wr, 16) for t in tiles(r)]
        lo, nb = (min(union), max(union) - min(union) + 1) if union else (0, 0)
        parts = [walk(qt, qp, [t for t in mine
                               if lo + nb * r // splits <= t
                               < lo + nb * (r + 1) // splits])
                 for r in range(splits)]
        if splits == 1:
            m, l, o = parts[0]
        else:
            mx = np.max([pm for pm, _, _ in parts], axis=0)
            l = np.zeros_like(parts[0][1])
            o = np.zeros_like(parts[0][2])
            for pm, pl, po in parts:
                a = np.where(pm > neg / 2, np.exp(pm - mx), np.float32(0))
                l = l + a * pl
                o = o + a[..., None] * po
        res = o / np.maximum(l, np.float32(1e-30))[..., None]
        out[:, :, r0:r0 + nr] = res[:, :, :nr]
    return out.transpose(0, 2, 1, 3)


# (b, sq, sk, h, hkv, dh, causal, window, q_offset): the Pallas cases'
# window, sq and sk not multiples of 16 or 32, q_offset (chunked prefill),
# no causal mask, g = 1 and 8
TC_FLASH_CASES = [(2, 64, 64, 8, 2, 16, True, 13, 0),
                  (2, 64, 64, 4, 1, 16, True, 0, 0),
                  (2, 45, 65, 8, 2, 32, True, 0, 20),
                  (2, 30, 50, 8, 2, 32, True, 9, 20),
                  (2, 77, 77, 8, 2, 32, True, 0, 0),
                  (1, 50, 70, 4, 4, 16, False, 0, 0),
                  (1, 37, 37, 16, 2, 64, True, 0, 0)]


@pytest.mark.parametrize("b,sq,sk,h,hkv,dh,causal,window,q_offset",
                         TC_FLASH_CASES)
def test_flash_tensor_core_split_holds_tolerance(b, sq, sk, h, hkv, dh,
                                                 causal, window, q_offset):
    """The flash design before any card: three TF32 terms per product
    hold atol 2e-5 against the Pallas kernel (interpret mode) where it
    takes the shape, else the jnp oracle; one TF32 term does not."""
    rng = np.random.default_rng(sq * sk + h)
    q, k, v = (_normal(rng, b, sq, h, dh), _normal(rng, b, sk, hkv, dh),
               _normal(rng, b, sk, hkv, dh))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if sq == sk and sq % 16 == 0 and not q_offset:
        ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=16, block_k=16,
                                   interpret=True, causal=causal,
                                   window=window))
    else:
        ref = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw))
    np.testing.assert_allclose(_tc_flash(q, k, v, **kw), ref, atol=2e-5,
                               rtol=0)
    assert not np.allclose(_tc_flash(q, k, v, terms=1, **kw), ref,
                           atol=2e-5, rtol=0)


def test_flash_tensor_core_split_at_generation_shape():
    """The same at the generation prefill shape (b 4, sq 128, h 32, hkv 4,
    dh 64) against the plain version."""
    rng = np.random.default_rng(128)
    q, k, v = (_normal(rng, 4, 128, 32, 64), _normal(rng, 4, 128, 4, 64),
               _normal(rng, 4, 128, 4, 64))
    ref = flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(_tc_flash(q, k, v), ref, atol=2e-5, rtol=0)
    assert not np.allclose(_tc_flash(q, k, v, terms=1), ref, atol=2e-5,
                           rtol=0)


# (b, sq, sk, h, hkv, dh, causal, window, q_offset, wr, splits): whisper's
# cross prefill scaled down (32 rows over 320 keys, group 1, no causal
# mask), a short chunk over a long prefix (causal at q_offset), the same
# under a window, group 2 with two row tiles a block
SPLIT_FLASH_CASES = [(1, 32, 320, 4, 4, 32, False, 0, 0, 4, 8),
                     (1, 32, 320, 4, 2, 32, True, 0, 288, 2, 4),
                     (2, 32, 320, 4, 4, 16, True, 100, 288, 4, 2),
                     (1, 64, 320, 8, 4, 32, True, 0, 256, 2, 8)]


@pytest.mark.parametrize("b,sq,sk,h,hkv,dh,causal,window,q_offset,wr,splits",
                         SPLIT_FLASH_CASES)
def test_flash_key_split_merge_holds_tolerance(b, sq, sk, h, hkv, dh, causal,
                                               window, q_offset, wr, splits):
    """The key split before any card: each rank of a cluster walks a
    contiguous share of its block's key tiles with the kernel's three
    TF32 terms, and the ranks' (m, l, O) merge in rank order; that holds
    atol 2e-5 against the Pallas kernel (interpret mode) and agrees with
    the unsplit arithmetic to a few f32 roundings."""
    rng = np.random.default_rng(sk + q_offset + splits)
    q, k, v = (_normal(rng, b, sq, h, dh), _normal(rng, b, sk, hkv, dh),
               _normal(rng, b, sk, hkv, dh))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), block_q=16, block_k=32,
                               interpret=True, **kw))
    split = _tc_flash(q, k, v, wr=wr, splits=splits, **kw)
    np.testing.assert_allclose(split, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(split, _tc_flash(q, k, v, wr=wr, **kw),
                               atol=2e-6, rtol=0)


# (b, sq, sk, h, hkv, dh, itemsize, causal, window, q_offset, warps,
# blocks, splits): the generation prefill (group 8), serving prefills of
# one slot (sq 37, 141), odd shapes (groups 1, 3, 4, 6); whisper's encoder
# (group 1, 1500 rows bidirectional: a split of 2 evens the SMs' loads)
# and its cross prefill (48 rows over 1500 keys: a split of 8), Gemma 3's
# window (group 2, dh 256: at f32 a split of 2, at bf16 8 warps), DeepSeek-
# V3's MLA prefill (group 1, dh 192: 8 warps at f32, one block an SM), a
# short chunk over a long prefix (split 8), the 8B's prefill chunks (no
# split: 3-4 tiles), a window with an offset
FLASH_PLAN_CASES = [(4, 128, 128, 32, 4, 64, 4, True, 0, 0, 4, 256, 1),
                    (1, 37, 37, 32, 4, 64, 4, True, 0, 0, 4, 24, 1),
                    (1, 141, 141, 32, 4, 64, 4, True, 0, 0, 4, 72, 1),
                    (1, 34, 34, 32, 4, 64, 4, True, 0, 0, 4, 24, 1),
                    (2, 45, 45, 8, 2, 64, 4, True, 0, 0, 4, 12, 1),
                    (3, 7, 7, 6, 6, 64, 4, True, 0, 0, 4, 18, 1),
                    (1, 300, 300, 12, 4, 64, 4, True, 0, 0, 4, 120, 2),
                    (2, 33, 33, 12, 2, 64, 4, True, 0, 0, 4, 24, 1),
                    (1, 1500, 1500, 8, 8, 64, 4, False, 0, 0, 4, 384, 2),
                    (1, 48, 1500, 8, 8, 64, 4, False, 0, 0, 4, 64, 8),
                    (1, 1500, 1500, 8, 4, 256, 4, True, 1024, 0, 4, 376, 2),
                    (1, 1500, 1500, 8, 4, 256, 2, True, 1024, 0, 8, 96, 1),
                    (1, 114, 114, 128, 128, 192, 4, True, 0, 0, 8, 128, 1),
                    (1, 114, 114, 128, 128, 192, 2, True, 0, 0, 4, 256, 1),
                    (1, 32, 1500, 32, 8, 128, 4, True, 0, 1468, 4, 128, 8),
                    (1, 32, 96, 32, 8, 128, 4, True, 0, 64, 4, 16, 1),
                    (1, 18, 114, 32, 8, 128, 4, True, 0, 96, 4, 16, 1),
                    (2, 40, 400, 4, 4, 64, 4, True, 200, 360, 4, 16, 2)]


def _flash_tiles(row0, sq, sk, causal, window, q_offset):
    """The key tiles (of 32) 16 rows from ``row0`` attend, as a set."""
    rows = np.arange(row0, min(row0 + 16, sq))
    keys = set()
    for r in rows:
        qp = q_offset + r
        hi = min(sk - 1, qp) if causal else sk - 1
        lo = max(0, qp - window + 1) if window else 0
        keys.update(range(lo, hi + 1))
    return {j // 32 for j in keys}


@pytest.mark.parametrize(
    "b,sq,sk,h,hkv,dh,itemsize,causal,window,q_offset,warps,blocks,splits",
    FLASH_PLAN_CASES)
def test_flash_plan_covers_every_row(b, sq, sk, h, hkv, dh, itemsize, causal,
                                     window, q_offset, warps, blocks, splits):
    """``flash_plan`` and the kernel's block map (``csrc/flash_attention.cu``
    block_span): every query row of every head covered exactly once; every
    key tile a warp's rows attend walked by exactly one rank of its
    cluster, the ranks' ranges contiguous; ``wh * wr >= 4`` warps a block
    at every shape; the warps, block and split counts stated at the
    main-path shapes (generation and serving prefills, whisper, Gemma 3,
    MLA, prefill chunks) and odd ones; the block within the shared
    memory."""
    from repro_torch.kernels.flash_attention import (ROWS, SMEM_MAX,
                                                     flash_plan, smem_bytes)
    g = h // hkv
    wh, wr, n_split, n_blocks = flash_plan(b, sq, sk, h, hkv, causal,
                                           window, q_offset, dh=dh,
                                           itemsize=itemsize)
    assert wh * wr >= 4 and g % wh == 0
    assert (wh * wr, n_blocks, n_split) == (warps, blocks, splits)
    assert smem_bytes(dh, itemsize, wh * wr, n_split) <= SMEM_MAX
    n_qt = -(-sq // ROWS)
    n_rb, n_hg = -(-n_qt // wr), g // wh
    assert n_blocks == b * hkv * n_hg * n_rb * n_split
    seen = np.zeros((b, sq, h), np.int64)
    for bi in range(b):
        for kh in range(hkv):
            for y in range(n_hg * n_rb):            # blockIdx.x / splits
                hg, rb = y % n_hg, n_rb - 1 - y // n_hg
                row_tiles = [(rb * wr + r) * ROWS for r in range(wr)]
                union = set().union(*(_flash_tiles(r0, sq, sk, causal, window,
                                                   q_offset)
                                      for r0 in row_tiles))
                lo, nb = (min(union), max(union) - min(union) + 1) \
                    if union else (0, 0)
                ranks = [set(range(lo + nb * r // n_split,
                                   lo + nb * (r + 1) // n_split))
                         for r in range(n_split)]
                assert sum(len(t) for t in ranks) == nb
                for warp in range(wh * wr):
                    head = kh * g + hg * wh + warp % wh
                    row0 = row_tiles[warp // wh]
                    seen[bi, row0:min(sq, row0 + ROWS), head] += 1
                    mine = _flash_tiles(row0, sq, sk, causal, window,
                                        q_offset)
                    for t in mine:
                        assert sum(t in r for r in ranks) == 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cost_at_dh192_is_the_functions_work(dtype):
    """On meta tensors at DeepSeek-V3's MLA prefill shape (128 heads of
    group 1, head_dim dn + dr = 192, which has its own kernel instance)
    the op reports the function's work at dh 192: 4 * h * 192 operations
    per attended pair, q, k, v and the output once each at their own
    size; nothing at a padded width."""
    from repro_torch.kernels import cost
    b, s, h, dh = 1, 114, 128, 192
    q = torch.empty(b, s, h, dh, dtype=dtype, device="meta")
    seen = []
    with cost.listening(lambda name, c, shapes: seen.append((name, c))):
        out = ops.flash_attention_op(q, q, q, causal=True)
    assert out.shape == q.shape and out.device.type == "meta"
    pairs = s * (s + 1) // 2
    want = cost.Cost(4.0 * b * h * dh * pairs,
                     float(q.element_size() * 4 * b * s * h * dh))
    assert seen == [("flash_attention", want)]
    assert want == cost.flash_attention(b, s, s, h, h, dh,
                                        itemsize=q.element_size())


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


WARPS = 4                       # the kernels' warps a block
TW = TILE // WARPS              # positions a warp takes of each tile


def _empty(g, dh):
    return torch.full((g,), -1e30), torch.zeros(g), torch.zeros(g, dh)


def _merge(parts, g, dh):
    """Partials (m, l, o) merged in order as merge_partials does: every
    weight from the common max, the sums taken in the parts' order."""
    mm = torch.full((g,), -1e30)
    for m, _, _ in parts:
        mm = torch.maximum(mm, m)
    ll, oo = torch.zeros(g), torch.zeros(g, dh)
    for m, l, o in parts:
        c = torch.exp(m - mm)
        ll = ll + l * c
        oo = oo + o * c[:, None]
    return mm, ll, oo


def _rank_partial(qs, k, v, first, stop):
    """One rank's partial over positions [first, stop) of a row (first a
    multiple of TILE): in each tile, warp w takes positions TW w .. TW w
    + TW - 1 and updates its own online softmax; the warps' partials
    merge in warp order."""
    g, dh = qs.shape
    scale = torch.tensor(1.0 / np.sqrt(dh), dtype=torch.float32)
    warps = []
    for w in range(WARPS):
        m, l, acc = _empty(g, dh)
        for t0 in range(first, stop, TILE):
            a, z = t0 + w * TW, min(t0 + (w + 1) * TW, stop)
            if a >= z:
                continue
            sc = (qs @ k[a:z].T) * scale
            m_new = torch.maximum(m, sc.amax(1))
            alpha = torch.where(m > -5e29, torch.exp(m - m_new),
                                torch.zeros(()))
            pr = torch.exp(sc - m_new[:, None])
            l = l * alpha + pr.sum(1)
            acc = acc * alpha[:, None] + pr @ v[a:z]
            m = m_new
        warps.append((m, l, acc))
    return _merge(warps, g, dh)


def _chunked_decode(q, kc, vc, pos, k_new=None, v_new=None):
    """The step of ``csrc/decode_attention_common.cuh`` in torch (f32)
    over caches (b, S, hkv, dh) of any float dtype (widened to f32): a
    row's ``row_len`` live positions split by ``rank_runs`` into runs of
    whole TILE-position tiles; each rank's warps over its tiles' positions
    (``_rank_partial``); the ranks' partials combined in rank order
    (``_merge``, then o / max(l, 1e-30)).  With ``k_new``/``v_new`` (b,
    hkv, dh) a row attends positions < pos and the fresh row after them
    (``decode_attention_int4``'s form)."""
    b, h, dh = q.shape
    S, hkv = kc.shape[1], kc.shape[2]
    g = h // hkv
    kd, vd = kc.float(), vc.float()
    fresh = k_new is not None
    out = torch.zeros(b, h, dh)
    for r in range(b):
        n = row_len(int(pos[r]), S, fresh)
        n_hist = n - 1 if fresh else n
        kr, vr = kd[r, :n_hist], vd[r, :n_hist]
        if fresh:
            kr = torch.cat([kr, k_new[r][None].float()])
            vr = torch.cat([vr, v_new[r][None].float()])
        for kh in range(hkv):
            qs = q[r, kh * g:(kh + 1) * g].float()
            parts = [_rank_partial(qs, kr[:, kh], vr[:, kh], a, z)
                     for a, z in rank_runs(n)]
            _, ll, oo = _merge(parts, g, dh)
            out[r, kh * g:(kh + 1) * g] = oo / torch.clamp_min(ll, 1e-30)[
                :, None]
    return out


def _deq_t(kq, ks, vq, vs, hkv, group):
    """Packed K/V rows (numpy) -> f32 caches (b, S, hkv, dh) in torch."""
    from repro_torch.core.kvstore import _dequant_impl
    b, S = kq.shape[:2]
    return tuple(_dequant_impl(_t(p), _t(s_), group).reshape(b, S, hkv, -1)
                 for p, s_ in ((kq, ks), (vq, vs)))


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
    out = _chunked_decode(_t(q), *_deq_t(kq, ks, vq, vs, hkv, g),
                          pos).numpy()
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
    out = _chunked_decode(_t(q), *_deq_t(kq, ks, vq, vs, hkv, g), pos,
                          _t(kn), _t(vn)).numpy()
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


@pytest.mark.parametrize("S,pos,hkv,dh", SPLIT_CASES)
def test_chunked_decode_matches_pallas(S, pos, hkv, dh):
    """``decode_attention``'s chunked decode and rank-order combine over
    f32 caches against the Pallas ``decode_attention_kernel`` (interpret
    mode) run on each row alone at its own scalar position (atol 2e-5)."""
    rng = np.random.default_rng(S + 3 * hkv)
    b, h = len(pos), 2 * hkv
    q = _normal(rng, b, h, dh)
    kc, vc = _normal(rng, b, S, hkv, dh), _normal(rng, b, S, hkv, dh)
    out = _chunked_decode(_t(q), _t(kc), _t(vc), pos).numpy()
    for r, p in enumerate(pos):
        sl = slice(r, r + 1)
        ref = np.asarray(decode_attention_kernel(
            jnp.asarray(q[sl]), jnp.asarray(kc[sl]), jnp.asarray(vc[sl]), p,
            block_s=32 if S % 32 == 0 else S, interpret=True))
        np.testing.assert_allclose(out[sl], ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("S,pos,hkv,dh", SPLIT_CASES)
def test_chunked_decode_bf16_caches(S, pos, hkv, dh):
    """The chunked decode over bf16 caches (the serving cache; values
    widened to f32, arithmetic f32) against the plain version over the
    same caches (atol 2e-2: it rounds probabilities to bf16) and over the
    caches widened to f32 (atol 2e-5)."""
    rng = np.random.default_rng(S + 5 * hkv)
    b, h = len(pos), 2 * hkv
    q = _t(_normal(rng, b, h, dh))
    kc, vc = (_t(_normal(rng, b, S, hkv, dh)).bfloat16() for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32)
    out = _chunked_decode(q, kc, vc, pos)
    torch.testing.assert_close(out, decode_attention(q, kc, vc, p), rtol=0,
                               atol=2e-2)
    torch.testing.assert_close(out, decode_attention(q, kc.float(),
                                                     vc.float(), p),
                               rtol=0, atol=2e-5)


# (what, S, pos, fresh): the main path's decode rows (chip_smoke.py's
# kernel checks): tinyllama's generation and serving steps (S 160), the
# 8B's serving shape (dh 128), Gemma 3's global slab (S 1536; packed S
# 2048 with the fresh row) and its rolling buffers (W 1024, pos clamped),
# jamba's attention layer, whisper's cross rows (1500) and self slab
# (448), and run (ad)'s dh 16 engines
PLAN_ROWS = [("tinyllama generation", 160, [158] * 4, False),
             ("tinyllama serving", 160, [159, 0, 77, 131], True),
             ("llama3.1-8b serving", 160, [159, 0, 77, 131], False),
             ("gemma3 global", 1536, [1515, 1031, 315, 129], False),
             ("gemma3 global packed", 2048, [1515, 1031, 315, 129], True),
             ("gemma3 rolling", 1024, [1023, 1023, 299, 113], False),
             ("jamba", 128, [116, 95, 83, 60], False),
             ("whisper cross", 1500, [1499] * 4, False),
             ("whisper self", 448, [19, 23, 31, 39], False),
             ("ad quickstart dh 16", 64, [46, 33], False),
             ("ad serve dh 16", 128, [0, 11, 13, 28], True)]


@pytest.mark.parametrize("what,S,pos,fresh", PLAN_ROWS,
                         ids=[r[0] for r in PLAN_ROWS])
def test_rank_runs_cover_each_position_once(what, S, pos, fresh):
    """Each row's runs cover its live positions exactly once, in rank
    order, each a run of whole TILE-position tiles (the last one cut at
    the row's end), on min(CLUSTER, tiles) ranks whose runs differ by at
    most one tile."""
    for p in pos:
        n = row_len(p, S, fresh)
        runs = rank_runs(n)
        tiles = -(-n // TILE)
        assert len(runs) == min(CLUSTER, tiles)
        covered = [t for a, z in runs for t in range(a, z)]
        assert covered == list(range(n))
        assert all(a % TILE == 0 and (z % TILE == 0 or z == n)
                   for a, z in runs)
        sizes = [-(-(z - a) // TILE) for a, z in runs]
        assert not sizes or max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n", [1, 31, 32, 33, 130, 160, 257, 1500, 1516,
                               2048])
def test_rank_count_depends_on_live_positions_alone(n):
    """A row's runs are a function of its live positions alone: the same
    for the row at pos n - 1 over any slab that holds it, with or
    without a fresh row in place of its last cached row."""
    runs = rank_runs(n)
    for S in (n, n + 1, n + 37, 4096):
        assert rank_runs(row_len(n - 1, S)) == runs
        assert rank_runs(row_len(n - 1, S, fresh=True)) == runs
    assert len(runs) == min(CLUSTER, -(-n // TILE))


# (b, S, hkv, dh, pos, the row compared, fresh)
ROW_CASES = [(4, 160, 4, 64, [159, 0, 77, 131], 2, False),
             (4, 160, 4, 64, [159, 0, 77, 131], 0, True),
             (3, 300, 2, 16, [299, 0, 150], 0, False),
             (3, 300, 2, 16, [299, 0, 150], 2, True),
             (2, 77, 3, 16, [40, 76], 1, False),
             (4, 96, 1, 32, [95, 0, 64, 31], 3, True)]


@pytest.mark.parametrize("b,S,hkv,dh,pos,r,fresh", ROW_CASES)
def test_emulated_row_depends_on_its_row_alone(b, S, hkv, dh, pos, r, fresh):
    """The emulated kernel's output of a row is bit-equal whether the
    row runs alone, in a batch of other rows, or over a longer slab."""
    rng = np.random.default_rng(S + r)
    h = 2 * hkv
    q = _t(_normal(rng, b, h, dh))
    kc, vc = _t(_normal(rng, b, S, hkv, dh)), _t(_normal(rng, b, S, hkv, dh))
    kn, vn = ((_t(_normal(rng, b, hkv, dh)), _t(_normal(rng, b, hkv, dh)))
              if fresh else (None, None))
    sl = slice(r, r + 1)
    batch = _chunked_decode(q, kc, vc, pos, kn, vn)[sl]
    alone = _chunked_decode(q[sl], kc[sl], vc[sl], pos[sl],
                            *((kn[sl], vn[sl]) if fresh else ()))
    pad = _t(_normal(rng, b, 45, hkv, dh))
    longer = _chunked_decode(q, torch.cat([kc, pad], 1),
                             torch.cat([vc, -pad], 1), pos, kn, vn)[sl]
    assert torch.equal(batch, alone)
    assert torch.equal(batch, longer)


def test_decode_wrapper_host_arguments():
    """The decode wrappers' host side: an int pos stays a kernel argument
    (no tensor made), a (b,) int32 tensor on the device passes as it is,
    anything else becomes one; q's batch stride is read from a view whose
    rows are contiguous and refused otherwise; the plain path gives the
    same result for an int pos, a tensor pos and a strided q."""
    from repro_torch.kernels.decode_attention import pos_args, row_stride
    cpu = torch.device("cpu")
    assert pos_args(7, 3, cpu) == (None, 7)
    p32 = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert pos_args(p32, 3, cpu)[0] is p32
    pt, p0 = pos_args(torch.tensor(5), 3, cpu)
    assert p0 == 0 and pt.dtype == torch.int32 and pt.tolist() == [5, 5, 5]
    rng = np.random.default_rng(13)
    b, h, hkv, dh, S = 3, 8, 2, 16, 40
    qf = _t(_normal(rng, b, 1, h + 4, dh))
    q = qf[:, 0, :h]
    assert row_stride(q, "q") == (h + 4) * dh
    with pytest.raises(ValueError):
        row_stride(qf[:, 0, :, :8], "q")
    kc, vc = _t(_normal(rng, b, S, hkv, dh)), _t(_normal(rng, b, S, hkv, dh))
    a = decode_attention(q, kc, vc, 20)
    torch.testing.assert_close(a, decode_attention(q, kc, vc, torch.full(
        (b,), 20, dtype=torch.int32)), rtol=0, atol=0)
    torch.testing.assert_close(a, decode_attention(q.contiguous(), kc, vc,
                                                   20), rtol=0, atol=0)


def test_lib_path_hashes_shared_headers(tmp_path, monkeypatch):
    """A kernel library is keyed by its source and every shared header:
    editing ``csrc/*.cuh`` gives a new path (a stale library is never
    loaded); the same bytes give the same path."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.lib_path("k")
    assert _build.lib_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build.lib_path("k") != first
    (tmp_path / "common.cuh").write_text("// v1\n")
    assert _build.lib_path("k") == first
    (tmp_path / "other.cuh").write_text("\n")
    assert _build.lib_path("k") != first
