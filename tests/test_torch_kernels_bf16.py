"""The kernels' bf16 instances on the CPU: the port's plain versions at
bf16 against the JAX package's Pallas kernels at bf16 (interpret mode),
on the same numpy inputs rounded to bf16 on both sides, and the ops on
meta tensors at bf16.

The tolerance is the JAX suite's for bf16, 2e-2 (tests/test_kernels.py:
29 and :59), taken here as 2e-2 x max|Pallas| on every element.  It
covers the places where the two sides round at bf16 differently: the
port's ``ref_attention`` normalises P before it rounds it to bf16 (as
the JAX package's jnp oracle does), while the Pallas kernel and the
card's bf16 flash instance round the unnormalised P; the plain decode
over bf16 caches rounds P to bf16 where the Pallas decode keeps it f32.

Also the designs before any card: a numpy model of the bf16 flash
instance's arithmetic (``csrc/flash_attention.cu``: bf16 products with
f32 sums, the unnormalised P rounded to bf16 tile by tile) holds the same
tolerance against Pallas; a bf16 ``x`` is exact in TF32, so the
int4_matmul tensor-core path's second TF32 term is zero and its one-term
bf16 instance equals the two-term f32 arithmetic on the widened x.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core.kvstore import kv_group, quantize_kv_rows  # noqa: E402
from repro.kernels.decode_attention import decode_attention_int4_kernel  # noqa: E402
from repro.kernels.decode_attention import decode_attention_kernel  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.int4_matmul import int4_matmul as jax_int4  # noqa: E402
from repro.quant.int4 import quantize_int4 as jax_quantize  # noqa: E402
from repro_torch.kernels import cost, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention_int4 import decode_attention_int4  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.int4_matmul import int4_matmul  # noqa: E402
from repro_torch.quant.int4 import unpack_int4  # noqa: E402
from repro_torch.roofline import analyze_step  # noqa: E402

BF16_TOL = 2e-2          # tests/test_kernels.py:29, :59 (bf16)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf(a):
    """The same f32 numpy values rounded to bf16 in both frameworks
    (both round to nearest even): (torch tensor, jax array)."""
    return (torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16),
            jnp.asarray(a).astype(jnp.bfloat16))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(out, ref, tol=BF16_TOL):
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _round_bf16(a):
    """f32 -> bf16 -> f32, to nearest even (the card's cvt.rn.bf16)."""
    return _f32(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                .to(torch.bfloat16))


# ---------------------------------------------------------------------------
# int4_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (8, 128, 256),
                                   (256, 512, 128), (64, 384, 256)])
def test_int4_matmul_bf16_matches_pallas(M, K, N):
    """tests/test_kernels.py:18-19's shapes at bf16 x: the port's plain
    version (f32 output cast to x's dtype) against the Pallas kernel with
    a bf16 ``out_dtype``; bf16 in, bf16 out on both."""
    rng = np.random.default_rng(M + K + N)
    xt, xj = _bf(_normal(rng, M, K))
    packed, scale = jax_quantize(jnp.asarray(_normal(rng, K, N, scale=0.1)))
    ref = jax_int4(xj, packed, scale, block_m=min(128, M),
                   block_n=min(128, N), out_dtype=jnp.bfloat16,
                   interpret=True)
    out = int4_matmul(xt, torch.from_numpy(np.array(packed)),
                      torch.from_numpy(np.array(scale)))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(out, ref)


def _tf32(a):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: PTX cvt.rna.tf32.f32."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tc_int4(x, packed, scale, group, terms):
    """The tensor-core path's arithmetic (``csrc/int4_matmul.cu``
    int4_tc_kernel) in numpy: x's TF32 terms (x_lo first), each 8-deep
    step summed in f32 into the group accumulator, folded per group."""
    q = unpack_int4(torch.from_numpy(np.array(packed))).numpy()
    q = q.astype(np.float32)
    hi = _tf32(x)
    parts = [hi] if terms == 1 else [_tf32(x - hi), hi]
    scale = np.asarray(scale, np.float32)
    acc = np.zeros((x.shape[0], q.shape[1]), np.float32)
    for g0 in range(0, x.shape[1], group):
        accg = np.zeros_like(acc)
        for k in range(g0, g0 + group, 8):
            for a in parts:
                accg = accg + a[:, k:k + 8] @ q[k:k + 8]
        acc = (scale[g0 // group].astype(np.float64) * accg + acc
               ).astype(np.float32)
    return acc


@pytest.mark.parametrize("K", [2048, 5632])
def test_int4_bf16_x_needs_one_tf32_term(K):
    """A bf16 x (8 significant bits) is exact in TF32: x_lo is zero, so
    the bf16 instance's one TF32 product equals the f32 instance's two
    on the widened x, bit for bit, and both hold the bf16 tolerance
    against the Pallas kernel at bf16."""
    rng = np.random.default_rng(K + 1)
    M, N = 64, 128
    xt, xj = _bf(_normal(rng, M, K))
    x = _f32(xt)
    assert not _tf32(x - _tf32(x)).any()
    packed, scale = jax_quantize(jnp.asarray(_normal(rng, K, N, scale=0.05)))
    one = _tc_int4(x, packed, scale, 128, terms=1)
    np.testing.assert_array_equal(one, _tc_int4(x, packed, scale, 128, 2))
    ref = jax_int4(xj, packed, scale, block_m=64, block_n=128,
                   out_dtype=jnp.bfloat16, interpret=True)
    _close(_round_bf16(one), ref)


def _wgmma_int4(x, packed, scale, group):
    """The bf16 tensor-core path's arithmetic (``csrc/int4_matmul.cu``
    int4_tc_bf16_kernel) in numpy on bf16-valued x: the nibbles exact as
    bf16 q - 8, each 16-deep step's products (exact in f32: 8 by 4
    significant bits) summed in f32 into the group accumulator, the group
    folded into the output as fma(scale, acc_g, acc), groups in order."""
    q = unpack_int4(torch.from_numpy(np.array(packed))).numpy()
    q = q.astype(np.float32)
    scale = np.asarray(scale, np.float32)
    acc = np.zeros((x.shape[0], q.shape[1]), np.float32)
    for g0 in range(0, x.shape[1], group):
        accg = np.zeros_like(acc)
        for k in range(g0, g0 + group, 16):
            accg = accg + x[:, k:k + 16] @ q[k:k + 16]
        acc = (scale[g0 // group].astype(np.float64) * accg + acc
               ).astype(np.float32)
    return acc


def _bf16_ulps(a, b):
    """Element-wise distance in bf16 ulps between two bf16-valued f32
    arrays (the bf16 bit patterns as sign-magnitude integers)."""
    def key(v):
        bits = (np.asarray(v, np.float32).view(np.uint32) >> 16).astype(
            np.int64)
        return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)
    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("K,group", [(2048, 128), (5632, 128), (1024, 32)])
def test_int4_bf16_wgmma_arithmetic(K, group):
    """The bf16 instance's tensor-core path before any card: bf16 x times
    the exact bf16 nibbles in 16-deep steps with f32 sums and the group
    fold holds the f32 INT4 tolerance (rtol 1e-5, atol 1e-5 * max)
    against the Pallas kernel at bf16 x with an f32 output (interpret
    mode) and 2e-2 x max at its bf16 output; rounded to bf16, it lies
    within one bf16 ulp of the cast recipe it replaces (the TF32 path's
    one term on the widened x in 8-deep steps, cast back) on every
    element."""
    rng = np.random.default_rng(K + group)
    M, N = 64, 128
    xt, xj = _bf(_normal(rng, M, K))
    x = _f32(xt)
    packed, scale = jax_quantize(jnp.asarray(_normal(rng, K, N, scale=0.05)),
                                 group)
    model = _wgmma_int4(x, packed, scale, group)
    ref = np.asarray(jax_int4(xj, packed, scale, group=group, block_m=64,
                              block_n=128, out_dtype=jnp.float32,
                              interpret=True))
    np.testing.assert_allclose(model, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    _close(_round_bf16(model),
           jax_int4(xj, packed, scale, group=group, block_m=64, block_n=128,
                    out_dtype=jnp.bfloat16, interpret=True))
    recipe = _round_bf16(_tc_int4(x, packed, scale, group, terms=1))
    assert _bf16_ulps(_round_bf16(model), recipe).max() <= 1


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# (b, sq, sk, h, hkv, dh, causal, window, q_offset, block_q, block_k):
# tests/test_kernels.py:49's shape, GQA groups, a window, a prefill chunk
# at q_offset > 0, the bidirectional (encoder, cross) case
FLASH_CASES = [(1, 64, 64, 4, 2, 32, True, 0, 0, 32, 32),
               (2, 64, 64, 8, 2, 16, True, 0, 0, 16, 32),
               (2, 64, 64, 4, 1, 32, True, 0, 0, 32, 16),
               (2, 64, 64, 8, 2, 16, True, 13, 0, 32, 32),
               (1, 32, 64, 4, 2, 32, True, 0, 32, 32, 32),
               (2, 32, 64, 4, 4, 32, False, 0, 0, 32, 32),
               (1, 64, 64, 4, 2, 64, True, 0, 0, 64, 64)]


def _flash_inputs(case):
    b, sq, sk, h, hkv, dh = case[:6]
    rng = np.random.default_rng(sq + 7 * h + dh + case[7] + case[8])
    return (_bf(_normal(rng, b, sq, h, dh)), _bf(_normal(rng, b, sk, hkv, dh)),
            _bf(_normal(rng, b, sk, hkv, dh)))


def _pallas_flash(case, qj, kj, vj):
    causal, window, q_offset, bq, bk = case[6:]
    return jax_flash(qj, kj, vj, causal=causal, window=window,
                     q_offset=q_offset, block_q=bq, block_k=bk,
                     interpret=True)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bf16_plain_matches_pallas(case):
    """The plain version at bf16 q, k, v (what the CPU arm runs) against
    the Pallas kernel at bf16; bf16 out on both."""
    (qt, qj), (kt, kj), (vt, vj) = _flash_inputs(case)
    causal, window, q_offset = case[6:9]
    out = flash_attention(qt, kt, vt, causal=causal, window=window,
                          q_offset=q_offset)
    ref = _pallas_flash(case, qj, kj, vj)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(out, ref)


def _bf16_flash(q, k, v, causal, window, q_offset):
    """The bf16 instance's arithmetic (``csrc/flash_attention.cu``,
    flash_attention_bf16_kernel) in numpy on bf16-valued f32 arrays: 16
    query rows at a time, key tiles of 32 from the first the rows attend
    to the last, scores summed in f32 (bf16 products are exact in f32),
    scaled and masked, the online softmax in f32, the unnormalised P
    rounded to bf16 for P.V (f32 sums), l summed from the f32 P, out =
    o / max(l, 1e-30) rounded to bf16."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = np.float32(1.0 / np.sqrt(dh))
    out = np.zeros_like(q)
    for bi in range(b):
        for hd in range(h):
            kh = hd // g
            for r0 in range(0, sq, 16):
                rows = np.arange(r0, min(r0 + 16, sq))
                qp = q_offset + rows
                k_hi = min(sk - 1, qp[-1]) if causal else sk - 1
                k_lo = max(0, qp[0] - window + 1) if window else 0
                m = np.full(len(rows), -1e30, np.float32)
                l = np.zeros(len(rows), np.float32)
                o = np.zeros((len(rows), dh), np.float32)
                for t0 in range(k_lo // 32 * 32, k_hi + 1, 32):
                    kp = np.arange(t0, t0 + 32)
                    kk = np.zeros((32, dh), np.float32)
                    vv = np.zeros((32, dh), np.float32)
                    n = min(32, sk - t0)
                    kk[:n], vv[:n] = k[bi, t0:t0 + n, kh], v[bi, t0:t0 + n, kh]
                    s = (q[bi, rows, hd] @ kk.T).astype(np.float32) * scale
                    ok = (kp[None] < sk) & np.ones_like(s, bool)
                    if causal:
                        ok &= kp[None] <= qp[:, None]
                    if window:
                        ok &= qp[:, None] - kp[None] < window
                    s = np.where(ok, s, np.float32(-1e30))
                    m_new = np.maximum(m, s.max(1))
                    alpha = np.where(m > -5e29, np.exp(m - m_new), 0.0)
                    p = np.where(s > -5e29, np.exp(s - m_new[:, None]), 0.0)
                    p = p.astype(np.float32)
                    l = (l * alpha + p.sum(1)).astype(np.float32)
                    o = (o * alpha[:, None] + _round_bf16(p) @ vv
                         ).astype(np.float32)
                    m = m_new
                out[bi, rows, hd] = o / np.maximum(l, 1e-30)[:, None]
    return _round_bf16(out)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bf16_kernel_design_holds_tolerance(case):
    """The bf16 instance's arithmetic (numpy model) against the Pallas
    kernel at bf16 and against the plain version at bf16: 2e-2 x max."""
    (qt, qj), (kt, kj), (vt, vj) = _flash_inputs(case)
    causal, window, q_offset = case[6:9]
    model = _bf16_flash(_f32(qt), _f32(kt), _f32(vt), causal, window,
                        q_offset)
    _close(model, _pallas_flash(case, qj, kj, vj))
    _close(model, flash_attention(qt, kt, vt, causal=causal, window=window,
                                  q_offset=q_offset))


# ---------------------------------------------------------------------------
# decode_attention, decode_attention_int4
# ---------------------------------------------------------------------------

POS = [127, 0, 45, 96]


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4), (8, 1)])
def test_decode_bf16_q_over_bf16_caches_matches_pallas(h, hkv):
    """bf16 q over bf16 caches at ragged positions: each row against the
    Pallas kernel on that row at its scalar position; bf16 out on both.
    The plain version at bf16 q equals widening q, the f32 plain version
    and a cast back, bit for bit (its arithmetic is f32 after q)."""
    rng = np.random.default_rng(h + 3 * hkv)
    b, S, dh = len(POS), 128, 16
    qt, qj = _bf(_normal(rng, b, h, dh))
    kt, kj = _bf(_normal(rng, b, S, hkv, dh))
    vt, vj = _bf(_normal(rng, b, S, hkv, dh))
    pos = torch.tensor(POS, dtype=torch.int32)
    out = decode_attention(qt, kt, vt, pos)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, decode_attention(qt.float(), kt, vt, pos)
                       .to(torch.bfloat16))
    for r, p in enumerate(POS):
        sl = slice(r, r + 1)
        ref = decode_attention_kernel(qj[sl], kj[sl], vj[sl], p, block_s=32,
                                      interpret=True)
        assert ref.dtype == jnp.bfloat16
        _close(out[sl], ref)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 4)])
def test_decode_int4_bf16_q_matches_pallas(h, hkv, cache_dtype):
    """bf16 q over packed INT4 rows (the repaired instance's plain arm):
    each row against the Pallas INT4 kernel at bf16 q on that row at its
    position; bf16 out on both, and equal to the widened recipe bit for
    bit."""
    rng = np.random.default_rng(5 * h + hkv)
    b, S, dh = len(POS), 128, 16
    F = hkv * dh
    g = kv_group(F)
    qt, qj = _bf(_normal(rng, b, h, dh))
    (kq, ks), (vq, vs) = (quantize_kv_rows(_normal(rng, b, S, F), g)
                          for _ in range(2))
    kq, ks, vq, vs = (np.array(a) for a in (kq, ks, vq, vs))
    pos = torch.tensor(POS, dtype=torch.int32)
    kw = dict(hkv=hkv, group=g, cache_dtype=getattr(torch, cache_dtype))
    packed = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    out = decode_attention_int4(qt, *packed, pos, **kw)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, decode_attention_int4(qt.float(), *packed, pos,
                                                  **kw).to(torch.bfloat16))
    for r, p in enumerate(POS):
        sl = slice(r, r + 1)
        ref = decode_attention_int4_kernel(
            qj[sl], *(jnp.asarray(a[sl]) for a in (kq, ks, vq, vs)), p,
            hkv=hkv, group=g, block_s=32, interpret=True)
        assert ref.dtype == jnp.bfloat16
        _close(out[sl], ref)


def test_decode_int4_op_takes_bf16_q():
    """The repaired fault: with kernels on, ``decode_attention_int4_op``
    on meta tensors takes a bf16 q (it raised "needs f32 q" before the
    bf16 instance) and returns a bf16 (b, h, dh); on the CPU both arms
    take it and agree bit for bit, fresh rows (bf16) included."""
    b, h, hkv, dh, S = 2, 8, 2, 32, 40
    F, g = hkv * dh, 32
    meta = dict(device="meta")
    q = torch.empty(b, h, dh, dtype=torch.bfloat16, **meta)
    kp = torch.empty(b, S, F // 2, dtype=torch.uint8, **meta)
    sc = torch.empty(b, S, F // g, dtype=torch.float32, **meta)
    kn = torch.empty(b, hkv, dh, dtype=torch.bfloat16, **meta)
    assert ops.kernels_enabled()
    out = ops.decode_attention_int4_op(q, kp, sc, kp, sc, 9, hkv=hkv, group=g,
                                       k_new=kn, v_new=kn,
                                       cache_dtype=torch.bfloat16)
    assert out.shape == (b, h, dh) and out.dtype == torch.bfloat16
    rng = np.random.default_rng(21)
    qt = _bf(_normal(rng, b, h, dh))[0]
    (kq, ks), (vq, vs) = (quantize_kv_rows(_normal(rng, b, S, F), g)
                          for _ in range(2))
    packed = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    kn, vn = (_bf(_normal(rng, b, hkv, dh))[0] for _ in range(2))
    pos = torch.tensor([17, 39], dtype=torch.int32)
    kw = dict(hkv=hkv, group=g, k_new=kn, v_new=vn,
              cache_dtype=torch.bfloat16)
    got = ops.decode_attention_int4_op(qt, *packed, pos, **kw)
    ops.use_kernels(False)
    try:
        plain = ops.decode_attention_int4_op(qt, *packed, pos, **kw)
    finally:
        ops.use_kernels(True)
    assert got.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(got, plain)


# ---------------------------------------------------------------------------
# the ops at bf16: meta tensors, and the CPU's two arms
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    """Records the name of every aten op dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _op_case(name):
    """(run(*args), args, output shape, the kernel's cost at 2-byte
    activations) of one op on meta tensors at bf16."""
    b, h, hkv, dh, S, pos = 2, 8, 2, 32, 100, 9
    if name == "int4_matmul":
        M, K, N, G = 4, 256, 128, 128
        args = (_meta(M, K), _meta(K, N // 2, dtype=torch.uint8),
                _meta(K // G, N, dtype=torch.float32))
        return (lambda *a: ops.int4_matmul_op(*a, group=G), args, (M, N),
                cost.int4_matmul(M, K, N, G, 2))
    if name == "flash_attention":
        args = (_meta(b, 64, h, dh), _meta(b, 64, hkv, dh),
                _meta(b, 64, hkv, dh))
        return (lambda *a: ops.flash_attention_op(*a), args, (b, 64, h, dh),
                cost.flash_attention(b, 64, 64, h, hkv, dh, itemsize=2))
    if name == "decode_attention":
        args = (_meta(b, h, dh), _meta(b, S, hkv, dh), _meta(b, S, hkv, dh))
        return (lambda *a: ops.decode_attention_op(*a, pos), args, (b, h, dh),
                cost.decode_attention(b, h, hkv, dh, b * (pos + 1), 2, 2))
    F, g = hkv * dh, 32
    args = (_meta(b, h, dh), _meta(b, S, F // 2, dtype=torch.uint8),
            _meta(b, S, F // g, dtype=torch.float32),
            _meta(b, S, F // 2, dtype=torch.uint8),
            _meta(b, S, F // g, dtype=torch.float32), _meta(b, hkv, dh),
            _meta(b, hkv, dh))
    return (lambda q, kq, ks, vq, vs, kn, vn: ops.decode_attention_int4_op(
        q, kq, ks, vq, vs, pos, hkv=hkv, group=g, k_new=kn, v_new=vn,
        cache_dtype=torch.bfloat16), args, (b, h, dh),
        cost.decode_attention_int4(b, h, hkv, dh, b * pos, g, True, 2, 2))


OPS = ["int4_matmul", "flash_attention", "decode_attention",
       "decode_attention_int4"]


@pytest.mark.parametrize("name", OPS)
def test_op_on_meta_at_bf16_prices_two_byte_operands(name):
    """Each op at bf16 on meta tensors, kernels on: the kernel's output
    shape in bf16, priced by ``kernels.cost`` at 2-byte activations (the
    roofline counter's whole byte count: no other op moves a byte), and
    no cast or copy among the ops it dispatches."""
    run, args, shape, want = _op_case(name)
    rec = _Ops()
    with rec:
        out = run(*args)
    assert out.shape == shape and out.dtype == torch.bfloat16
    assert not {"to", "_to_copy", "copy_", "_to_dtype"} & set(rec.names), \
        rec.names
    acc = analyze_step(run, *args)
    assert acc["kernels"][name] == {"flops": want.flops,
                                    "bytes": want.nbytes, "count": 1}
    assert acc["hbm_bytes"] == want.nbytes


@pytest.mark.parametrize("name", OPS)
def test_cost_prices_bf16_at_half_the_activation_bytes(name):
    """``kernels.cost`` at 2-byte activations: the f32 bytes less two
    bytes an element of q or x, the output and (decode INT4) the fresh
    rows; the operations are the same."""
    b, h, hkv, dh, live = 4, 32, 4, 64, 400
    if name == "int4_matmul":
        M, K, N, G = 20, 2048, 5632, 128
        f32, bf = cost.int4_matmul(M, K, N, G), cost.int4_matmul(M, K, N, G,
                                                                  2)
        saved = 2 * (M * K + M * N)
        for m in (4, M):
            assert cost.int4_matmul_bound(m, K, N, G, 2)[2] == \
                "bf16, 989 TFLOP/s"
    elif name == "flash_attention":
        f32 = cost.flash_attention(b, 128, 128, h, hkv, dh)
        bf = cost.flash_attention(b, 128, 128, h, hkv, dh, itemsize=2)
        saved = 2 * (2 * b * 128 * h * dh + 2 * b * 128 * hkv * dh)
        assert cost.flash_attention_bound(b, 128, 128, h, hkv, dh,
                                          itemsize=2)[2] == "bf16, 989 TFLOP/s"
    elif name == "decode_attention":
        f32 = cost.decode_attention(b, h, hkv, dh, live, 2)
        bf = cost.decode_attention(b, h, hkv, dh, live, 2, 2)
        saved = 2 * 2 * b * h * dh
    else:
        f32 = cost.decode_attention_int4(b, h, hkv, dh, live, 32, True)
        bf = cost.decode_attention_int4(b, h, hkv, dh, live, 32, True, 2, 2)
        saved = 2 * 2 * b * h * dh + 2 * 2 * b * hkv * dh
    assert bf.flops == f32.flops
    assert f32.nbytes - bf.nbytes == saved


def _cpu_case(name, rng):
    """(run(), inputs) of one op at bf16 on CPU tensors."""
    b, h, hkv, dh, S = 2, 8, 2, 32, 48
    bf = lambda *s: _bf(_normal(rng, *s))[0]
    if name == "int4_matmul":
        packed, scale = jax_quantize(jnp.asarray(_normal(rng, 256, 64)))
        x, p, s = bf(5, 256), *(torch.from_numpy(np.array(a))
                                for a in (packed, scale))
        return lambda: ops.int4_matmul_op(x, p, s, group=128)
    if name == "flash_attention":
        q, k, v = bf(b, 40, h, dh), bf(b, 40, hkv, dh), bf(b, 40, hkv, dh)
        return lambda: ops.flash_attention_op(q, k, v, causal=True, window=9)
    pos = torch.tensor([47, 11], dtype=torch.int32)
    if name == "decode_attention":
        q, kc, vc = bf(b, h, dh), bf(b, S, hkv, dh), bf(b, S, hkv, dh)
        return lambda: ops.decode_attention_op(q, kc, vc, pos)
    F = hkv * dh
    g = kv_group(F)
    q = bf(b, h, dh)
    rows = [torch.from_numpy(np.array(a)) for _ in range(2)
            for a in quantize_kv_rows(_normal(rng, b, S, F), g)]
    return lambda: ops.decode_attention_int4_op(q, *rows, pos, hkv=hkv,
                                                group=g)


@pytest.mark.parametrize("name", OPS)
def test_kernel_arm_equals_plain_arm_on_cpu_at_bf16(name):
    """On CPU tensors at bf16 the kernel arm runs the plain version at the
    input dtype: equal to ``use_kernels(False)`` bit for bit, bf16 out,
    no launch counted."""
    run = _cpu_case(name, np.random.default_rng(OPS.index(name)))
    ops.reset_launches()
    got = run()
    ops.use_kernels(False)
    try:
        plain = run()
    finally:
        ops.use_kernels(True)
    assert got.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(got, plain)
    assert sum(ops.LAUNCHES.values()) == 0
