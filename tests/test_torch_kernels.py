"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode) and jnp oracles, on the same numpy inputs.

Shape sweeps and tolerances follow tests/test_kernels.py: atol 2e-5 for
both fp32 attentions, rtol 1e-5 with atol 1e-5 * max|ref| for the fp32
INT4 matmul (the two sides sum in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_kernel  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.int4_matmul import int4_matmul as jax_int4  # noqa: E402
from repro.kernels.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.quant.int4 import quantize_int4 as jax_quantize  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.int4_matmul import int4_matmul, split_plan  # noqa: E402


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


def test_int4_split_plan_covers_k():
    """The small-M path's K split: whole groups, every group covered,
    about two blocks per SM on a 132-SM card at the decode shapes."""
    for K, N in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)):
        splits, gps = split_plan(4, K, N, 128, 132)
        assert (splits - 1) * gps < K // 128 <= splits * gps
        assert splits * -(-N // 256) >= 100 or splits == K // 128


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
