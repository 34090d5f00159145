"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip without a card (each test decides
inside itself) and run on the machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _t(rng, dev, *shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("M,K,N,group", [(1, 2048, 2048, 128),
                                         (4, 5632, 2048, 128),
                                         (3, 96, 10, 32), (512, 384, 200, 32)])
def test_int4_matmul_kernel(dev, M, K, N, group):
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(M + N)
    x = _t(rng, dev, M, K)
    packed, scale = quantize_int4(_t(rng, dev, K, N, scale=0.05), group)
    out = int4_matmul(x, packed, scale, group=group)
    ref = plain(x, packed, scale, group)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("N", [256, 5632])
@pytest.mark.parametrize("M", [4, 16, 17, 37, 160, 512])
def test_int4_matmul_kernel_paths(dev, M, N):
    """Both paths (M <= 16: one-launch split-K matrix-vector; M > 16:
    tensor cores over exact integer weights, two TF32 terms) at K = 5632
    against the plain version, rtol 1e-5 and atol 1e-5 * max|ref|; the
    cluster's fixed-order sum makes two calls equal bit for bit."""
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(M * N)
    K = 5632
    x = _t(rng, dev, M, K)
    packed, scale = quantize_int4(_t(rng, dev, K, N, scale=0.05), 128)
    out = int4_matmul(x, packed, scale)
    ref = plain(x, packed, scale, 128)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    assert torch.equal(out, int4_matmul(x, packed, scale))


@pytest.mark.parametrize("sq,sk,q_offset,window", [(128, 128, 0, 0),
                                                   (45, 65, 20, 13),
                                                   (77, 77, 0, 0)])
def test_flash_attention_kernel(dev, sq, sk, q_offset, window):
    from repro_torch.kernels.flash_attention import flash_attention, plain
    rng = np.random.default_rng(sq)
    q, k, v = (_t(rng, dev, 2, sq, 8, 64), _t(rng, dev, 2, sk, 2, 64),
               _t(rng, dev, 2, sk, 2, 64))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    torch.testing.assert_close(flash_attention(q, k, v, **kw),
                               plain(q, k, v, **kw), rtol=0, atol=2e-5)


@pytest.mark.parametrize("S,pos", [(160, [158, 158, 158, 158]),
                                   (100, [0, 50, 99, 77])])
def test_decode_attention_kernel(dev, S, pos):
    from repro_torch.kernels.decode_attention import decode_attention, plain
    rng = np.random.default_rng(S)
    q, kc, vc = (_t(rng, dev, 4, 32, 64), _t(rng, dev, 4, S, 4, 64),
                 _t(rng, dev, 4, S, 4, 64))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    torch.testing.assert_close(decode_attention(q, kc, vc, p),
                               plain(q, kc, vc, p), rtol=0, atol=2e-5)


@pytest.mark.parametrize("S,pos", [(160, [159, 0, 77, 131]),
                                   (100, [0, 50, 99, 77])])
def test_decode_attention_kernel_bf16_caches(dev, S, pos):
    """bf16 caches (the serving cache): f32 arithmetic in the kernel, the
    plain version rounds probabilities to bf16 (atol 2e-2)."""
    from repro_torch.kernels.decode_attention import decode_attention, plain
    rng = np.random.default_rng(S + 1)
    q = _t(rng, dev, 4, 32, 64)
    kc, vc = (_t(rng, dev, 4, S, 4, 64).bfloat16() for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    torch.testing.assert_close(decode_attention(q, kc, vc, p),
                               plain(q, kc, vc, p), rtol=0, atol=2e-2)


# (b, S, h, hkv, dh, pos): main-path, S not a multiple of 32, g = 16
# (F = 48), and g = 32 spanning two heads (dh = 16, F = 64)
INT4_CASES = [(4, 160, 32, 4, 64, [159, 0, 77, 131]),
              (4, 100, 32, 4, 64, [0, 50, 99, 77]),
              (3, 77, 6, 3, 16, [76, 0, 40]),
              (2, 64, 8, 4, 16, [63, 5])]


@pytest.mark.parametrize("b,S,h,hkv,dh,pos", INT4_CASES)
@pytest.mark.parametrize("fresh,cdt", [(False, torch.float32),
                                       (True, torch.float32),
                                       (True, torch.bfloat16)])
def test_decode_attention_int4_kernel(dev, b, S, h, hkv, dh, pos, fresh,
                                      cdt):
    """Against the plain version (atol 2e-5 at f32, 2e-2 with bf16
    rounding) and, without a fresh row at f32, against decode_attention
    over the dequantized cache (atol 1e-6)."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4, plain)
    rng = np.random.default_rng(S + h)
    F = hkv * dh
    g = kv_group(F)
    q = _t(rng, dev, b, h, dh)
    kq, ks = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    vq, vs = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    kn, vn = ((_t(rng, dev, b, hkv, dh), _t(rng, dev, b, hkv, dh)) if fresh
              else (None, None))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(hkv=hkv, group=g, k_new=kn, v_new=vn, cache_dtype=cdt)
    out = decode_attention_int4(q, kq, ks, vq, vs, p, **kw)
    tol = 2e-5 if cdt == torch.float32 else 2e-2
    torch.testing.assert_close(out, plain(q, kq, ks, vq, vs, p, **kw),
                               rtol=0, atol=tol)
    if not fresh:
        kd = PackedRows(kq, ks, g, torch.float32, (hkv, dh)).dequantize()
        vd = PackedRows(vq, vs, g, torch.float32, (hkv, dh)).dequantize()
        torch.testing.assert_close(out, decode_attention(q, kd, vd, p),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,pos", [(256, [3, 40, 0, 255]), (160, [0, 0, 0, 0]),
                                   (33, [32, 0, 31, 1]), (33, [0, 0, 0, 0]),
                                   (160, [159, 31, 32, 64])])
@pytest.mark.parametrize("fresh", [False, True])
def test_decode_attention_int4_chunks(dev, S, pos, fresh):
    """The S split: chunks past pos[r] (early exit), pos = 0 on every
    row, a pos inside the first chunk, S not a multiple of 32; q and the
    fresh rows as strided views.  Against the plain version (atol 2e-5)
    and, without a fresh row, decode_attention over the dequantized cache
    (atol 1e-6); an int pos equals the same pos as a tensor."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4, plain)
    rng = np.random.default_rng(S + sum(pos))
    b, h, hkv, dh = 4, 32, 4, 64
    F = hkv * dh
    g = kv_group(F)
    q = _t(rng, dev, b, h + 3, dh)[:, :h]
    kq, ks = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    vq, vs = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    kn = vn = None
    if fresh:
        kn = _t(rng, dev, b, 1, 3 * hkv, dh)[:, 0, :hkv]
        vn = _t(rng, dev, b, 1, 3 * hkv, dh)[:, 0, hkv:2 * hkv]
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(hkv=hkv, group=g, k_new=kn, v_new=vn)
    out = decode_attention_int4(q, kq, ks, vq, vs, p, **kw)
    torch.testing.assert_close(out, plain(q, kq, ks, vq, vs, p, **kw),
                               rtol=0, atol=2e-5)
    if not fresh:
        kd = PackedRows(kq, ks, g, torch.float32, (hkv, dh)).dequantize()
        vd = PackedRows(vq, vs, g, torch.float32, (hkv, dh)).dequantize()
        torch.testing.assert_close(out, decode_attention(q.contiguous(), kd,
                                                         vd, p),
                                   rtol=0, atol=1e-6)
    if len(set(pos)) == 1:
        assert torch.equal(out, decode_attention_int4(q, kq, ks, vq, vs,
                                                      pos[0], **kw))


# (b, sq, sk, h, hkv, dh, causal, window, q_offset): dh 16/32/64/128;
# g = 1, 4, 8; sq and sk multiples of neither 16 nor 32; window and
# q_offset (chunked prefill), alone and together; no causal mask
FLASH_EDGES = [(2, 45, 45, 8, 8, 16, True, 0, 0),
               (2, 33, 61, 8, 2, 32, True, 0, 28),
               (1, 37, 37, 32, 4, 64, True, 0, 0),
               (2, 70, 70, 4, 1, 128, True, 0, 0),
               (1, 50, 83, 16, 2, 64, True, 19, 33),
               (3, 17, 17, 8, 1, 128, True, 5, 0),
               (2, 29, 51, 8, 2, 32, False, 0, 0),
               (1, 141, 141, 32, 4, 64, True, 0, 0)]


@pytest.mark.parametrize("b,sq,sk,h,hkv,dh,causal,window,q_offset",
                         FLASH_EDGES)
def test_flash_attention_kernel_edges(dev, b, sq, sk, h, hkv, dh, causal,
                                      window, q_offset):
    """Against the plain version (atol 2e-5), and two calls bit-equal (no
    atomics: each output row is summed by one warp in a fixed order)."""
    from repro_torch.kernels.flash_attention import flash_attention, plain
    rng = np.random.default_rng(sq * 7 + dh)
    q, k, v = (_t(rng, dev, b, sq, h, dh), _t(rng, dev, b, sk, hkv, dh),
               _t(rng, dev, b, sk, hkv, dh))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_attention(q, k, v, **kw)
    torch.testing.assert_close(out, plain(q, k, v, **kw), rtol=0, atol=2e-5)
    assert torch.equal(out, flash_attention(q, k, v, **kw))


# (b, S, h, hkv, dh, pos): dh 16/32/64/128; g = 1, 4, 8; S not a multiple
# of 32; pos 0 on every row; ranks with no chunk to read (a short row in a
# long cache); one chunk per rank and several
DECODE_EDGES = [(2, 45, 8, 8, 16, [44, 0]),
                (3, 77, 16, 4, 32, [76, 0, 40]),
                (4, 160, 32, 4, 64, [0, 0, 0, 0]),
                (2, 300, 16, 2, 128, [299, 3]),
                (4, 1024, 32, 4, 64, [1023, 700, 0, 64]),
                (2, 33, 8, 1, 64, [32, 31])]


@pytest.mark.parametrize("b,S,h,hkv,dh,pos", DECODE_EDGES)
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_edges(dev, b, S, h, hkv, dh, pos, cdt):
    """q as a strided view, against the plain version (atol 2e-5 at f32,
    2e-2 over bf16 caches); two calls bit-equal (the cluster's partials
    combine in rank order); an int pos equals the same pos as a tensor."""
    from repro_torch.kernels.decode_attention import decode_attention, plain
    rng = np.random.default_rng(S + dh)
    q = _t(rng, dev, b, 1, h + 3, dh)[:, 0, 2:h + 2]
    kc, vc = (_t(rng, dev, b, S, hkv, dh).to(cdt) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, p)
    tol = 2e-5 if cdt == torch.float32 else 2e-2
    torch.testing.assert_close(out, plain(q, kc, vc, p), rtol=0, atol=tol)
    assert torch.equal(out, decode_attention(q, kc, vc, p))
    one = decode_attention(q, kc, vc, pos[-1])
    assert torch.equal(one, decode_attention(
        q, kc, vc, torch.full((b,), pos[-1], dtype=torch.int32, device=dev)))


@pytest.mark.parametrize("S,pos", [(160, [159, 0, 77, 131]),
                                   (1024, [1023, 700, 0, 64]),
                                   (33, [32, 0, 31, 1])])
def test_decode_int4_bit_equal_to_decode_attention(dev, S, pos):
    """The two decode kernels share one chunk plan, chunk step and
    combine: over packed rows without a fresh row at f32, the INT4 kernel
    equals ``decode_attention`` over the dequantized cache bit for bit."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import decode_attention_int4
    rng = np.random.default_rng(S)
    b, h, hkv, dh = 4, 32, 4, 64
    g = kv_group(hkv * dh)
    q = _t(rng, dev, b, h, dh)
    kq, ks = quantize_kv_rows(_t(rng, dev, b, S, hkv * dh), g)
    vq, vs = quantize_kv_rows(_t(rng, dev, b, S, hkv * dh), g)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kd = PackedRows(kq, ks, g, torch.float32, (hkv, dh)).dequantize()
    vd = PackedRows(vq, vs, g, torch.float32, (hkv, dh)).dequantize()
    assert torch.equal(decode_attention_int4(q, kq, ks, vq, vs, p, hkv=hkv,
                                             group=g),
                       decode_attention(q, kd, vd, p))


def test_kernel_rejects_cpu_mix(dev):
    from repro_torch.kernels.int4_matmul import int4_matmul
    x = torch.zeros(4, 128, device=dev)
    with pytest.raises(ValueError):
        int4_matmul(x, torch.zeros(128, 32, dtype=torch.uint8),
                    torch.ones(1, 64))


def test_compute_task_ends_when_the_card_finishes(dev):
    """A compute task's trace interval ends at the event recorded behind
    its work, not when its launches returned; a KV save carrying that
    event as ``after`` copies the finished tensor."""
    from repro_torch.core.pipeline import ThreadPool
    from repro_torch.core.tasks import Task, TaskType
    pool = ThreadPool(1, device=dev)
    buf = torch.zeros(1 << 20, device=dev)

    def work():
        torch.cuda._sleep(100_000_000)        # well over 10 ms on an H100
        buf.fill_(3.0)

    ct = pool.run_on_main(Task(TaskType.COMPUTE, "c[0,0]", work))
    launched = ct.t_end - ct.t_start
    save = Task(TaskType.KV_SAVE, "sv[0,0]", lambda: buf.to("cpu"))
    save.after = ct.after
    pool.submit(save, priority=1)
    assert bool((save.wait() == 3.0).all())
    pool.shutdown()
    (ev,) = [e for e in pool.trace.events() if e.kind == "compute"]
    assert ev.t_end - ev.t_start >= 0.01 > launched


# ---------------------------------------------------------------------------
# Llama-3 shapes: head_dim 128, a GQA group of 4, d_ff 14336, the 128256
# vocabulary (Llama-3.1-8B; llama3.2-1b: d 2048, d_ff 8192, kv 512)
# ---------------------------------------------------------------------------

_PACKED = {}


def _packed(dev, K, N):
    """One quantized (K, N) weight per shape for the module (drawn on the
    card: the head is 525M values)."""
    if (K, N) not in _PACKED:
        from repro_torch.quant.int4 import quantize_int4
        gen = torch.Generator(device=dev)
        gen.manual_seed(K * 7 + N)
        w = torch.randn((K, N), generator=gen, device=dev) * 0.05
        _PACKED[(K, N)] = quantize_int4(w, 128)
    return _PACKED[(K, N)]


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (2048, 512), (2048, 8192),
                                 (8192, 2048), (4096, 128256)])
@pytest.mark.parametrize("M", [4, 16, 17, 128])
def test_int4_matmul_llama3_shapes(dev, M, K, N):
    """Both paths at every Llama-3 projection and the packed head,
    against the plain version (rtol 1e-5, atol 1e-5 * max|ref|), two
    calls equal bit for bit."""
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    packed, scale = _packed(dev, K, N)
    x = _t(np.random.default_rng(M + K), dev, M, K)
    out = int4_matmul(x, packed, scale)
    ref = plain(x, packed, scale, 128)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    assert torch.equal(out, int4_matmul(x, packed, scale))


@pytest.mark.parametrize("b,sq,dh", [(1, 128, 128), (1, 37, 128),
                                     (4, 128, 128), (1, 15, 64),
                                     (2, 77, 128)])
def test_flash_attention_llama3(dev, b, sq, dh):
    """h 32, hkv 8 (group 4) at dh 128 and 64, causal, against the plain
    version (atol 2e-5)."""
    from repro_torch.kernels.flash_attention import flash_attention, plain
    rng = np.random.default_rng(b * sq + dh)
    q, k, v = (_t(rng, dev, b, sq, 32, dh), _t(rng, dev, b, sq, 8, dh),
               _t(rng, dev, b, sq, 8, dh))
    torch.testing.assert_close(flash_attention(q, k, v), plain(q, k, v),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("S,pos", [(160, [159, 0, 77, 131]),
                                   (256, [255, 3, 128, 31]),
                                   (32, [22, 15, 9, 20])])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_decode_attention_llama3(dev, S, pos, cdt):
    """b 4, h 32, hkv 8 (group 4), dh 128, ragged pos: atol 2e-5 at f32,
    2e-2 over bf16 caches (the plain version rounds probabilities)."""
    from repro_torch.kernels.decode_attention import decode_attention, plain
    rng = np.random.default_rng(S + sum(pos))
    q = _t(rng, dev, 4, 32, 128)
    kc, vc = (_t(rng, dev, 4, S, 8, 128).to(cdt) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, p)
    torch.testing.assert_close(out, plain(q, kc, vc, p), rtol=0,
                               atol=2e-5 if cdt == torch.float32 else 2e-2)
    assert torch.equal(out, decode_attention(q, kc, vc, p))


@pytest.mark.parametrize("dh,S,pos", [(64, 32, [22, 15, 9, 20]),
                                      (128, 160, [159, 0, 77, 131])])
@pytest.mark.parametrize("fresh,cdt", [(False, torch.float32),
                                       (True, torch.bfloat16)])
def test_decode_attention_int4_llama3(dev, dh, S, pos, fresh, cdt):
    """Packed INT4 KV rows at hkv 8 (F = 512 for llama3.2-1b, 1024 at
    dh 128), group 4: against the plain version (atol 2e-5 at f32, 2e-2
    with bf16 rounding) and, without a fresh row, bit-equal to
    decode_attention over the dequantized cache."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4, plain)
    rng = np.random.default_rng(dh + S)
    b, h, hkv = 4, 32, 8
    F = hkv * dh
    g = kv_group(F)
    q = _t(rng, dev, b, h, dh)
    kq, ks = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    vq, vs = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    kn, vn = ((_t(rng, dev, b, hkv, dh), _t(rng, dev, b, hkv, dh)) if fresh
              else (None, None))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(hkv=hkv, group=g, k_new=kn, v_new=vn, cache_dtype=cdt)
    out = decode_attention_int4(q, kq, ks, vq, vs, p, **kw)
    torch.testing.assert_close(out, plain(q, kq, ks, vq, vs, p, **kw),
                               rtol=0,
                               atol=2e-5 if cdt == torch.float32 else 2e-2)
    if not fresh:
        kd = PackedRows(kq, ks, g, torch.float32, (hkv, dh)).dequantize()
        vd = PackedRows(vq, vs, g, torch.float32, (hkv, dh)).dequantize()
        assert torch.equal(out, decode_attention(q, kd, vd, p))


@pytest.mark.parametrize("sq,sk,q_offset", [(32, 64, 32), (32, 96, 64),
                                            (18, 114, 96)])
def test_flash_attention_chunk_shapes(dev, sq, sk, q_offset):
    """Llama-3.1-8B prefill chunks (b 1, h 32, hkv 8, dh 128): a chunk of
    ``sq`` rows at ``q_offset`` over the ``sk = q_offset + sq`` prefix,
    against the plain version (atol 2e-5) and through the model path's
    ``chunk_prefill_attention``, counted as a q_offset launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, plain
    from repro_torch.models.attention import chunk_prefill_attention
    rng = np.random.default_rng(sq + sk)
    q, k, v = (_t(rng, dev, 1, sq, 32, 128), _t(rng, dev, 1, sk, 8, 128),
               _t(rng, dev, 1, sk, 8, 128))
    ref = plain(q, k, v, causal=True, q_offset=q_offset)
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    ops.reset_launches()
    assert torch.equal(chunk_prefill_attention(q, k, v, q_offset=q_offset),
                       out)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_q_offset"] == 1


@pytest.mark.parametrize("sched,chunk", [("online", 3), ("offline", None)])
def test_online_engine_matches_monolithic(dev, sched, chunk):
    """The scaled tinyllama served with chunked prefill (``"online"`` at
    chunks of 3, ``"offline"`` at whole prompts) on the card gives the
    monolithic engine's tokens on the same weights; online chunks after
    a prompt's first run flash_attention with q_offset > 0."""
    from repro_torch.kernels import ops
    from repro_torch.serving.base import Request
    from repro_torch.serving.spec import EngineSpec, create_engine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (6 + 3 * i,)).astype(np.int32)
               for i in range(4)]
    outs, counts = {}, {}
    for s, c in (("monolithic", None), (sched, chunk)):
        eng = create_engine(EngineSpec(
            arch="tinyllama-1.1b", scaled=True, offload=True, b_max=2,
            max_len=64, sched=s, prefill_chunk=c).resolve())
        ops.reset_launches()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new=6))
        outs[s] = {r.rid: list(r.out) for r in eng.run()}
        torch.cuda.synchronize()
        counts[s] = dict(ops.LAUNCHES)
        assert (eng.stats["prefill_chunks"] > 0) == (s != "monolithic")
        eng.shutdown()
    assert outs[sched] == outs["monolithic"]
    assert (counts[sched]["flash_attention_q_offset"] > 0) == (
        sched == "online")
    assert counts["monolithic"]["flash_attention_q_offset"] == 0
