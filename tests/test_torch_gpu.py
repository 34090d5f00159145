"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip without a card (each test decides
inside itself) and run on the machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpu.py
"""
import dataclasses

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
    """The row split: tiles past pos[r] never read, pos = 0 on every
    row, a pos inside the first tile, S not a multiple of 32; q and the
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
# of 32; pos 0 on every row; ranks with no tile to read (a short row in a
# long cache); one tile per rank and several
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
    """The two decode kernels share one plan (``rank_runs``), step and
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


# (b, S, h, hkv, dh, pos, cache dtype or "int4", fresh row): the main
# rows' shapes (tinyllama, the 8B, Gemma 3's global slab, whisper's cross
# rows) and the edges (dh 16 and 32, g 1 and 16, a row inside its first
# tile, rows of 1 and 2 tiles beside one of many)
ROW_CASES = [(4, 160, 32, 4, 64, [159, 0, 77, 131], torch.float32, False),
             (4, 160, 32, 8, 128, [159, 0, 77, 131], torch.bfloat16, False),
             (4, 1536, 8, 4, 256, [1515, 1031, 315, 129], torch.bfloat16,
              False),
             (4, 1500, 8, 8, 64, [1499, 40, 33, 1000], torch.bfloat16, False),
             (3, 77, 16, 4, 32, [76, 0, 40], torch.float32, False),
             (2, 45, 32, 2, 16, [44, 31], torch.bfloat16, False),
             (4, 160, 32, 4, 64, [159, 0, 77, 131], "int4", True),
             (4, 300, 8, 4, 256, [299, 3, 150, 64], "int4", False)]


@pytest.mark.parametrize("b,S,h,hkv,dh,pos,cdt,fresh", ROW_CASES)
def test_decode_rows_independent(dev, b, S, h, hkv, dh, pos, cdt, fresh):
    """A row's output depends on nothing outside that row: bit-equal
    alone (a batch of one), in the batch and over a slab 37 rows longer
    (rows of other values past every position)."""
    from repro_torch.core.kvstore import kv_group, quantize_kv_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import decode_attention_int4
    rng = np.random.default_rng(S + dh)
    q = _t(rng, dev, b, h, dh)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    if cdt == "int4":
        F = hkv * dh
        g = kv_group(F)
        kq, ks = quantize_kv_rows(_t(rng, dev, b, S + 37, F), g)
        vq, vs = quantize_kv_rows(_t(rng, dev, b, S + 37, F), g)
        kn, vn = ((_t(rng, dev, b, hkv, dh), _t(rng, dev, b, hkv, dh))
                  if fresh else (None, None))

        def call(sl, n):
            return decode_attention_int4(
                q[sl], *(t[sl, :n].contiguous() for t in (kq, ks, vq, vs)),
                p[sl], hkv=hkv, group=g,
                k_new=None if kn is None else kn[sl],
                v_new=None if vn is None else vn[sl])
    else:
        kc, vc = (_t(rng, dev, b, S + 37, hkv, dh).to(cdt) for _ in range(2))

        def call(sl, n):
            return decode_attention(q[sl], kc[sl, :n].contiguous(),
                                    vc[sl, :n].contiguous(), p[sl])
    out = call(slice(None), S)
    assert torch.equal(out, call(slice(None), S + 37))
    for r in range(b):
        assert torch.equal(out[r:r + 1], call(slice(r, r + 1), S))


@pytest.mark.parametrize("int4", [False, True])
def test_decode_other_cluster_size(dev, int4):
    """The other cluster size ``tools/decode_phases.py`` times (8 beside
    the plan's 16) stays within atol 2e-5 of the plain version at f32,
    as the plan's does; a call under the plan equals the wrapper's."""
    from repro_torch.core.kvstore import kv_group, quantize_kv_rows
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import decode_attention_int4 as D4
    rng = np.random.default_rng(5)
    b, S, h, hkv, dh = 4, 1500, 8, 4, 256
    q = _t(rng, dev, b, h, dh)
    p = torch.tensor([1499, 700, 0, 300], dtype=torch.int32, device=dev)
    if int4:
        g = kv_group(hkv * dh)
        kq, ks = quantize_kv_rows(_t(rng, dev, b, S, hkv * dh), g)
        vq, vs = quantize_kv_rows(_t(rng, dev, b, S, hkv * dh), g)
        args = (q, kq, ks, vq, vs, p)
        kw = dict(hkv=hkv, group=g)
        ref = D4.plain(*args, **kw)

        def run(cluster):
            out = torch.empty_like(q)
            D4._launch(*args, 0, out, **kw, cluster=cluster)
            return out

        wrapper = D4.decode_attention_int4(*args, **kw)
    else:
        kc, vc = _t(rng, dev, b, S, hkv, dh), _t(rng, dev, b, S, hkv, dh)
        ref = D.plain(q, kc, vc, p)

        def run(cluster):
            out = torch.empty_like(q)
            D._launch(q, kc, vc, p, 0, out, cluster)
            return out

        wrapper = D.decode_attention(q, kc, vc, p)
    base = run(D.CLUSTER)
    assert torch.equal(base, wrapper)
    torch.testing.assert_close(base, ref, rtol=0, atol=2e-5)
    other = 8 if D.CLUSTER == 16 else 16
    torch.testing.assert_close(run(other), ref, rtol=0, atol=2e-5)


def test_kernel_rejects_cpu_mix(dev):
    from repro_torch.kernels.int4_matmul import int4_matmul
    x = torch.zeros(4, 128, device=dev)
    with pytest.raises(ValueError):
        int4_matmul(x, torch.zeros(128, 32, dtype=torch.uint8),
                    torch.ones(1, 64))


def test_compute_task_ends_when_the_card_finishes(dev):
    """A compute task's trace interval ends at the event recorded behind
    its work, not when its launches returned; a KV save carrying that
    event as ``after`` copies the finished tensor.

    The card's sleep is sized from a first launch of the same work on
    this host (20 times its launch time, and at least 50 ms), so it
    outlasts the launch on a slow host too.  The interval is then held
    against the card's own finish: an event recorded behind the work,
    read on the pool's clock (its anchor event and host time)."""
    import time

    from repro_torch.core.pipeline import ThreadPool
    from repro_torch.core.tasks import Task, TaskType
    pool = ThreadPool(1, device=dev)
    buf = torch.zeros(1 << 20, device=dev)
    done = torch.cuda.Event(enable_timing=True)

    def work(cycles):
        torch.cuda._sleep(cycles)
        buf.fill_(3.0)
        done.record()

    # calibrate: the launch's host time and the sleep's card time
    cycles = 10_000_000
    begin = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    begin.record()
    t0 = time.perf_counter()
    work(cycles)
    launch_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    s_per_cycle = begin.elapsed_time(done) / 1e3 / cycles
    cycles = int(max(0.05, 20 * launch_s) / s_per_cycle)

    ct = pool.run_on_main(Task(TaskType.COMPUTE, "c[0,0]",
                               lambda: work(cycles)))
    launched = ct.t_end - ct.t_start
    save = Task(TaskType.KV_SAVE, "sv[0,0]", lambda: buf.to("cpu"))
    save.after = ct.after
    pool.submit(save, priority=1)
    assert bool((save.wait() == 3.0).all())
    pool.shutdown()
    (ev,) = [e for e in pool.trace.events() if e.kind == "compute"]
    anchor, t_ref = pool._ref             # the trace's times are from t0
    finished = t_ref + anchor.elapsed_time(done) / 1e3 - pool.trace.t0
    assert ev.t_end - ev.t_start >= finished - ev.t_start > launched


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


# the verify pass of run (m): Llama-3.1-8B, b 4, h 32, hkv 8, dh 128,
# k = 4 (five query positions from ragged first positions)
SPEC_POS = [114, 93, 81, 58]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_spec_decode_attention_on_card(dev, packed, cdt):
    """``spec_decode_attention`` (f32 and bf16 caches) and its packed twin
    through the kernels against the same functions on the plain versions
    (``use_kernels(False)``), same inputs: atol 2e-5 at f32, 2e-2 over
    bf16 (the plain version rounds probabilities to bf16); the rows each
    writes are equal; one decode launch per query position."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    rng = np.random.default_rng(7)
    b, S, s, h, hkv, dh = 4, 160, 5, 32, 8, 128
    F = hkv * dh
    q = _t(rng, dev, b, s, h, dh)
    kn, vn = _t(rng, dev, b, s, hkv, dh), _t(rng, dev, b, s, hkv, dh)
    pos = torch.tensor(SPEC_POS, dtype=torch.int32, device=dev)
    live = (torch.arange(S, device=dev)[None, :] < pos[:, None].long())

    def caches():
        if packed:
            out = []
            for _ in range(2):
                hist = _t(rng, dev, b, S, F) * live[..., None]
                p, sc = quantize_kv_rows(hist, kv_group(F))
                out.append(PackedRows(p, sc, kv_group(F), cdt, (hkv, dh)))
            return out
        return [(_t(rng, dev, b, S, hkv, dh)
                 * live[..., None, None]).to(cdt) for _ in range(2)]

    def run(kc, vc, kernels):
        ops.use_kernels(kernels)
        try:
            if packed:
                kc = PackedRows(kc.packed.clone(), kc.scale.clone(),
                                *kc[2:])
                vc = PackedRows(vc.packed.clone(), vc.scale.clone(),
                                *vc[2:])
                return A.spec_decode_attention_packed(q, kc, vc, kn, vn,
                                                      pos), kc
            out, kc, _ = A.spec_decode_attention(q, kc.clone(), vc.clone(),
                                                 kn, vn, pos)
            return out, kc
        finally:
            ops.use_kernels(True)

    kc, vc = caches()
    ops.reset_launches()
    out, wk = run(kc, vc, True)
    torch.cuda.synchronize()
    name = "decode_attention_int4" if packed else "decode_attention"
    assert ops.LAUNCHES[name] == s
    ref, rk = run(kc, vc, False)
    atol = 2e-5 if cdt == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)
    if packed:
        assert torch.equal(wk.packed, rk.packed)
        assert torch.equal(wk.scale, rk.scale)
    else:
        assert torch.equal(wk, rk)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_verify_rows_packed_on_card_equal_host_rows(dev, cdt):
    """The rows a verify pass packs on the card are, byte for byte, what
    the KV store's host save (``_quant_into``) writes for the same fresh
    rows."""
    from repro_torch.core.kvstore import (PackedRows, TieredKVStore,
                                          kv_group)
    from repro_torch.models import attention as A
    rng = np.random.default_rng(3)
    b, S, s, h, hkv, dh = 4, 160, 5, 32, 8, 128
    F = hkv * dh
    g = kv_group(F)
    q = _t(rng, dev, b, s, h, dh)
    kn, vn = _t(rng, dev, b, s, hkv, dh), _t(rng, dev, b, s, hkv, dh)
    pos = np.array(SPEC_POS, np.int32)
    rows = [PackedRows(torch.zeros((b, S, F // 2), dtype=torch.uint8,
                                   device=dev),
                       torch.zeros((b, S, F // g), device=dev), g, cdt,
                       (hkv, dh)) for _ in range(2)]
    A.spec_decode_attention_packed(q, *rows, kn, vn, torch.from_numpy(
        pos).to(dev))
    shape = ((b, S, hkv, dh), cdt)
    store = TieredKVStore([{"k": shape, "v": shape}],
                          [{"k": "kv", "v": "kv"}], b_max=b, max_len=S,
                          kv_mode="int4", device="cpu")
    store.save_decode(0, {"k": kn[:, :s - 1].cpu(), "v": vn[:, :s - 1].cpu()},
                      range(b), pos)
    for name, pr in zip(("k", "v"), rows):
        leaf = store._units[0][name]
        assert torch.equal(pr.packed.cpu(), leaf.packed)
        assert torch.equal(pr.scale.cpu(), leaf.scale)


# ---------------------------------------------------------------------------
# MoE: Mixtral-8x7B's expert shapes and layer on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
@pytest.mark.parametrize("M", [2, 36, 512])
def test_int4_matmul_expert_shapes(dev, M, K, N):
    """``int4_matmul`` at Mixtral-8x7B's expert projections (w_gate/w_up
    K 4096 -> N 14336, w_down K 14336 -> N 4096) at the rows an expert
    gets: the decode capacity (2), a 114-token prefill's (36) and a batch
    prefill's b*s (512); rtol 1e-5, atol 1e-5 * max|ref|."""
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(M + K)
    x = _t(rng, dev, M, K)
    packed, scale = quantize_int4(_t(rng, dev, K, N, scale=0.05), 128)
    out = int4_matmul(x, packed, scale)
    ref = plain(x, packed, scale, 128)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


def _mixtral_layer(dev, E=8, f=14336, d=4096):
    """One Mixtral-width MoE table (router and 8 expert stacks, f32) on
    the card, drawn on the card from a seeded generator at the
    reference's init scales (an expert stack at 1/sqrt(E), its leading
    dim)."""
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    return {"wg": rn(d, E) / d ** 0.5,
            "w_gate": rn(E, d, f) / E ** 0.5, "w_up": rn(E, d, f) / E ** 0.5,
            "w_down": rn(E, f, d) / E ** 0.5,
            "norm_ffn": torch.zeros(d, device=dev)}


@pytest.mark.parametrize("T", [4, 114])
def test_moe_layer_mixtral_width(dev, T):
    """One Mixtral-width MoE feed-forward (8 experts, top-2, capacity
    1.25) with packed experts: through ``int4_matmul`` (one launch per
    routed expert's projection: 3 x 8 here, every expert gets its
    capacity rows) against ``use_kernels(False)`` on the same tensors,
    within 1e-4 x max."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.quant.int4 import quantize_int4_stack
    cfg = get_config("mixtral-8x7b")
    p = _mixtral_layer(dev)
    for n in ("w_gate", "w_up", "w_down"):
        p[n + "#q"], p[n + "#s"] = quantize_int4_stack(p.pop(n))
    x = torch.randn((1, T, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    ctx = L.Ctx(cfg=cfg, mode="prefill")
    ops.reset_launches()
    out, _ = L.apply_moe_ffn(p, x, ctx)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["int4_matmul"] == 3 * cfg.moe.num_experts
    ops.use_kernels(False)
    try:
        ref, _ = L.apply_moe_ffn(p, x, ctx)
    finally:
        ops.use_kernels(True)
    assert torch.isfinite(out).all()
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err <= 1e-4, err


def test_moe_quant_resident_stacks_through_kernel(dev):
    """``moe_quant="int4"``: ``prepare_moe_params`` packs the resident
    stacks on the card, bit-equal to packing them on the CPU, and the
    layer runs them through ``int4_matmul``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.serving.spec import quant_policy_for
    cfg = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_d_ff=1024))
    p = _mixtral_layer(dev, E=8, f=1024)
    pol = quant_policy_for(None, "fp32", "int4")
    tree = {"pat": (p,)}
    on_card = pol.prepare_moe_params(tree)["pat"][0]
    on_cpu = pol.prepare_moe_params(
        {"pat": ({k: v.cpu() for k, v in p.items()},)})["pat"][0]
    for n in ("w_gate#q", "w_gate#s", "w_down#q", "w_down#s"):
        assert torch.equal(on_card[n].cpu(), on_cpu[n]), n
    x = torch.randn((2, 3, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    ops.reset_launches()
    out, _ = L.apply_moe_ffn(on_card, x, L.Ctx(cfg=cfg, mode="decode"))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["int4_matmul"] == 3 * cfg.moe.num_experts
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("K,N,group", [(4096, 14336, 128), (14336, 4096, 128),
                                       (96, 10, 32)])
def test_quantize_int4_on_card_bit_equal_to_cpu(dev, K, N, group):
    """The engines pack their weights on the card (``quantize_unit(...,
    device=)``, ``prepare_moe_params``): the packed bytes and scales
    equal the CPU's, which equal the JAX package's."""
    from repro_torch.quant.int4 import quantize_int4
    w = _t(np.random.default_rng(K), dev, K, N, scale=0.05)
    qc, sc = quantize_int4(w, group)
    qh, sh = quantize_int4(w.cpu(), group)
    assert torch.equal(sc.cpu(), sh)
    assert torch.equal(qc.cpu(), qh)


# ---------------------------------------------------------------------------
# Gemma 3 (head_dim 256, sliding window) and Qwen3 shapes on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,h,hkv,window,q_offset", [
    (1, 1500, 8, 4, 1024, 0), (1, 1016, 8, 4, 1024, 0),
    (1, 114, 8, 4, 0, 0), (2, 33, 8, 4, 0, 0), (2, 33, 16, 4, 1024, 0),
    (1, 40, 8, 4, 1024, 1100), (1, 70, 8, 4, 64, 0)])
def test_flash_attention_dh256(dev, b, sq, h, hkv, window, q_offset):
    """head_dim 256 (Q in shared memory, a 2-stage ring): Gemma 3's
    prefills (8/4 heads, window 1024 binding at 1500 rows), a group of 4
    (four warps a block, the largest shared memory), a chunk past the
    window with ``q_offset``; against the plain version (atol 2e-5), two
    calls bit-equal."""
    from repro_torch.kernels.flash_attention import flash_attention, plain
    rng = np.random.default_rng(sq + h + window)
    sk = q_offset + sq
    q = _t(rng, dev, b, sq, h, 256)
    k, v = _t(rng, dev, b, sk, hkv, 256), _t(rng, dev, b, sk, hkv, 256)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out = flash_attention(q, k, v, **kw)
    torch.testing.assert_close(out, plain(q, k, v, **kw), rtol=0, atol=2e-5)
    assert torch.equal(out, flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("S,pos,cdt", [
    (1024, [1023, 1023, 299, 113], torch.bfloat16),
    (2048, [1499, 1023, 299, 113], torch.bfloat16),
    (2048, [2047, 0, 700, 1024], torch.float32)])
def test_decode_attention_dh256(dev, S, pos, cdt):
    """head_dim 256 (8 features a lane), group 2: Gemma 3's rolling
    buffer (S = 1024, clamped positions) and global slab; atol 2e-5 at
    f32, 2e-2 over bf16 caches."""
    from repro_torch.kernels.decode_attention import decode_attention, plain
    rng = np.random.default_rng(S + sum(pos))
    q = _t(rng, dev, 4, 8, 256)
    kc, vc = (_t(rng, dev, 4, S, 4, 256).to(cdt) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, p)
    torch.testing.assert_close(out, plain(q, kc, vc, p), rtol=0,
                               atol=2e-5 if cdt == torch.float32 else 2e-2)
    assert torch.equal(out, decode_attention(q, kc, vc, p))


def _rolling_plain(q, kc, vc, pos, W):
    """The reference's rolling-buffer attention, unclamped: slot j holds
    position ``pos - ((pos - j) mod W)`` and is attended when that is
    >= 0 (the JAX package's ``local_decode_attention`` mask)."""
    from repro_torch.kernels.ref import attn_partials
    from repro_torch.models.common import finalize_partials
    j = torch.arange(W, device=q.device)
    p = pos.long()[:, None]
    valid = ((p - (p - j[None]) % W) >= 0)[:, None, :]
    m, l, o = attn_partials(q, kc, vc, valid)
    return finalize_partials(m, l, o).transpose(1, 2).to(q.dtype)


def test_local_decode_attention_on_card(dev):
    """Gemma 3's rolling-buffer decode step (b 4, W 1024, dh 256, bf16)
    at positions past, at and below the window: one ``decode_attention``
    launch at the clamped positions, against the reference's mask over
    the unclamped slots (atol 2e-2 over bf16)."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import local_decode_attention
    rng = np.random.default_rng(0)
    W, pos = 1024, [1499, 1023, 299, 113]
    q = _t(rng, dev, 4, 1, 8, 256)
    kc, vc = (_t(rng, dev, 4, W, 4, 256).to(torch.bfloat16)
              for _ in range(2))
    kn, vn = _t(rng, dev, 4, 1, 4, 256), _t(rng, dev, 4, 1, 4, 256)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    ops.reset_launches()
    out, k2, v2 = local_decode_attention(q, kc.clone(), vc.clone(), kn, vn,
                                         p, W)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == 1
    want = _rolling_plain(q, k2, v2, p, W)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-2)
    rows = torch.arange(4, device=dev)
    assert torch.equal(k2[rows, p.long() % W], kn[:, 0].bfloat16())


@pytest.mark.parametrize("S,pos,fresh,cdt", [
    (2048, [1499, 1015, 299, 113], True, torch.bfloat16),
    (2048, [2047, 0, 700, 1024], False, torch.float32),
    (2048, [1499, 1015, 299, 113], True, torch.float32)])
def test_decode_attention_int4_dh256(dev, S, pos, fresh, cdt):
    """Packed INT4 rows at F = 4 x 256 (Gemma 3's global layers with
    ``kv_mode="int4"``), group 32: against the plain version (atol 2e-5
    at f32, 2e-2 with bf16 rounding) and, without a fresh row, bit-equal
    to ``decode_attention`` over the dequantized cache."""
    from repro_torch.core.kvstore import PackedRows, kv_group, quantize_kv_rows
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4, plain)
    rng = np.random.default_rng(S + sum(pos))
    b, h, hkv, dh = 4, 8, 4, 256
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


@pytest.mark.parametrize("M,K,N", [
    (4, 2560, 2048), (4, 2560, 1024), (4, 2560, 10240), (4, 2048, 2560),
    (4, 10240, 2560), (4, 4096, 4096), (4, 4096, 1024), (4, 4096, 12288),
    (4, 12288, 4096),
    # DeepSeek-V3's MLA projections and its experts' capacities
    (4, 7168, 1536), (4, 1536, 24576), (4, 7168, 576), (4, 16384, 7168),
    (1, 7168, 2048), (5, 2048, 7168), (114, 7168, 576)])
def test_int4_matmul_family_shapes(dev, M, K, N):
    """``int4_matmul`` on Gemma 3's and Qwen3's projections at M = 4, and
    on DeepSeek-V3's MLA projections (K 16384 takes the small-M path's
    deepest slice; N / 2 = 288 at ``wkv_a``) and its experts' capacities;
    rtol 1e-5, atol 1e-5 * max|ref|."""
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(K + N)
    x = _t(rng, dev, M, K)
    packed, scale = quantize_int4(_t(rng, dev, K, N, scale=0.05), 128)
    out = int4_matmul(x, packed, scale)
    ref = plain(x, packed, scale, 128)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


# DeepSeek-V3's MLA (run t of chip_smoke.py): 128 heads over the latent
# (kv_lora 512, nope 128, rope 64, v 128)


@pytest.mark.parametrize("s", [9, 114])
def test_mla_prefill_through_flash_dh192(dev, s):
    """``mla_prefill_attention`` at full width: the expanded latent
    through one ``flash_attention`` launch at head_dim 192 (V padded from
    128), against ``use_kernels(False)`` on the same tensors, atol 2e-5
    (the fp32 attention tolerance)."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import mla_prefill_attention
    rng = np.random.default_rng(s)
    h, r, dn, dr, dv = 128, 512, 128, 64, 128
    q, c, kr = (_t(rng, dev, 1, s, h, dn + dr), _t(rng, dev, 1, s, r),
                _t(rng, dev, 1, s, dr))
    w_uk = _t(rng, dev, r, h, dn, scale=r ** -0.5)
    w_uv = _t(rng, dev, r, h, dv, scale=r ** -0.5)
    ops.reset_launches()
    out = mla_prefill_attention(q, c, kr, w_uk, w_uv)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    ops.use_kernels(False)
    try:
        ref = mla_prefill_attention(q, c, kr, w_uk, w_uv)
    finally:
        ops.use_kernels(True)
    assert out.shape == (1, s, h, dv)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)


def test_mla_offloaded_engine_on_card_matches_cpu(dev):
    """The scaled DeepSeek-V3 offloaded engine (INT4 weights and KV) on
    the card gives the tokens of the same engine on the CPU, from the
    same seed: the prefill through ``flash_attention``, the packed
    projections and experts through ``int4_matmul``, the decode over
    packed latent rows dequantized on the card."""
    from repro_torch.kernels import ops
    from repro_torch.serving.base import Request
    from repro_torch.serving.spec import EngineSpec, create_engine
    plan = EngineSpec(arch="deepseek-v3-671b", scaled=True, offload=True,
                      placement="host", b_max=2, max_len=48, quant="int4",
                      kv_mode="int4", depth=1).resolve()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (9, 20, 13)]
    outs = {}
    for device in ("cpu", "cuda"):
        eng = create_engine(plan, device=device)
        ops.reset_launches()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new=5))
        outs[device] = {r.rid: list(r.out) for r in eng.run()}
        eng.shutdown()
        if device == "cuda":
            torch.cuda.synchronize()
            assert ops.LAUNCHES["flash_attention"] == 2 * 3
            assert ops.LAUNCHES["int4_matmul"] > 0
            assert ops.LAUNCHES["decode_attention_int4"] == 0
    assert outs["cuda"] == outs["cpu"]


# Mamba2's SSD mixer and jamba (runs u and v of chip_smoke.py): the SSM
# functions are plain PyTorch on every device (the reference's jnp);
# their projections go through int4_matmul


@pytest.mark.parametrize("M,K,N", [
    # mamba2: z/x_proj, bc_proj, dt_proj (N = 64: 32 packed bytes a row),
    # out_proj, at decode and at a 400-token prefill
    (4, 2048, 4096), (4, 2048, 256), (4, 2048, 64), (4, 4096, 2048),
    (400, 2048, 256), (400, 2048, 64), (17, 2048, 64),
    # jamba: dt_proj (N = 128), w_down (K = 24576) at the experts'
    # capacities, the dense FFN's decode and a whole prompt
    (4, 8192, 128), (1, 24576, 8192), (4, 24576, 8192), (18, 24576, 8192),
    (114, 24576, 8192)])
def test_int4_matmul_ssm_shapes(dev, M, K, N):
    """``int4_matmul`` at the SSM stacks' shapes: N down to 64 on both
    paths, K 24576 on both; rtol 1e-5, atol 1e-5 * max|ref|."""
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(M + K + N)
    x = _t(rng, dev, M, K)
    packed, scale = quantize_int4(_t(rng, dev, K, N, scale=0.05), 128)
    out = int4_matmul(x, packed, scale)
    ref = plain(x, packed, scale, 128)
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())
    assert torch.equal(out, int4_matmul(x, packed, scale))


def _ssd_args(rng, dev, b, l, H, hd, N):
    return dict(xh=_t(rng, dev, b, l, H, hd, scale=0.5),
                dt=torch.nn.functional.softplus(_t(rng, dev, b, l, H)),
                A=-torch.exp(_t(rng, dev, H, scale=0.3)),
                B=_t(rng, dev, b, l, 1, N, scale=0.3),
                C=_t(rng, dev, b, l, 1, N, scale=0.3))


def _cpu(args):
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in args.items()}


def _rel_close(a, b, rel=2e-5):
    b = b.cpu()
    torch.testing.assert_close(a.cpu(), b, rtol=0,
                               atol=rel * b.abs().max().item())


@pytest.mark.parametrize("l,chunk", [(400, 200), (37, 1), (64, 64)])
def test_ssd_chunked_on_card_matches_cpu(dev, l, chunk):
    """``ssd_chunked`` at mamba2's full head width (64 heads of 64,
    d_state 128) on the card against the same call on the CPU: y, the
    final state and ``state_factor`` within 2e-5 x max (f32 sums in
    other orders)."""
    from repro_torch.models import ssm as S
    rng = np.random.default_rng(l)
    args = _ssd_args(rng, dev, 1, l, 64, 64, 128)
    h0 = _t(rng, dev, 1, 64, 64, 128, scale=0.3)
    got = S.ssd_chunked(**args, chunk=chunk, h_init=h0)
    want = S.ssd_chunked(**_cpu(args), chunk=chunk, h_init=h0.cpu())
    for g, w in ((got[0], want[0]), (got[1], want[1]),
                 (got[2][0], want[2][0])):
        _rel_close(g, w)


@pytest.mark.parametrize("H,hd", [(64, 64), (128, 128)])
def test_ssd_decode_step_and_conv_on_card_match_cpu(dev, H, hd):
    """One decode step at mamba2's and jamba's widths (b 4, d_state 128)
    and the causal conv over a bf16 halo, card against CPU, within 2e-5
    x max."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    rng = np.random.default_rng(H)
    a = _ssd_args(rng, dev, 4, 1, H, hd, 128)
    args = dict(xh=a["xh"][:, 0], dt=a["dt"][:, 0], A=a["A"],
                B=a["B"][:, 0], C=a["C"][:, 0],
                h=_t(rng, dev, 4, H, hd, 128, scale=0.3))
    got, want = S.ssd_decode_step(**args), S.ssd_decode_step(**_cpu(args))
    _rel_close(got[0], want[0])
    _rel_close(got[1], want[1])
    ch = H * hd + 256
    conv = dict(x=_t(rng, dev, 4, 1, ch), w=_t(rng, dev, 4, ch),
                b=_t(rng, dev, ch), halo=_t(rng, dev, 4, 3, ch).bfloat16())
    _rel_close(L._causal_conv(**conv), L._causal_conv(**_cpu(conv)))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_ssm_offloaded_engine_on_card_matches_cpu(dev, arch):
    """The scaled mamba2 and jamba (its first 5 layers) offloaded
    engines (INT4 weights and KV) on the card give the tokens of the
    same engines on the CPU, from the same seed: the SSM projections
    through ``int4_matmul``, the halo and state moving whole, jamba's
    attention layer through ``flash_attention`` and
    ``decode_attention_int4``."""
    from repro_torch.configs import base as PB
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.base import Request
    from repro_torch.serving.spec import EngineSpec, create_engine
    cfg = PB.scaled_down(get_config(arch))
    if cfg.moe:
        cfg = dataclasses.replace(cfg, num_layers=5, num_periods=0,
                                  remainder=tuple(cfg.pattern[:5]))
    plan = EngineSpec(arch=arch, cfg=cfg, offload=True, placement="host",
                      b_max=2, max_len=48, quant="int4", kv_mode="int4",
                      depth=1).resolve()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (9, 37, 20)]
    outs = {}
    for device in ("cpu", "cuda"):
        eng = create_engine(plan, device=device)
        ops.reset_launches()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new=5))
        outs[device] = {r.rid: list(r.out) for r in eng.run()}
        eng.shutdown()
        if device == "cuda":
            torch.cuda.synchronize()
            assert ops.LAUNCHES["int4_matmul"] > 0
            assert ops.LAUNCHES["flash_attention"] == (3 if cfg.moe else 0)
    assert outs["cuda"] == outs["cpu"]


# Whisper's encoder-decoder and qwen2-vl's M-RoPE on the resident engine
# (runs w and x of chip_smoke.py): the encoder and the cross attention's
# prefill run flash_attention at causal=False, group 1, dh 64; the cross
# attention's decode runs decode_attention at group 1 over every encoder
# row


@pytest.mark.parametrize("b,sq,sk,causal", [(1, 1500, 1500, False),
                                            (1, 48, 1500, False),
                                            (1, 48, 48, True),
                                            (2, 37, 24, False)])
def test_flash_attention_encoder_and_cross_shapes(dev, b, sq, sk, causal):
    from repro_torch.kernels.flash_attention import flash_attention, plain
    rng = np.random.default_rng(sq + sk)
    q, k, v = (_t(rng, dev, b, sq, 8, 64), _t(rng, dev, b, sk, 8, 64),
               _t(rng, dev, b, sk, 8, 64))
    out = flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out, plain(q, k, v, causal=causal), rtol=0,
                               atol=2e-5)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("S,pos", [(1500, 1499), (448, [447, 0, 200, 31])])
def test_decode_attention_group1(dev, S, pos):
    """Group 1 (8/8 heads), dh 64, bf16 caches: the cross attention's
    every-row step (an int ``pos`` of S - 1) and the decoder's ragged
    self-attention over its 448-row slab."""
    from repro_torch.kernels.decode_attention import decode_attention, plain
    rng = np.random.default_rng(S)
    q = _t(rng, dev, 4, 8, 64)
    kc = _t(rng, dev, 4, S, 8, 64).to(torch.bfloat16)
    vc = _t(rng, dev, 4, S, 8, 64).to(torch.bfloat16)
    p = pos if isinstance(pos, int) else torch.tensor(pos, device=dev)
    torch.testing.assert_close(decode_attention(q, kc, vc, p),
                               plain(q, kc, vc, p), rtol=0, atol=2e-2)


def test_cross_decode_attention_on_card(dev):
    """The kernel route (one ``decode_attention`` launch at S - 1, its
    output rounded to bf16) against the plain version, the reference's
    arithmetic, on the same card tensors."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import cross_decode_attention
    rng = np.random.default_rng(7)
    q = _t(rng, dev, 4, 1, 8, 64)
    ck = _t(rng, dev, 4, 1500, 8, 64).to(torch.bfloat16)
    cv = _t(rng, dev, 4, 1500, 8, 64).to(torch.bfloat16)
    ops.reset_launches()
    out = cross_decode_attention(q, ck, cv)
    assert ops.LAUNCHES["decode_attention"] == 1
    ops.use_kernels(False)
    try:
        ref = cross_decode_attention(q, ck, cv)
    finally:
        ops.use_kernels(True)
    assert out.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b"])
def test_frontend_resident_engine_on_card_matches_cpu(dev, arch):
    """The scaled whisper (with seeded frames and the zero stub) and
    qwen2-vl resident engines on the card give the tokens of the same
    engines on the CPU, from the same seed; exact launches: whisper's
    prefill runs the encoder's, the self-attention's and the cross
    attention's flash per layer, its decode step two decode launches a
    layer."""
    from repro_torch.kernels import ops
    from repro_torch.serving.base import Request
    from repro_torch.serving.spec import EngineSpec, create_engine
    plan = EngineSpec(arch=arch, scaled=True, b_max=2, max_len=48).resolve()
    cfg = plan.model_config()
    rng = np.random.default_rng(0)
    reqs = []
    for i, n in enumerate((9, 20, 13)):
        enc = (rng.standard_normal((cfg.encoder_seq_len, cfg.d_model))
               .astype(np.float32) if cfg.enc_dec and i else None)
        reqs.append((rng.integers(0, 256, (n,)).astype(np.int32), enc))
    outs = {}
    for device in ("cpu", "cuda"):
        eng = create_engine(plan, device=device)
        ops.reset_launches()
        for i, (p, enc) in enumerate(reqs):
            eng.submit(Request(rid=i, prompt=p.copy(), max_new=5,
                               enc_embeds=enc))
        outs[device] = {r.rid: list(r.out) for r in eng.run()}
        if device == "cuda":
            torch.cuda.synchronize()
            n, st = cfg.num_layers, eng.stats
            per_prefill = (cfg.num_encoder_layers + 2 * n if cfg.enc_dec
                           else n)
            per_step = 2 * n if cfg.enc_dec else n
            assert ops.LAUNCHES["flash_attention"] == \
                per_prefill * st["prefills"]
            assert ops.LAUNCHES["decode_attention"] == \
                per_step * st["decode_steps"]
        eng.shutdown()
    assert outs["cuda"] == outs["cpu"]


# ---------------------------------------------------------------------------
# training on the card (plain PyTorch, no kernel): one step against the
# port's CPU step, bf16, checkpoints
# ---------------------------------------------------------------------------

def _train_setup(arch, dev, dtype=torch.float32):
    """Scaled ``arch``'s seed-0 parameters on ``dev`` at ``dtype``, its
    model, AdamW and step 0's synthetic batch (numpy)."""
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.data import DataConfig, DataPipeline, SyntheticSource
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    cfg = scaled_down(get_config(arch))
    model = build_model(cfg)
    dcfg = DataConfig(seq_len=32, global_batch=2, vocab_size=cfg.vocab_size)
    batch = DataPipeline(SyntheticSource(dcfg), dcfg).batch_at(0)
    batch.pop("step")
    return model, model.init(0, device=dev, dtype=dtype), AdamW(), batch


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "deepseek-v3-671b"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """f32 with TF32 off (``resolve_device``): the loss within 1e-5
    relative, every gradient leaf within 1e-4 x its max |g|, the updated
    AdamW moments within 1e-5; no kernel launched."""
    from repro_torch import tree as PT
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step, value_and_grad
    out = []
    for d in (torch.device("cpu"), dev):
        model, params, opt, batch = _train_setup(arch, d)
        before = dict(ops.LAUNCHES)
        loss, grads = value_and_grad(model, params, batch)
        _, state, m = make_train_step(model, opt)(params, opt.init(params),
                                                  batch)
        assert dict(ops.LAUNCHES) == before
        assert float(m["loss"]) == float(loss)
        out.append((float(loss), PT.leaves(grads), PT.leaves(state)))
    cpu, gpu = out
    assert abs(gpu[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    for a, b in zip(cpu[1], gpu[1]):
        torch.testing.assert_close(b.cpu(), a, rtol=0,
                                   atol=1e-4 * a.abs().max().item())
    for a, b in zip(cpu[2], gpu[2]):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5)


def test_train_bf16_step_on_card(dev):
    from repro_torch.launch.steps import make_train_step
    losses = {}
    for dt in (torch.float32, torch.bfloat16):
        model, params, opt, batch = _train_setup("tinyllama-1.1b", dev, dt)
        params, _, m = make_train_step(model, opt)(
            params, opt.init(params), batch)
        assert params["pat"][0]["wq"].dtype == dt
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        losses[dt] = float(m["loss"])
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) \
        <= 2e-2 * abs(losses[torch.float32])


def test_train_checkpoint_on_card_restores_bit_equal(dev, tmp_path):
    from repro_torch import tree as PT
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.steps import make_train_step
    model, params, opt, batch = _train_setup("tinyllama-1.1b", dev,
                                             torch.bfloat16)
    params, state, _ = make_train_step(model, opt)(
        params, opt.init(params), batch)
    tree = {"params": params, "opt": state}
    save_checkpoint(str(tmp_path), 1, tree)
    back, _ = restore_checkpoint(str(tmp_path), 1, tree)
    for a, b in zip(PT.leaves(tree), PT.leaves(back)):
        assert b.device == a.device and b.dtype == a.dtype
        assert torch.equal(a, b)


def _aten_ops(fn):
    """(fn's result, the names of the aten ops it dispatched)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Rec(TorchDispatchMode):
        names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    with Rec() as rec:
        out = fn()
    return out, rec.names


CASTS = {"to", "_to_copy", "copy_"}


def test_int4_matmul_op_bf16_cast_path(dev):
    """A bf16 ``x``: the op no longer casts (the cast path is gone); it
    launches the kernel's bf16 instance once, dispatches no cast, and
    writes a bf16 output equal to widening x, the f32 instance and a cast
    back (the same products on the exactly widened x), within the
    kernel's tolerance of the plain version at the widened input."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import int4_matmul_ref
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(4)
    x = _t(rng, dev, 4, 2048).to(torch.bfloat16)
    packed, scale = quantize_int4(_t(rng, dev, 2048, 512, scale=0.05))
    ops.reset_launches()
    got, names = _aten_ops(lambda: ops.int4_matmul_op(x, packed, scale,
                                                      group=128))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["int4_matmul"] == ops.LAUNCHES["int4_matmul_bf16"] == 1
    assert not CASTS & set(names), names
    ref = int4_matmul_ref(x.float(), packed, scale, 128)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ops.int4_matmul_op(x.float(), packed, scale,
                                               group=128).to(torch.bfloat16))
    assert (got.float() - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.parametrize("op", ["flash", "decode"])
def test_attention_ops_bf16_cast_path(dev, op):
    """bf16 q, k and v (``flash_attention_op``) or bf16 q over bf16
    caches (``decode_attention_op``): the cast path is gone; one launch of
    the bf16 instance, no cast dispatched, within 2e-2 of the plain arm
    (``use_kernels(False)``) on the bf16 inputs.  Decode equals the old
    recipe (widen q, the f32 instance, cast back) bit for bit; flash
    rounds P to bf16 as the TPU kernel does, within 2e-2 of it."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(6)
    bf = lambda *s: _t(rng, dev, *s).to(torch.bfloat16)
    if op == "flash":
        q, k, v = bf(4, 128, 32, 64), bf(4, 128, 4, 64), bf(4, 128, 4, 64)
        run = lambda: ops.flash_attention_op(q, k, v, causal=True)
        recipe = ops.flash_attention_op(q.float(), k.float(), v.float(),
                                        causal=True).to(torch.bfloat16)
        name = "flash_attention"
    else:
        q, k, v = bf(4, 32, 64), bf(4, 256, 4, 64), bf(4, 256, 4, 64)
        pos = torch.tensor([143, 0, 77, 255], dtype=torch.int32, device=dev)
        run = lambda: ops.decode_attention_op(q, k, v, pos)
        recipe = ops.decode_attention_op(q.float(), k, v,
                                         pos).to(torch.bfloat16)
        name = "decode_attention"
    ops.reset_launches()
    got, names = _aten_ops(run)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == ops.LAUNCHES[name + "_bf16"] == 1
    assert got.dtype == torch.bfloat16 and not CASTS & set(names), names
    if op == "decode":
        assert torch.equal(got, recipe)
    torch.testing.assert_close(got.float(), recipe.float(), rtol=0,
                               atol=2e-2)
    ops.use_kernels(False)
    try:
        plain = run()
    finally:
        ops.use_kernels(True)
    torch.testing.assert_close(got.float(), plain.float(), rtol=0,
                               atol=2e-2)


# the bf16 instances at the main paths' shapes: (M, K, N) on both int4
# paths; flash at dh 64, 128 and 256 with a window, a q_offset and
# causal=False; decode over both cache types; decode INT4 with and
# without bf16 fresh rows
def _bf16_ulps(a, b):
    """Element-wise distance in bf16 ulps (sign-magnitude bit patterns)."""
    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


@pytest.mark.parametrize("M,K,N", [(4, 2048, 2048), (16, 5632, 256),
                                   (4, 8192, 2048), (17, 2048, 5632),
                                   (37, 2048, 256), (512, 5632, 2048),
                                   (3, 96, 10)])
def test_int4_matmul_bf16_instance(dev, M, K, N):
    """bf16 x read and bf16 out written in-kernel: the GEMV (M <= 16)
    equal bit for bit to widening x, the f32 instance and a cast back
    (its products on the widened x); the tensor-core path (bf16 wgmma,
    products exact, sums f32 in another order) within one bf16 ulp of
    that recipe on every element; within 2e-2 x max of the plain version
    at bf16; two calls equal."""
    from repro_torch.kernels.int4_matmul import SMALL_M, int4_matmul, plain
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(M + K + N)
    G = 32 if K % 128 else 128
    x = _t(rng, dev, M, K).to(torch.bfloat16)
    packed, scale = quantize_int4(_t(rng, dev, K, N, scale=0.05), G)
    out = int4_matmul(x, packed, scale, group=G)
    assert out.dtype == torch.bfloat16
    recipe = int4_matmul(x.float(), packed, scale, group=G).to(torch.bfloat16)
    if M <= SMALL_M:
        assert torch.equal(out, recipe)
    else:
        assert _bf16_ulps(out, recipe).max().item() <= 1
    assert torch.equal(out, int4_matmul(x, packed, scale, group=G))
    ref = plain(x, packed, scale, G).to(torch.bfloat16).float()
    assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


@pytest.mark.parametrize("M,K,N,G", [(512, 2048, 5632, 128),
                                     (128, 4096, 14336, 128),
                                     (20, 2048, 2048, 128),
                                     (64, 1024, 200, 32),
                                     (65, 384, 256, 16)])
def test_int4_matmul_bf16_wgmma_rows(dev, M, K, N, G):
    """The bf16 tensor-core path at (aa)'s prefill (M 512), the 8B's M
    128, the verify pass's M 20 and edges (one and two warpgroups, a
    ragged N, group 16 and 32): within one bf16 ulp of the cast recipe and
    within the plain tolerance (rtol 2^-8 + 1e-5, atol 1e-5 x max of the
    plain version's f32 output); a group that is not a multiple of 16
    raises."""
    from repro_torch.kernels.int4_matmul import int4_matmul, plain
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(M * N + G)
    x = _t(rng, dev, M, K).to(torch.bfloat16)
    packed, scale = quantize_int4(_t(rng, dev, K, N, scale=0.05), G)
    out = int4_matmul(x, packed, scale, group=G)
    recipe = int4_matmul(x.float(), packed, scale, group=G).to(torch.bfloat16)
    assert _bf16_ulps(out, recipe).max().item() <= 1
    ref = plain(x, packed, scale, G)
    d = (out.float() - ref).abs()
    assert (d <= (2.0 ** -8 + 1e-5) * ref.abs()
            + 1e-5 * ref.abs().max()).all()
    packed8, scale8 = quantize_int4(_t(rng, dev, 64, 32), 8)
    with pytest.raises(ValueError, match="group % 16"):
        int4_matmul(_t(rng, dev, 32, 64).to(torch.bfloat16), packed8, scale8,
                    group=8)


# flash_attention's plan: (b, sq, sk, h, hkv, dh, causal, window,
# q_offset) at group 1 (bidirectional, as whisper's encoder), group 2
# (Gemma 3 with a window), dh 192 (the MLA prefill: 8 warps at f32),
# group 4 and 8
FLASH_PLAN_ROWS = [(2, 96, 96, 8, 8, 64, False, 0, 0),
                   (1, 300, 300, 8, 4, 256, True, 128, 0),
                   (1, 114, 114, 128, 128, 192, True, 0, 0),
                   (1, 37, 37, 32, 8, 128, True, 0, 0),
                   (2, 45, 45, 8, 2, 32, True, 13, 0),
                   (3, 70, 70, 6, 6, 16, True, 0, 0),
                   (2, 33, 33, 12, 2, 32, True, 0, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,dh,causal,window,q_offset",
                         FLASH_PLAN_ROWS)
def test_flash_plan_bit_equal_to_one_row_tile_plan(dev, dtype, b, sq, sk, h,
                                                   hkv, dh, causal, window,
                                                   q_offset):
    """Without a key split a row's arithmetic does not depend on the block
    layout: the plan's blocks (wh heads x wr row tiles, 4 or 8 warps) give the
    same bits as the earlier layout (wh the most of 4, 2, 1 dividing the
    group, one row tile, no split), launched through the kernel's C entry
    point; within the plain tolerance (f32 2e-5, bf16 2e-2 x max)."""
    from repro_torch.kernels.flash_attention import (_launch, flash_attention,
                                                     flash_plan, plain)
    rng = np.random.default_rng(sq + h + dh)
    q, k, v = (_t(rng, dev, b, sq, h, dh).to(dtype),
               _t(rng, dev, b, sk, hkv, dh).to(dtype),
               _t(rng, dev, b, sk, hkv, dh).to(dtype))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    wh, wr, splits, _ = flash_plan(b, sq, sk, h, hkv, causal, window,
                                   q_offset, dh=dh, itemsize=q.element_size())
    assert wh * wr >= 4 and splits == 1
    out = flash_attention(q, k, v, **kw)
    old = torch.empty_like(q)
    w = next(w for w in (4, 2, 1) if (h // hkv) % w == 0)
    _launch(q, k, v, old, causal, window, q_offset, (w, 1, 1))
    torch.cuda.synchronize()
    assert torch.equal(out, old)
    ref = plain(q, k, v, **kw).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,dh,causal,window,q_offset,splits", [
    (1, 48, 1500, 8, 8, 64, False, 0, 0, 8),
    (1, 32, 1500, 32, 8, 128, True, 0, 1468, 8),
    (2, 40, 400, 4, 4, 64, True, 200, 360, 2),
    (1, 20, 600, 8, 4, 256, True, 0, 580, 4)])
def test_flash_key_split_rows(dev, dtype, b, sq, sk, h, hkv, dh, causal,
                              window, q_offset, splits):
    """Where the plan splits the keys across a cluster (whisper's cross
    prefill, a short chunk over a long prefix, a window, dh 256): within
    the plain tolerance, equal over two calls (the ranks merge in rank
    order), and one launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_plan, plain)
    rng = np.random.default_rng(sk + q_offset)
    q, k, v = (_t(rng, dev, b, sq, h, dh).to(dtype),
               _t(rng, dev, b, sk, hkv, dh).to(dtype),
               _t(rng, dev, b, sk, hkv, dh).to(dtype))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert flash_plan(b, sq, sk, h, hkv, causal, window, q_offset, dh=dh,
                      itemsize=q.element_size())[2] == splits
    ops.reset_launches()
    out = flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    ref = plain(q, k, v, **kw).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("b,sq,sk,h,hkv,dh,causal,window,q_offset",
                         [(4, 128, 128, 32, 4, 64, True, 0, 0),
                          (1, 37, 37, 32, 8, 128, True, 0, 0),
                          (1, 300, 300, 8, 4, 256, True, 128, 0),
                          (1, 18, 114, 32, 8, 128, True, 0, 96),
                          (1, 48, 300, 8, 8, 64, False, 0, 0),
                          (2, 33, 33, 16, 4, 256, True, 0, 0),
                          (1, 20, 20, 4, 2, 16, True, 0, 0),
                          (2, 45, 65, 8, 2, 32, True, 13, 20)])
def test_flash_attention_bf16_instance(dev, b, sq, sk, h, hkv, dh, causal,
                                       window, q_offset):
    """Both products on bf16 mma.sync, the unnormalised P rounded to bf16:
    within 2e-2 x max of the plain version at bf16 (which normalises P
    before rounding it) and of the f32 instance on the widened inputs;
    two calls equal; one launch each, counted as the bf16 instance's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, plain
    rng = np.random.default_rng(sq * sk + dh)
    q, k, v = (_t(rng, dev, b, sq, h, dh).to(torch.bfloat16),
               _t(rng, dev, b, sk, hkv, dh).to(torch.bfloat16),
               _t(rng, dev, b, sk, hkv, dh).to(torch.bfloat16))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ops.reset_launches()
    out = flash_attention(q, k, v, **kw)
    assert ops.LAUNCHES["flash_attention_bf16"] == 1
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    for ref in (plain(q, k, v, **kw).float(),
                flash_attention(q.float(), k.float(), v.float(), **kw)):
        assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_flash_attention_bf16_refuses_odd_head_dim(dev):
    """The bf16 instance takes a head_dim that is a multiple of 16: any
    other raises, naming the shape (no quiet widening)."""
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.zeros(1, 8, 4, 40, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match=r"multiple of 16.*\(1, 8, 4, 40\)"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,h,hkv,dh,pos", [
    (4, 160, 32, 4, 64, [159, 0, 77, 131]),
    (4, 1536, 8, 4, 256, [1515, 1031, 315, 129]),
    (4, 1500, 8, 8, 64, [1499] * 4), (3, 77, 8, 2, 32, [76, 0, 40])])
def test_decode_attention_bf16_q(dev, cdt, b, S, h, hkv, dh, pos):
    """bf16 q read and bf16 out written in-kernel: bit-equal to widening
    q, the f32-q instance and a cast back (the TPU kernel's arithmetic,
    all f32 after the load), also with q as a strided view."""
    from repro_torch.kernels.decode_attention import decode_attention
    rng = np.random.default_rng(S + h + dh)
    q = _t(rng, dev, b, h, dh).to(torch.bfloat16)
    kc, vc = (_t(rng, dev, b, S, hkv, dh).to(cdt) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, p)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, decode_attention(q.float(), kc, vc,
                                             p).to(torch.bfloat16))
    qv = torch.zeros(b, h + 2, dh, dtype=torch.bfloat16, device=dev)[:, 1:h + 1]
    qv.copy_(q)
    assert torch.equal(out, decode_attention(qv, kc, vc, p))


@pytest.mark.parametrize("fresh", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,h,hkv,dh,pos", [
    (4, 160, 32, 4, 64, [159, 0, 77, 131]),
    (4, 2048, 8, 4, 256, [1515, 1031, 315, 129]),
    (3, 77, 6, 3, 16, [76, 0, 40])])
def test_decode_attention_int4_bf16_q(dev, fresh, cdt, b, S, h, hkv, dh, pos):
    """bf16 q (the repaired instance), with no fresh row or fresh rows of
    either dtype: bit-equal to widening q (and the fresh rows), the f32
    instance and a cast back."""
    from repro_torch.core.kvstore import kv_group, quantize_kv_rows
    from repro_torch.kernels.decode_attention_int4 import (
        decode_attention_int4)
    rng = np.random.default_rng(S + dh)
    F = hkv * dh
    g = kv_group(F)
    q = _t(rng, dev, b, h, dh).to(torch.bfloat16)
    kq, ks = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    vq, vs = quantize_kv_rows(_t(rng, dev, b, S, F), g)
    kn = vn = None
    if fresh is not None:
        kn, vn = (_t(rng, dev, b, hkv, dh).to(fresh) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(hkv=hkv, group=g, cache_dtype=cdt)
    out = decode_attention_int4(q, kq, ks, vq, vs, p, k_new=kn, v_new=vn, **kw)
    assert out.dtype == torch.bfloat16
    wide = decode_attention_int4(
        q.float(), kq, ks, vq, vs, p, **kw,
        k_new=None if kn is None else kn.float(),
        v_new=None if vn is None else vn.float()).to(torch.bfloat16)
    assert torch.equal(out, wide)


def test_pipelined_disk_to_device_to_card(dev, tmp_path):
    """The transfer suite to the card: blockwise reads into a pinned
    buffer with the copies on a side stream, and ``host_to_device``,
    bit-equal to what was written."""
    from repro_torch.core import transfer as X
    from repro_torch.core.offload import DiskStore
    disk = DiskStore(str(tmp_path))
    rng = np.random.default_rng(5)
    arrays = {"f32": rng.standard_normal((1000, 77)).astype(np.float32),
              "u8": rng.integers(0, 255, (3, 70001), dtype=np.uint8)}
    for key, a in arrays.items():
        disk.put(key, a)
        got = X.pipelined_disk_to_device(disk, key, block_bytes=4096,
                                         device=dev)
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), a)
        assert np.array_equal(X.host_to_device(a, device=dev).cpu().numpy(),
                              a)
