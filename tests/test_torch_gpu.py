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
