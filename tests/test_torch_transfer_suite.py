"""The link probe of the port's ``core/transfer.py`` against the JAX
package's transfer suite (``src/repro/core/transfer.py``), on a temporary
disk tier of each package holding the same numpy arrays, as
``tests/test_transfer.py`` drives the reference: ``naive_disk_to_host``,
``blockwise_disk_to_host``, ``host_to_device`` and
``pipelined_disk_to_device`` return the reference's arrays bit for bit
(at block sizes that split the key unevenly, and with one reader
thread), ``sweep_block_size`` the reference's block sizes with a rate
each.  Here the device is the CPU (``device="cpu"``); the copy to the
card through a pinned buffer and a side stream is
``tests/test_torch_gpu.py``'s ``cuda``-marked case."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import transfer as JT  # noqa: E402
from repro.core.offload import DiskStore as JaxDiskStore  # noqa: E402
from repro_torch.core import transfer as PT  # noqa: E402
from repro_torch.core.offload import DiskStore  # noqa: E402

ARRAYS = {"f32": lambda r: r.standard_normal((1000, 77)).astype(np.float32),
          "u8": lambda r: r.integers(0, 255, (3, 70001), dtype=np.uint8),
          "i32": lambda r: r.integers(-9, 9, (4097,), dtype=np.int32)}


@pytest.fixture
def stores(tmp_path):
    rng = np.random.default_rng(0)
    jd, pd = JaxDiskStore(str(tmp_path / "jax")), DiskStore(
        str(tmp_path / "port"))
    arrays = {k: f(rng) for k, f in ARRAYS.items()}
    for k, a in arrays.items():
        jd.put(k, a)
        pd.put(k, a)
    return jd, pd, arrays


@pytest.mark.parametrize("key", sorted(ARRAYS))
def test_naive_disk_to_host_matches_reference(stores, key):
    jd, pd, arrays = stores
    got, want = PT.naive_disk_to_host(pd, key), JT.naive_disk_to_host(jd, key)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want) and np.array_equal(got, arrays[key])


@pytest.mark.parametrize("block,threads", [(4096, 3), (1 << 20, 3),
                                           (12345, 1)])
@pytest.mark.parametrize("key", sorted(ARRAYS))
def test_blockwise_and_pipelined_match_reference(stores, key, block,
                                                 threads):
    jd, pd, _ = stores
    want = JT.blockwise_disk_to_host(jd, key, block_bytes=block,
                                     n_threads=threads)
    got = PT.blockwise_disk_to_host(pd, key, block_bytes=block,
                                    n_threads=threads)
    assert np.array_equal(got, want)
    want_dev = np.asarray(JT.pipelined_disk_to_device(
        jd, key, block_bytes=block, n_threads=threads))
    got_dev = PT.pipelined_disk_to_device(pd, key, block_bytes=block,
                                          n_threads=threads, device="cpu")
    assert isinstance(got_dev, torch.Tensor)
    assert got_dev.numpy().dtype == want_dev.dtype
    assert np.array_equal(got_dev.numpy(), want_dev)


@pytest.mark.parametrize("key", sorted(ARRAYS))
def test_host_to_device_matches_reference(stores, key):
    _, _, arrays = stores
    a = arrays[key]
    want = np.asarray(JT.host_to_device(a))
    got = PT.host_to_device(a, device="cpu")
    assert np.array_equal(got.numpy(), want)
    got[...] = 0                     # a copy, not a view of the caller's
    assert np.array_equal(a, want)
    assert np.array_equal(PT.host_to_device(torch.from_numpy(a),
                                            device="cpu").numpy(), want)


def test_sweep_block_size_matches_reference_sizes(stores):
    jd, pd, _ = stores
    sizes = [1 << 12, 1 << 16, 1 << 20]
    want = JT.sweep_block_size(jd, "u8", sizes=sizes, repeats=1)
    got = PT.sweep_block_size(pd, "u8", sizes=sizes, repeats=1)
    assert [b for b, _ in got] == [b for b, _ in want] == sizes
    assert all(bw > 0 for _, bw in got)
    default = PT.sweep_block_size(pd, "i32", repeats=1)
    assert [b for b, _ in default] == [b for b, _ in JT.sweep_block_size(
        jd, "i32", repeats=1)]
