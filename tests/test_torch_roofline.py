"""The port's roofline counter (``repro_torch.roofline``) and kernel cost
functions (``repro_torch.kernels.cost``) on the CPU, on meta tensors:

  * a train step's operations at ``Dist.local()`` on scaled tinyllama,
    llama4-scout (MoE), mamba2 and whisper: within 1 % of the JAX
    package's HLO count (``analyze_hlo`` of the compiled
    ``value_and_grad(train_loss)``) at the same shapes (measured: equal
    for three, 0.1 % for mamba2; at 32 tokens, one SSD chunk, XLA folds
    the product with the zero initial state away and the gap is 2.3 %);
  * ``model_flops`` and ``roofline_report``: the reference's formulas on
    the same inputs;
  * the counter on small programs: a matmul loop counts 2MKN a trip; a
    view moves no bytes; a meta ``int4_matmul_op`` prices x, the packed
    bytes, the scales and the output, not an f32 weight (a bf16 x and its
    output at 2 bytes, no cast beside the kernel); the live-bytes peak;
  * the collectives on an ``AbstractMesh``: local result shapes, the ring
    bytes of each kind, NVLink within 8 ranks and the NICs beyond; a real
    (one-rank gloo) mesh records nothing;
  * the profile's rows and tags;
  * ``kernels.cost`` against the byte and operation sums ``chip_smoke.py``
    computed itself before, on every shape of ``PERF.md``'s kernel table,
    so no bound there moves.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import scaled_down as jscaled  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import Dist as JDist  # noqa: E402
from repro.roofline import analysis as JA  # noqa: E402
from repro_torch.configs import REGISTRY, SHAPES, get_config  # noqa: E402
from repro_torch.configs import scaled_down  # noqa: E402
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.roofline import (HW, analyze_step, model_flops,  # noqa: E402
                                  roofline_report)
from repro_torch.roofline.profile import profile_step  # noqa: E402

META = "meta"
FLOP_REL = 0.01


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# train-step operations against the reference's HLO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama4-scout-17b-a16e",
                                  "mamba2-1.3b", "whisper-base"])
def test_train_flops_match_reference_hlo(arch):
    cfg, jcfg = scaled_down(get_config(arch)), jscaled(jget(arch))
    b, s = 2, 64
    shapes = {"labels": (b, s)}
    if cfg.frontend == "embeds" and not cfg.enc_dec:
        shapes["embeds"] = (b, s, cfg.d_model)
    else:
        shapes["tokens"] = (b, s)
    if cfg.enc_dec:
        shapes["enc_embeds"] = (b, cfg.encoder_seq_len, cfg.d_model)
    batch = {k: _meta(*v, dtype=torch.float32 if len(v) == 3
                      else torch.int32) for k, v in shapes.items()}
    model = Model(cfg)
    acc = analyze_step(lambda p, bt: value_and_grad(model, p, bt),
                       T.param_struct(cfg, torch.float32), batch)
    jb = {k: jax.ShapeDtypeStruct(v, jnp.float32 if len(v) == 3
                                  else jnp.int32) for k, v in shapes.items()}
    txt = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.train_loss(p, bt, jcfg, JDist.local()))).lower(
        JT.param_struct(jcfg, jnp.float32), jb).compile().as_text()
    want = JA.analyze_hlo(txt, 1)["flops"]
    assert abs(acc["flops"] / want - 1) <= FLOP_REL, (acc["flops"], want)


# ---------------------------------------------------------------------------
# model_flops, roofline_report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_model_flops_match_reference(arch, shape):
    assert model_flops(REGISTRY[arch], SHAPES[shape]) == JA.model_flops(
        jget(arch), JAX_SHAPES[shape])


def test_roofline_report_matches_reference():
    """The same totals on the same rates give the same terms; the port's
    link keys are the reference's ``ici``/``dcn`` ones renamed."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        f, h, near, far = (float(v) for v in rng.uniform(1e9, 1e13, 4))
        hw = HW(peak_flops=float(rng.uniform(1e14, 1e15)),
                hbm_bw=float(rng.uniform(1e11, 1e13)),
                nvlink_bw=float(rng.uniform(1e10, 1e12)),
                ib_bw=float(rng.uniform(1e9, 1e11)))
        jhw = JA.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                    ici_bw=hw.nvlink_bw, dcn_bw=hw.ib_bw)
        got = roofline_report({"flops": f, "hbm_bytes": h,
                               "nvlink_bytes": near, "ib_bytes": far}, hw)
        want = JA.roofline_report({"flops": f, "hbm_bytes": h,
                                   "ici_bytes": near, "dcn_bytes": far},
                                  jhw)
        for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                  "bottleneck", "t_bound_s"):
            assert got[k] == want[k], k


def test_hw_is_the_h100_datasheet():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.nvlink_bw, hw.ib_bw,
            hw.cards_per_node) == (989e12, 3.35e12, 450e9, 50e9, 8)


# ---------------------------------------------------------------------------
# the counter on small programs
# ---------------------------------------------------------------------------

def test_matmul_loop_counts_each_trip():
    M, K, N, trips = 8, 64, 32, 3

    def fn(x, w):
        for _ in range(trips):
            y = x @ w
        return y
    acc = analyze_step(fn, _meta(M, K), _meta(K, N))
    assert acc["flops"] == trips * 2 * M * K * N
    assert acc["hbm_bytes"] == trips * 4 * (M * K + K * N + M * N)
    assert acc["arg_bytes"] == 4 * (M * K + K * N)


def test_view_moves_no_bytes():
    acc = analyze_step(lambda x: x.view(16, 64).t()[2:].unsqueeze(0),
                       _meta(32, 32))
    assert acc["hbm_bytes"] == 0 and acc["flops"] == 0
    assert acc["temp_bytes"] == 0


def test_live_bytes_peak():
    def fn(x):
        a = x * 2                  # 4 KiB live
        b = torch.cat([a, a])      # 8 KiB more
        del a
        return b.sum()
    acc = analyze_step(fn, _meta(1024))
    assert acc["temp_bytes"] == 12 * 1024 - 4   # less the 0-d output's


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_int4_matmul_prices_packed_bytes(dtype):
    M, K, N, G = 4, 2048, 512, 128
    x = _meta(M, K, dtype=dtype)
    packed = _meta(K, N // 2, dtype=torch.uint8)
    scale = _meta(K // G, N)
    acc = analyze_step(lambda a, p, s: ops.int4_matmul_op(a, p, s, group=G),
                       x, packed, scale)
    # x and the output at x's own size (the bf16 instance reads bf16 x and
    # writes bf16): no cast moves a byte outside the kernel
    isz = 4 if dtype == torch.float32 else 2
    kernel = isz * M * K + K * N // 2 + 4 * (K // G) * N + isz * M * N
    assert acc["kernels"]["int4_matmul"] == {
        "flops": 2.0 * M * K * N, "bytes": float(kernel), "count": 1}
    assert acc["hbm_bytes"] == kernel
    assert acc["flops"] == 2.0 * M * K * N
    # an f32 weight would have cost 4 K N bytes
    assert kernel < 4 * K * N / 4


def test_meta_attention_kernels_price_their_work():
    q, k = _meta(2, 64, 8, 32), _meta(2, 64, 2, 32)
    acc = analyze_step(lambda a, b: ops.flash_attention_op(a, b, b), q, k)
    want = cost.flash_attention(2, 64, 64, 8, 2, 32)
    assert acc["kernels"]["flash_attention"]["flops"] == want.flops
    assert acc["flops"] == want.flops
    assert acc["flops"] == 4 * 2 * 8 * 32 * (64 * 65 // 2)
    cache = _meta(2, 100, 2, 32, dtype=torch.bfloat16)
    acc = analyze_step(lambda a, c: ops.decode_attention_op(a, c, c, 9),
                       _meta(2, 8, 32), cache)
    assert acc["kernels"]["decode_attention"]["bytes"] == \
        cost.decode_attention(2, 8, 2, 32, 2 * 10, 2).nbytes


# ---------------------------------------------------------------------------
# collectives on an AbstractMesh
# ---------------------------------------------------------------------------

def test_abstract_collectives_shapes_and_ring_bytes():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    dist = common.Dist(mesh=mesh, data_axes=("pod", "data"),
                       model_axis="model")
    x, y = _meta(8, 64), _meta(32, 64)      # 2 KiB, 8 KiB

    def fn(x, y):
        with common.in_mesh(dist):
            assert common.axis_index("model") == 0
            out = [common.psum(x, "model"),
                   common.all_gather(x, "model", 1),
                   common.psum_scatter(y, "model", 0),
                   common.all_to_all(x, "model"),
                   common.ppermute(x, "model", [(0, 1), (1, 0)]),
                   common.pmax(x, "pod"),
                   common.all_gather(x, ("pod", "data"), 0),
                   common.chunk(x, "pod", 1),
                   common.relayout(x, ("data", None), (None, "model"))]
        return out
    acc = analyze_step(fn, x, y)
    shapes = [tuple(t.shape) for t in acc["out"]]
    assert shapes == [(8, 64), (8, 1024), (2, 64), (8, 64), (8, 64),
                      (8, 64), (256, 64), (8, 32), (128, 4)]
    n = 8 * 64 * 4
    ring = {"all-reduce": 2 * n * 15 / 16 + 2 * n * 1 / 2,
            "all-gather": 16 * n * 15 / 16 + 32 * n * 31 / 32
            + 16 * n * 15 / 16,
            "reduce-scatter": n / 4 * 15, "all-to-all": n * 15 / 16,
            "collective-permute": float(n)}
    for kind, want in ring.items():
        assert acc.get("coll_" + kind, 0.0) == pytest.approx(want), kind
    # only the pod axis (2 ranks) stays within a node
    assert acc["nvlink_bytes"] == pytest.approx(2 * n * 1 / 2)
    assert acc["coll_count"] == 8
    assert common.COLL_RECORD == []


def test_real_mesh_records_nothing(tmp_path):
    """A one-rank gloo ``DeviceMesh``: the collectives run through
    ``torch.distributed`` as before and ``COLL_RECORD`` stays empty."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    store = tdist.FileStore(str(tmp_path / "store"), 1)
    tdist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        dist = common.Dist(mesh=mesh, data_axes=("data",),
                           model_axis="model")
        assert not dist.is_abstract
        x = torch.arange(6.0).reshape(2, 3)
        with common.in_mesh(dist):
            y = common.psum(x, "model")
            z = common.all_gather(x, "data", 0)
        assert torch.equal(y, x) and torch.equal(z, x)
        assert common.COLL_RECORD == []
    finally:
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# the profile
# ---------------------------------------------------------------------------

def test_profile_rows_are_tagged_by_model_function():
    cfg = dataclasses.replace(scaled_down(get_config("tinyllama-1.1b")),
                              quant_weights=False)
    model = Model(cfg)
    ps = T.param_struct(cfg, torch.float32)
    batch = {"tokens": _meta(2, 16, dtype=torch.int32)}
    rows = profile_step(lambda p, b: model.prefill(p, b, 32), ps, batch,
                        top=0)
    tags = {r["tag"] for r in rows}
    assert "layers._mm" in tags and "layers.apply_dense_ffn" in tags
    flash = [r for r in rows if r["op"] == "kernel:flash_attention"]
    assert flash and flash[0]["count"] == cfg.num_layers
    assert flash[0]["tag"] == "layers.apply_attention"
    assert all(r["bytes"] >= 0 for r in rows)


# ---------------------------------------------------------------------------
# kernels.cost against chip_smoke.py's own sums before it read them
# ---------------------------------------------------------------------------

HBM, FP32, TF32 = 3.35e12, 67e12, 495e12


def _old_bound(nbytes, flops, rate=None):
    t_b, t_f = nbytes / HBM, flops / (rate or FP32)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _old_pairs(sq, sk, causal, window, q_offset):
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    m = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        m &= kp <= qp
    if window:
        m &= (qp - kp) < window
    return int(m.sum())


# int4_matmul rows of PERF.md's kernel table: (M, K, N)
INT4_ROWS = [(4, 2048, 2048), (2, 4096, 14336), (2, 14336, 4096),
             (36, 4096, 14336), (512, 4096, 14336), (4, 2560, 10240),
             (4, 10240, 2560), (4, 4096, 12288), (4, 12288, 4096),
             (4, 7168, 1536), (4, 1536, 24576), (4, 7168, 576),
             (4, 16384, 7168), (4, 7168, 2048), (4, 2048, 7168),
             (1, 7168, 2048), (5, 7168, 2048), (4, 2048, 4096),
             (4, 2048, 256), (4, 2048, 64), (4, 4096, 2048),
             (400, 2048, 4096), (400, 2048, 256), (400, 2048, 64),
             (400, 4096, 2048), (4, 8192, 16384), (4, 16384, 8192),
             (4, 8192, 128), (4, 8192, 24576), (1, 24576, 8192),
             (4, 24576, 8192), (10, 24576, 8192), (18, 24576, 8192),
             (114, 24576, 8192)]
# flash_attention rows: (b, sq, sk, h, hkv, dh, causal, window, q_offset)
FLASH_ROWS = [(4, 128, 128, 32, 4, 64, True, 0, 0),
              (1, 1500, 1500, 8, 4, 256, True, 1024, 0),
              (1, 1016, 1016, 8, 4, 256, True, 1024, 0),
              (1, 114, 114, 8, 4, 256, True, 0, 0),
              (1, 114, 114, 128, 128, 192, True, 0, 0),
              (1, 114, 114, 64, 8, 128, True, 0, 0),
              (1, 1500, 1500, 8, 8, 64, False, 0, 0),
              (1, 48, 1500, 8, 8, 64, False, 0, 0),
              (1, 48, 48, 8, 8, 64, True, 0, 0),
              (1, 18, 114, 32, 8, 128, True, 0, 96),
              (1, 32, 96, 32, 8, 128, True, 0, 64)]
# decode_attention rows: (b, h, hkv, dh, pos, cache bytes)
DECODE_ROWS = [(4, 32, 4, 64, [159, 0, 77, 131], 4),
               (4, 8, 4, 256, [1023, 1023, 299, 113], 2),
               (4, 8, 4, 256, [1535, 1023, 299, 113], 2),
               (4, 64, 8, 128, [127, 57, 92, 113], 2),
               (4, 8, 8, 64, [1499] * 4, 2),
               (4, 8, 8, 64, [19, 39, 25, 30], 2)]
# decode_attention_int4 rows: (b, h, hkv, dh, pos, S, fresh)
INT4_KV_ROWS = [(4, 32, 4, 64, [159, 0, 77, 131], 160, True),
                (4, 32, 4, 64, [159, 0, 77, 131], 160, False),
                (4, 8, 4, 256, [2047, 1499, 299, 113], 2048, True)]


@pytest.mark.parametrize("M,K,N", INT4_ROWS)
def test_int4_cost_equals_chip_smoke_sums(M, K, N):
    G = 128
    nbytes = 4 * M * K + K * N // 2 + 4 * (K // G) * N + 4 * M * N
    flops = 2.0 * M * K * N
    c = cost.int4_matmul(M, K, N, G)
    assert (c.flops, c.nbytes) == (flops, nbytes)
    want = _old_bound(nbytes, 2 * flops, TF32) if M > 16 else \
        _old_bound(nbytes, flops)
    assert cost.int4_matmul_bound(M, K, N, G)[:2] == want


@pytest.mark.parametrize("row", FLASH_ROWS)
def test_flash_cost_equals_chip_smoke_sums(row):
    b, sq, sk, h, hkv, dh, causal, window, q_offset = row
    nbytes = 4 * (2 * b * sq * h * dh + 2 * b * sk * hkv * dh)
    flops = 4.0 * b * h * dh * _old_pairs(sq, sk, causal, window, q_offset)
    c = cost.flash_attention(*row)
    assert (c.flops, c.nbytes) == (flops, nbytes)
    assert cost.flash_attention_bound(*row)[:2] == _old_bound(
        nbytes, 3 * flops, TF32)


@pytest.mark.parametrize("row", DECODE_ROWS)
def test_decode_cost_equals_chip_smoke_sums(row):
    b, h, hkv, dh, pos, esize = row
    live = sum(p + 1 for p in pos)
    nbytes = 4 * 2 * b * h * dh + 2 * live * hkv * dh * esize + 4 * b
    c = cost.decode_attention(b, h, hkv, dh, live, esize)
    assert (c.flops, c.nbytes) == (4.0 * h * dh * live, nbytes)
    from repro_torch.kernels.decode_attention import live_rows
    assert live_rows(torch.tensor(pos), b, 1 << 20) == live


@pytest.mark.parametrize("row", INT4_KV_ROWS)
def test_decode_int4_cost_equals_chip_smoke_sums(row):
    b, h, hkv, dh, pos, S, fresh = row
    F, g = hkv * dh, 32
    hist = sum(min(p + (0 if fresh else 1), S) for p in pos)
    live = hist + (b if fresh else 0)
    nbytes = (4 * 2 * b * h * dh + 4 * b + 2 * hist * (F // 2 + 4 * (F // g))
              + (2 * 4 * b * F if fresh else 0))
    c = cost.decode_attention_int4(b, h, hkv, dh, hist, g, fresh)
    assert (c.flops, c.nbytes) == (4.0 * h * dh * live, nbytes)
