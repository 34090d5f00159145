"""Mamba2's SSD mixer in the port against the JAX package's functions, on
the same numpy-seeded inputs, at the scaled config (d 64, d_inner 128,
16 heads of 8, d_state 16, one group, chunk 32), on the CPU:

  * ``segsum``, ``ssd_chunked`` (chunks 1, 8, 32 and the whole length,
    with and without ``h_init``), ``ssd_sequential`` and
    ``ssd_decode_step`` against the JAX functions, and the chunked form
    against the JAX oracle;
  * ``_pick_chunk`` for every length 1-600, ``_causal_conv`` with and
    without a (bf16) halo, ``softplus``;
  * ``ssm_table`` and the layer tables, entry for entry;
  * ``apply_ssm`` prefill and decode against the JAX ``apply_ssm`` on
    the same parameters, at a prime length (chunk 1), a length above the
    chunk (40: chunk 20) and a multiple of it (64: two chunks), with f32
    and packed INT4 projections (the packed ones against the JAX
    function on the dequantized weights);
  * the cache struct (shapes, dtypes, kinds) against the JAX
    ``_layer_cache_shape`` at the scaled and the full widths, and
    ``init_cache``'s f32 state;
  * the SSM leaves in the KV store: ``"state"`` (f32) and ``"conv"``
    (bf16) store, load, spill and restore bit for bit for one slot and
    all slots, are never packed under ``kv_mode="int4"`` (jamba's
    attention layer is), and price the bytes the JAX store prices; a
    halo of one row fills every halo row and one of two rows raises, in
    both stores.

Tolerances: atol 2e-5 on every f32 path, the JAX suite's own for these
functions (``tests/test_ssm.py``, whose input scales the SSD inputs
take), and 2e-5 x max|ref| on a layer's output, which carries the
residual stream: the port runs the inter-chunk
recurrence as a loop over chunks where the reference runs
``lax.associative_scan``, and XLA's and PyTorch's cumsums and einsums
sum in different orders, so the two agree to rounding, not bit for bit.
Stored bytes are held bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.core import kvstore as JK  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import kvstore as PK  # noqa: E402
from repro_torch.core.offload import HostStore  # noqa: E402
from repro_torch.core.transfer import int4_group  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import ssm as PS  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.quant.int4 import dequantize_int4, quantize_int4  # noqa: E402

ATOL = 2e-5
ARCH = "mamba2-1.3b"
JC, PC = scaled_down(get_config(ARCH)), PB.scaled_down(port_config(ARCH))
S = JC.ssm
D_IN = S.expand * JC.d_model
H, HD, N = D_IN // S.head_dim, S.head_dim, S.d_state
CONV_CH = D_IN + 2 * S.n_groups * N


def _close(p, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), atol=atol,
                               rtol=0)


def _close_max(p, j):
    """Within 2e-5 x max(1, max|ref|): a layer's output carries the
    residual stream and its state sums over the prompt (up to about 20
    here), where f32 holds 2e-6."""
    j = np.asarray(j, np.float32)
    _close(p, j, ATOL * max(1.0, float(np.abs(j).max())))


def _ssd_inputs(seed, b=2, l=64, G=1, Hh=H):
    """Inputs at the JAX suite's scales (``tests/test_ssm.py::_inputs``:
    x 0.5, B and C 0.3, log(-A) 0.3, dt a softplus of a standard
    normal), from a numpy seed."""
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((b, l, Hh, HD)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, Hh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(Hh) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, l, G, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, l, G, N)) * 0.3).astype(np.float32)
    return xh, dt, A, B, C


def _h0(seed, b=2):
    return (np.random.default_rng(seed).standard_normal((b, H, HD, N))
            * 0.3).astype(np.float32)


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


# ---------------------------------------------------------------------------
# the SSD functions
# ---------------------------------------------------------------------------


def test_segsum_matches_reference():
    """The masked entries are -inf in both (so exp gives exact zeros);
    a run of large negative steps underflows to 0 without a NaN."""
    rng = np.random.default_rng(0)
    a = -np.abs(rng.standard_normal((3, 2, 32))).astype(np.float32)
    p = PS.segsum(torch.from_numpy(a)).numpy()
    j = np.asarray(JS.segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(p), np.isneginf(j))
    assert np.isneginf(p).sum() == 3 * 2 * 32 * 31 // 2
    fin = np.isfinite(j)
    np.testing.assert_allclose(p[fin], j[fin], rtol=0, atol=ATOL)
    e = torch.exp(PS.segsum(torch.from_numpy(a * 1e4))).numpy()
    assert not np.isnan(e).any() and (e[~fin] == 0).all()
    assert ((e >= 0) & (e <= 1)).all() and (e[fin] == 0).any()


@pytest.mark.parametrize("h_init", [False, True])
@pytest.mark.parametrize("chunk,G", [(1, 1), (8, 1), (32, 1), (64, 1),
                                     (32, 2)])
def test_ssd_chunked_matches_reference(chunk, G, h_init):
    """y, the final state, ``state_factor`` and ``total_decay`` against
    the JAX ``ssd_chunked`` at the same chunk, and y and the state
    against the JAX token-by-token oracle (atol 2e-5)."""
    arrs = _ssd_inputs(chunk + 10 * G, G=G)
    if h_init:
        arrs += (_h0(3),)
    (jx, jdt, jA, jB, jC, *jh), (px, pdt, pA, pB, pC, *ph) = _both(arrs)
    jy, jh_fin, (jsf, jtd) = JS.ssd_chunked(jx, jdt, jA, jB, jC, chunk,
                                            h_init=jh[0] if jh else None)
    py, ph_fin, (psf, ptd) = PS.ssd_chunked(px, pdt, pA, pB, pC, chunk,
                                            h_init=ph[0] if ph else None)
    for p, j in ((py, jy), (ph_fin, jh_fin), (psf, jsf), (ptd, jtd)):
        assert p.dtype == torch.float32 and tuple(p.shape) == j.shape
        _close(p, j)
    sy, sh = JS.ssd_sequential(jx, jdt, jA, jB, jC,
                               h_init=jh[0] if jh else None)
    _close(py, sy)
    _close(ph_fin, sh)


@pytest.mark.parametrize("h_init", [False, True])
def test_ssd_sequential_and_decode_step_match_reference(h_init):
    arrs = _ssd_inputs(21, l=9, G=2)
    h0 = _h0(4)
    (jx, jdt, jA, jB, jC), (px, pdt, pA, pB, pC) = _both(arrs)
    jy, jh = JS.ssd_sequential(jx, jdt, jA, jB, jC,
                               h_init=jnp.asarray(h0) if h_init else None)
    py, ph = PS.ssd_sequential(px, pdt, pA, pB, pC,
                               h_init=torch.from_numpy(h0) if h_init
                               else None)
    _close(py, jy)
    _close(ph, jh)
    # one step from h0, bf16 inputs computed in f32 in both
    args = [a[:, 3] if a.ndim > 1 else a for a in arrs]
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    pargs = [torch.from_numpy(np.ascontiguousarray(a)).bfloat16()
             for a in args]
    jy1, jh1 = JS.ssd_decode_step(jargs[0], jargs[1], jA, jargs[3], jargs[4],
                                  jnp.asarray(h0))
    py1, ph1 = PS.ssd_decode_step(pargs[0], pargs[1], pA, pargs[3], pargs[4],
                                  torch.from_numpy(h0))
    assert py1.dtype == ph1.dtype == torch.float32
    _close(py1, jy1)
    _close(ph1, jh1)


def test_ssd_chunked_rejects_a_ragged_chunk():
    arrs = _both(_ssd_inputs(1, l=10))[1]
    with pytest.raises(ValueError):
        PS.ssd_chunked(*arrs, 4)


# ---------------------------------------------------------------------------
# layer helpers and tables
# ---------------------------------------------------------------------------


def test_pick_chunk_matches_reference():
    for target in (32, 256):
        assert [PL._pick_chunk(n, target) for n in range(1, 601)] == \
            [JL._pick_chunk(n, target) for n in range(1, 601)]
    # a prime below the chunk is one chunk; above it, one chunk a token
    assert PL._pick_chunk(97, 256) == 97 and PL._pick_chunk(397, 256) == 1
    assert PL._pick_chunk(400, 256) == 200 and PL._pick_chunk(37, 32) == 1


@pytest.mark.parametrize("halo", [None, "f32", "bf16"])
def test_causal_conv_matches_reference(halo):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, CONV_CH)).astype(np.float32)
    w = rng.standard_normal((S.d_conv, CONV_CH)).astype(np.float32)
    b = rng.standard_normal(CONV_CH).astype(np.float32)
    hj = hp = None
    if halo:
        h = rng.standard_normal((2, S.d_conv - 1, CONV_CH)).astype(np.float32)
        hj = jnp.asarray(h).astype(jnp.bfloat16 if halo == "bf16"
                                   else jnp.float32)
        hp = torch.from_numpy(h).to(torch.bfloat16 if halo == "bf16"
                                    else torch.float32)
    want = JL._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), hj)
    got = PL._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), hp)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 1e-6)


def test_softplus_matches_reference():
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        [-100.0, 0.0, 100.0]]).astype(np.float32)
    _close(PL.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)),
           1e-6)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("scaled", [True, False])
def test_tables_match_reference(arch, scaled):
    """``ssm_table`` and every layer table, entry for entry (shape, axes,
    scale), at the scaled and the full widths."""
    jc, pc = get_config(arch), port_config(arch)
    if scaled:
        jc, pc = scaled_down(jc), PB.scaled_down(pc)
    jt, pt = JL.ssm_table(jc), PL.ssm_table(pc)
    assert list(jt) == list(pt)
    for n in jt:
        assert tuple(jt[n]) == tuple(pt[n]), n
    for jspec, pspec in zip(jc.pattern, pc.pattern):
        jt, pt = JL.layer_table(jc, jspec), PL.layer_table(pc, pspec)
        assert sorted(jt) == sorted(pt)
        for n in jt:
            assert tuple(jt[n]) == tuple(pt[n]), n
    if not scaled and arch == "mamba2-1.3b":
        t = PL.layer_table(pc, pc.pattern[0])
        assert t["dt_proj"].shape == (2048, 64)
        assert t["bc_proj"].shape == (2048, 256)
        assert t["conv_w"].shape == (4, 4096 + 256)
        assert "w_gate" not in t                  # d_ff 0: no FFN


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_int4_eligibility_of_ssm_tensors(arch):
    """At full width the five projections pack; ``conv_w`` (4, conv_ch)
    does not (gcd(4, 128) < 16), nor do the (H,) and (conv_ch,)
    vectors."""
    t = PL.ssm_table(port_config(arch))
    groups = {n: int4_group(np.empty(pd.shape, np.uint8))
              for n, pd in t.items()}
    for n in ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj"):
        assert groups[n] == 128, n
    for n in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "ssm_norm"):
        assert groups[n] is None, n


def test_init_params_draws_the_tables():
    p = PT.init_params(PC, 0)["pat"][0]
    assert p["A_log"].shape == (PC.num_periods, H)
    assert p["conv_w"].shape == (PC.num_periods, S.d_conv, CONV_CH)
    assert not p["conv_b"].any() and not p["ssm_norm"].any()
    assert p["D"].std() > 0.5                     # scale 1.0, not fan-in
    assert all(a.dtype == np.float32 for a in p.values())


# ---------------------------------------------------------------------------
# apply_ssm
# ---------------------------------------------------------------------------


def _weights(seed=5):
    """One (SSM, DENSE) layer's tensors from the JAX table, the zero-scale
    entries at 0.1 so that they act: (JAX params, port params)."""
    rng = np.random.default_rng(seed)
    tab = JL.layer_table(JC, JC.pattern[0])
    w = {n: (rng.standard_normal(pd.shape) * (
        0.1 if pd.scale == 0 else pd.scale if pd.scale > 0
        else 1 / np.sqrt(pd.shape[0]))).astype(np.float32)
         for n, pd in tab.items()}
    return ({n: jnp.asarray(a) for n, a in w.items()},
            {n: torch.from_numpy(a) for n, a in w.items()})


def _packed(pw):
    packed, deq = {}, {}
    for n, a in pw.items():
        g = int4_group(a)
        if g is None:
            packed[n] = deq[n] = a
            continue
        q, s = quantize_int4(a, g)
        packed[n + "#q"], packed[n + "#s"] = q, s
        deq[n] = dequantize_int4(q, s, torch.float32, g)
    return packed, {n: jnp.asarray(a.numpy()) for n, a in deq.items()}


def _apply(jw, pw, x, mode, jcache=None, pcache=None):
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode=mode,
                  batch_size=x.shape[0])
    jx, jnew = JL.apply_ssm(jw, jnp.asarray(x), jctx, jcache, JC.pattern[0])
    px, pnew = PL.apply_ssm(pw, torch.from_numpy(x),
                            PL.Ctx(cfg=PC, mode=mode), pcache, PC.pattern[0])
    return jx, jnew, px, pnew


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("l", [37, 40, 64])
def test_apply_ssm_prefill_and_decode_match_reference(l, packed):
    """Prefill at a prime length (chunk 1: one chunk a token), above the
    chunk (40: chunk 20) and at a multiple (64: two chunks of 32); then
    two decode steps over the prefill's halo rounded to bf16 (the
    stores' dtype) and its f32 state.  The halo rows within 2e-5, the
    output and the state (which sums over the prompt) within 2e-5 x max
    (``_close_max``); the decode's new halo is f32 in both."""
    jw, pw = _weights()
    if packed:
        pw, jw = _packed(pw)
        assert "z_proj#q" in pw and "dt_proj#q" in pw and "conv_w" in pw
    x = np.random.default_rng(l).standard_normal(
        (2, l, JC.d_model)).astype(np.float32)
    jx, jc, px, pc = _apply(jw, pw, x, "prefill")
    _close_max(px, jx)
    assert pc["conv"].shape == (2, S.d_conv - 1, CONV_CH)
    assert pc["state"].shape == (2, H, HD, N)
    assert pc["state"].dtype == torch.float32
    _close(pc["conv"], jc["conv"])
    _close_max(pc["state"], jc["state"])
    jc = {"conv": jc["conv"].astype(jnp.bfloat16), "state": jc["state"]}
    pc = {"conv": pc["conv"].bfloat16(), "state": pc["state"]}
    for step in range(2):
        xd = np.random.default_rng(100 + step).standard_normal(
            (2, 1, JC.d_model)).astype(np.float32)
        jx, jc, px, pc = _apply(jw, pw, xd, "decode", jc, pc)
        _close_max(px, jx)
        assert pc["conv"].dtype == torch.float32
        assert jc["conv"].dtype == jnp.float32
        _close(pc["conv"], jc["conv"])
        _close_max(pc["state"], jc["state"])


def test_apply_ssm_halo_of_a_short_prompt():
    """A prompt shorter than ``d_conv - 1`` gives as many halo rows as it
    has tokens, in both packages."""
    jw, pw = _weights()
    for l in (1, 2):
        x = np.random.default_rng(l).standard_normal(
            (1, l, JC.d_model)).astype(np.float32)
        _, jc, _, pc = _apply(jw, pw, x, "prefill")
        assert pc["conv"].shape == jc["conv"].shape == (1, l, CONV_CH)


# ---------------------------------------------------------------------------
# caches and the KV store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("scaled", [True, False])
def test_cache_struct_matches_reference(arch, scaled):
    jc, pc = get_config(arch), port_config(arch)
    if scaled:
        jc, pc = scaled_down(jc), PB.scaled_down(pc)
    for jspec, pspec in zip(jc.pattern, pc.pattern):
        want = JT._layer_cache_shape(jc, jspec, 4, 256)
        got = PT._layer_cache_shape(pc, pspec, 4, 256)
        assert list(got) == list(want)
        for n in want:
            (ws, wd, wk), (gs, gd, gk) = want[n], got[n]
            assert (tuple(gs), gk) == (tuple(ws), wk), n
            assert str(gd).split(".")[-1] == jnp.dtype(wd).name, n
    if not scaled and arch == "mamba2-1.3b":
        got = PT._layer_cache_shape(pc, pc.pattern[0], 4, 256)
        assert got["state"][0] == (4, 64, 64, 128)       # 8.39 MB at f32
        assert got["conv"][0] == (4, 3, 4096 + 256)


def test_init_cache_holds_an_f32_state():
    cache = PT.init_cache(PC, 2, 16, device="cpu")
    leaf = cache["pat"][0]
    assert leaf["state"].dtype == torch.float32
    assert leaf["conv"].dtype == torch.bfloat16
    assert leaf["state"].shape == (PC.num_periods, 2, H, HD, N)
    assert not leaf["state"].any()


def _unit_shapes(cfg, b, L):
    struct, kinds = PT.cache_struct(cfg, b, L)
    shapes = [{n: (s[1:], dt) for n, (s, dt) in t.items()}
              for t in struct["pat"]]
    return shapes, [dict(k) for k in kinds["pat"]]


def _jax_shapes(shapes):
    np_dt = {torch.bfloat16: jnp.bfloat16, torch.float32: np.float32}
    return [{n: (s, np_dt[dt]) for n, (s, dt) in t.items()} for t in shapes]


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_store_moves_ssm_leaves_bit_for_bit(kv_mode):
    """``state`` (f32) and ``conv`` (bf16) save, load, spill and restore
    bit for bit, one slot and all slots; neither is ever packed; the load
    and save bytes are the JAX store's."""
    b, L = 3, 16
    shapes, kinds = _unit_shapes(PC, b, L)
    st = PK.TieredKVStore(shapes, kinds, b_max=b, max_len=L, kv_mode=kv_mode,
                          device="cpu")
    jst = JK.TieredKVStore(_jax_shapes(shapes), kinds, b_max=b, max_len=L,
                           kv_mode=kv_mode)
    meta = st.leaf_meta(0)
    assert {n: (m.kind, m.quant) for n, m in meta.items()} == \
        {"conv": ("rep", False), "state": ("state", False)}
    assert meta["state"].dtype == torch.float32
    rng = np.random.default_rng(0)
    rows = {"conv": rng.standard_normal((3, CONV_CH)).astype(np.float32),
            "state": rng.standard_normal((H, HD, N)).astype(np.float32)}
    st.save_prefill(0, 1, {n: torch.from_numpy(a) for n, a in rows.items()})
    jst.save_prefill(0, 1, rows)
    got = st.load(0, 2, 5)
    want = jst.load(0, 2, 5)
    for n in rows:
        assert got[n].shape == (b,) + tuple(shapes[0][n][0][1:])
        np.testing.assert_array_equal(got[n].float().numpy()[:2],
                                      np.asarray(want[n], np.float32)[:2])
        assert not got[n][2:].any()
    np.testing.assert_array_equal(got["state"][1].numpy(), rows["state"])
    for lb in (1, 2, 3):
        assert st.load_nbytes(0, lb, 7) == jst.load_nbytes(0, lb, 7)
        assert st.save_nbytes(0, lb) == jst.save_nbytes(0, lb)
    assert st.load_nbytes(0, 3, 7) == 3 * (3 * CONV_CH * 2 + H * HD * N * 4)
    assert st.prefill_save_nbytes(0) == jst.prefill_save_nbytes(0)
    # a decode save of every slot, then spill and restore of one
    new = {"conv": torch.randn(b, 3, CONV_CH),
           "state": torch.randn(b, H, HD, N)}
    st.save_decode(0, new, [0, 1, 2], np.array([4, 5, 6]))
    host = HostStore()
    st.spill(host, "ns", 2)
    before = {n: st.load(0, 3, 1)[n].clone() for n in new}
    st.save_decode(0, {n: torch.zeros_like(t) for n, t in new.items()},
                   [2], np.zeros(b, np.int64))
    st.restore(host, "ns", 2)
    after = st.load(0, 3, 1)
    for n in new:
        assert torch.equal(after[n], before[n])
        assert torch.equal(after[n][2], new[n][2].to(after[n].dtype))


def test_jamba_store_packs_only_the_attention_layer():
    """Under ``kv_mode="int4"`` jamba's attention layer's ``k``/``v``
    rows pack (kind ``"kv"``) and its SSM layers' leaves stay whole, as
    in the JAX store; the host bytes are the JAX store's."""
    jc = scaled_down(get_config("jamba-1.5-large-398b"))
    pc = PB.scaled_down(port_config("jamba-1.5-large-398b"))
    shapes, kinds = _unit_shapes(pc, 2, 32)
    st = PK.TieredKVStore(shapes, kinds, b_max=2, max_len=32,
                          kv_mode="int4", device="cpu")
    jst = JK.TieredKVStore(_jax_shapes(shapes), kinds, b_max=2, max_len=32,
                           kv_mode="int4")
    quant = [sorted(n for n, m in st.leaf_meta(j).items() if m.quant)
             for j in range(len(st))]
    assert quant == [(["k", "v"] if s.mixer == PB.ATTN else [])
                     for s in pc.pattern]
    assert [s.mixer for s in jc.pattern] == [s.mixer for s in pc.pattern]
    assert st.host_nbytes() == jst.host_nbytes()
    for j in range(len(st)):
        assert st.load_nbytes(j, 2, 9) == jst.load_nbytes(j, 2, 9)
        assert st.save_nbytes(j, 2) == jst.save_nbytes(j, 2)


def test_short_halo_broadcasts_or_raises_as_in_reference():
    """A one-row halo fills all ``d_conv - 1`` halo rows and a two-row
    one raises ``ValueError``, in both stores (ROADMAP Queue 3 item 17)."""
    shapes, kinds = _unit_shapes(PC, 2, 8)
    st = PK.TieredKVStore(shapes, kinds, b_max=2, max_len=8, device="cpu")
    jst = JK.TieredKVStore(_jax_shapes(shapes), kinds, b_max=2, max_len=8)
    state = np.zeros((H, HD, N), np.float32)
    row = np.random.default_rng(0).standard_normal((1, CONV_CH)).astype(
        np.float32)
    st.save_prefill(0, 0, {"conv": torch.from_numpy(row),
                           "state": torch.from_numpy(state)})
    jst.save_prefill(0, 0, {"conv": row, "state": state})
    got = st.load(0, 1, 1)["conv"][0].float().numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jst.load(0, 1, 1)["conv"], np.float32)[0])
    assert (got == got[0]).all()
    two = np.zeros((2, CONV_CH), np.float32)
    with pytest.raises(ValueError):
        jst.save_prefill(0, 0, {"conv": two, "state": state})
    with pytest.raises(ValueError):
        st.save_prefill(0, 0, {"conv": torch.from_numpy(two),
                               "state": torch.from_numpy(state)})
    with pytest.raises(ValueError):
        PK.assign_rows(torch.zeros(3, 4), torch.zeros(2, 4))
    dst = torch.zeros(3, 4, dtype=torch.bfloat16)
    PK.assign_rows(dst, torch.full((1, 4), 1.5))
    assert (dst == 1.5).all()


def test_full_width_state_bytes():
    """At mamba2's full width and ``b_max`` 4 a layer's state is
    8,388,608 B (f32) and its halo 104,448 B (bf16) each way a step; at
    jamba's, 33,554,432 and 399,360."""
    for arch, state, conv in (("mamba2-1.3b", 8388608, 104448),
                              ("jamba-1.5-large-398b", 33554432, 399360)):
        cfg = port_config(arch)
        cfg = dataclasses.replace(cfg, num_layers=1, num_periods=0,
                                  remainder=cfg.pattern[:1])
        struct, kinds = PT.cache_struct(cfg, 4, 256)
        t = struct["rem"][0]
        nb = {n: int(np.prod(s)) * torch.empty(0, dtype=dt).element_size()
              for n, (s, dt) in t.items()}
        assert nb == {"conv": conv, "state": state}, arch
