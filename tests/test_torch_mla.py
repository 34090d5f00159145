"""DeepSeek-V3's multi-head latent attention (MLA) in the port against
the JAX package's functions, on the same numpy-seeded inputs, at the
scaled config (ranks 32/16, nope 8, rope 8, v 8; 4 heads), on the CPU:

  * ``mla_table`` and the layer tables (shapes, scales: ``w_uk``/``w_uv``
    are (r, h, n) at the latent rank's fan-in);
  * ``_angles`` at ``qk_rope_head_dim``;
  * ``mla_decode_attention`` with ragged positions, a dead row (a
    position below 0 attends nothing) and an int position, over f32 and
    bf16 caches;
  * ``mla_prefill_attention`` against ``mla_ring_attention(axis=None)``
    at 9 and 37 rows;
  * ``apply_mla`` prefill and decode, with f32 and packed INT4
    projections (the packed ones against the JAX function on the
    dequantized weights), decode over bf16 slabs and over packed rows;
  * the cache struct and ``init_cache``'s device default;
  * the latent rows in the KV store: INT4 packing of ``c``/``kr`` bit
    for bit the JAX store's, at the scaled and the full widths, and
    store, load, spill and restore by live rows.

Tolerances: f32 paths atol 2e-5 (as ``tests/test_torch_families.py``);
the rows written into bf16 caches, the packed bytes and scales bit for
bit; the decode over bf16 caches atol 2e-5 as well (both round the
probabilities and ``p . c`` to bf16 at the same places)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.core import kvstore as JK  # noqa: E402
from repro.core.offload import HostStore as JaxHostStore  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core import kvstore as PK  # noqa: E402
from repro_torch.core.offload import HostStore  # noqa: E402
from repro_torch.core.transfer import int4_group  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.quant.int4 import dequantize_int4, quantize_int4  # noqa: E402

ATOL = 2e-5
ARCH = "deepseek-v3-671b"
JC, PC = scaled_down(get_config(ARCH)), PB.scaled_down(port_config(ARCH))
M = JC.mla
H, R, DN, DR, DV = JC.num_heads, M.kv_lora_rank, M.qk_nope_head_dim, \
    M.qk_rope_head_dim, M.v_head_dim
SCALE = 1.0 / np.sqrt(DN + DR)
CDT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _weights(seed=5):
    """One MLA layer's tensors from the JAX table, the norms at scale 0.1
    so that they act: (JAX params, port params)."""
    rng = np.random.default_rng(seed)
    tab = JL.layer_table(JC, JC.pattern[0])
    w = {n: (rng.standard_normal(pd.shape) * (0.1 if pd.scale == 0 else
                                              1 / np.sqrt(pd.shape[0])))
         .astype(np.float32) for n, pd in tab.items()}
    return ({n: jnp.asarray(a) for n, a in w.items()},
            {n: torch.from_numpy(a) for n, a in w.items()})


def _packed(pw):
    """The INT4-eligible projections (``transfer.int4_group``) packed
    into ``name#q``/``name#s``, and the dequantized tree the JAX function
    runs on."""
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


def test_mla_table_matches_reference():
    jt, pt = JL.mla_table(JC), PL.mla_table(PC)
    assert sorted(jt) == sorted(pt)
    for n in jt:
        assert tuple(jt[n].shape) == tuple(pt[n].shape), n
        assert jt[n].scale == pt[n].scale, n
    assert pt["w_uk"].shape == (R, H, DN) and pt["w_uv"].shape == (R, H, DV)
    assert pt["wkv_a"].shape == (JC.d_model, R + DR)
    full = PL.mla_table(port_config(ARCH))
    assert full["w_uk"].shape == (512, 128, 128)
    assert full["wq_b"].shape == (1536, 128 * 192)
    # w_uk draws at the latent rank's fan-in: the table's leading dim
    w = PT._init_entry(np.random.default_rng(0), full["w_uk"], (512, 2, 4))
    assert abs(w.std() * np.sqrt(512) - 1) < 0.2


def test_layer_and_model_tables_match_reference():
    for jspec, pspec in zip(JC.pattern, PC.pattern):
        jt, pt = JL.layer_table(JC, jspec), PL.layer_table(PC, pspec)
        assert sorted(jt) == sorted(pt)
        for n in jt:
            assert tuple(jt[n].shape) == tuple(pt[n].shape), n
            assert jt[n].scale == pt[n].scale, n
    assert "ws_gate" in PL.layer_table(PC, PC.pattern[0])   # shared expert
    p = PT.init_params(PC, 0)
    assert p["pat"][0]["w_uk"].shape == (PC.num_periods, R, H, DN)
    assert p["pat"][0]["w_gate"].shape == (PC.num_periods, 4, 64, 64)


@pytest.mark.parametrize("positions", [[0, 3, 40], [[5], [0], [17]]])
def test_angles_at_rope_dim(positions):
    pos = np.array(positions, np.int32)
    want = np.asarray(JT._angles(JC, jnp.asarray(pos)))
    got = PT._angles(PC, torch.from_numpy(pos)).numpy()
    assert got.shape == pos.shape + (DR // 2,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_angles_refuse_mrope():
    """M-RoPE (qwen2-vl) no longer raises: ``_angles`` equals the JAX
    function's at a prompt's and at ragged decode positions."""
    jcfg = scaled_down(get_config("qwen2-vl-72b"))
    cfg = PB.scaled_down(port_config("qwen2-vl-72b"))
    for positions in ([0, 3, 40], [[5], [0], [17]]):
        pos = np.array(positions, np.int32)
        want = np.asarray(JT._angles(jcfg, jnp.asarray(pos)))
        got = PT._angles(cfg, torch.from_numpy(pos)).numpy()
        assert got.shape == pos.shape + (cfg.head_dim // 2,)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _decode_inputs(seed, b, S):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(b, 1, H, R), f(b, 1, H, DR), f(b, S, R), f(b, S, DR),
            f(b, 1, R), f(b, 1, DR))


@pytest.mark.parametrize("cdt", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [[3, 0, 17, 31], [5, -1, 9, 2], 12])
def test_mla_decode_attention_matches_reference(pos, cdt):
    """Ragged positions (one at 0, one at the slab's end), a dead row
    (-1: nothing to attend, zero output) and an int position: the latent
    context within 2e-5 and the updated caches bit for bit."""
    b, S = 4, 32
    q_eff, q_rope, c, kr, c_new, kr_new = _decode_inputs(13, b, S)
    jdt, pdt = CDT[cdt]
    jpos = jnp.asarray(np.array(pos, np.int32))
    ppos = (torch.from_numpy(np.array(pos, np.int32))
            if isinstance(pos, list) else pos)
    jctx, jc, jkr = JA.mla_decode_attention(
        jnp.asarray(q_eff), jnp.asarray(q_rope),
        jnp.asarray(c).astype(jdt), jnp.asarray(kr).astype(jdt),
        jnp.asarray(c_new), jnp.asarray(kr_new), jpos, scale=SCALE, axes=())
    pc = torch.from_numpy(c).to(pdt)
    pkr = torch.from_numpy(kr).to(pdt)
    pctx, pc2, pkr2 = PA.mla_decode_attention(
        torch.from_numpy(q_eff), torch.from_numpy(q_rope), pc, pkr,
        torch.from_numpy(c_new), torch.from_numpy(kr_new), ppos, scale=SCALE)
    assert pc2 is pc and pkr2 is pkr                # written in place
    assert pctx.shape == (b, 1, H, R) and pctx.dtype == torch.float32
    np.testing.assert_allclose(pctx.numpy(), np.asarray(jctx), atol=ATOL,
                               rtol=0)
    for got, want in ((pc, jc), (pkr, jkr)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    if isinstance(pos, list) and -1 in pos:
        assert (pctx[pos.index(-1)] == 0).all()


@pytest.mark.parametrize("s", [9, 37])
def test_mla_prefill_attention_matches_ring(s):
    """The expanded latent through ``flash_attention_op`` (V zero-padded
    from dv to dn + dr) against the JAX ``mla_ring_attention`` on one
    device."""
    rng = np.random.default_rng(s)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q, c, kr = f(2, s, H, DN + DR), f(2, s, R), f(2, s, DR)
    w_uk, w_uv = f(R, H, DN) / 4, f(R, H, DV) / 4
    want = JA.mla_ring_attention(*(jnp.asarray(a) for a in
                                   (q, c, kr, w_uk, w_uv)), axis=None)
    got = PA.mla_prefill_attention(*(torch.from_numpy(a) for a in
                                     (q, c, kr, w_uk, w_uv)))
    assert got.shape == (2, s, H, DV)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_mla_prefill_attention_refuses_wide_values():
    t = torch.zeros
    with pytest.raises(ValueError, match="v_head_dim"):
        PA.mla_prefill_attention(t(1, 3, 2, 8), t(1, 3, 4), t(1, 3, 4),
                                 t(4, 2, 4), t(4, 2, 9))


def _prefill(jw, pw, s, seed=6):
    x = np.random.default_rng(seed).standard_normal(
        (1, s, JC.d_model)).astype(np.float32)
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="prefill",
                  angles=JT._angles(JC, jnp.arange(s)), cache_len=64,
                  batch_size=1)
    jx, jcache = JL.apply_mla(jw, jnp.asarray(x), jctx, None, JC.pattern[0])
    pctx = PL.Ctx(cfg=PC, mode="prefill",
                  angles=PT._angles(PC, torch.arange(s)))
    px, pcache = PL.apply_mla(pw, torch.from_numpy(x), pctx, None,
                              PC.pattern[0])
    return jx, jcache, px, pcache


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("s", [9, 37])
def test_apply_mla_prefill_matches_reference(s, packed):
    """The expanded path and the latent rows it caches (the port ships
    the prompt's rows; the reference lays them into a zeroed slab)."""
    jw, pw = _weights()
    if packed:
        pw, jw = _packed(pw)
        assert "wq_b#q" in pw and "wkv_a#q" in pw and "w_uk" in pw
    jx, jcache, px, pcache = _prefill(jw, pw, s)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    assert pcache["c"].shape == (1, s, R) and pcache["kr"].shape == (1, s, DR)
    for n in ("c", "kr"):
        want = np.asarray(jcache[n])
        np.testing.assert_allclose(pcache[n].numpy(), want[:, :s], atol=ATOL,
                                   rtol=0)
        assert not want[:, s:].any()


def _decode(jw, pw, pos, jcache, pcache, seed=7):
    b = len(pos)
    pos = np.array(pos, np.int32)
    x = np.random.default_rng(seed).standard_normal(
        (b, 1, JC.d_model)).astype(np.float32)
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="decode",
                  angles=JT._angles(JC, jnp.asarray(pos)[:, None]),
                  pos=jnp.asarray(pos), batch_size=b)
    jx, jnew = JL.apply_mla(jw, jnp.asarray(x), jctx, jcache, JC.pattern[0])
    pp = torch.from_numpy(pos)
    pctx = PL.Ctx(cfg=PC, mode="decode", angles=PT._angles(PC, pp[:, None]),
                  pos=pp)
    px, prows = PL.apply_mla(pw, torch.from_numpy(x), pctx, pcache,
                             PC.pattern[0])
    return jx, jnew, px, prows


def _latent(seed, b, S):
    rng = np.random.default_rng(seed)
    return {"c": rng.standard_normal((b, S, R)).astype(np.float32),
            "kr": rng.standard_normal((b, S, DR)).astype(np.float32)}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pos", [[5, 0, 30], [31, 12, 1]])
def test_apply_mla_decode_matches_reference(pos, packed):
    """The absorbed path over a bf16 latent slab at ragged positions: the
    output within 2e-5; the step's fresh rows, bf16, bit for bit the
    rows the reference writes."""
    jw, pw = _weights()
    if packed:
        pw, jw = _packed(pw)
    lat = _latent(8, len(pos), 32)
    jcache = {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in lat.items()}
    pcache = {n: torch.from_numpy(a).bfloat16() for n, a in lat.items()}
    jx, jnew, px, prows = _decode(jw, pw, pos, jcache, pcache)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    b = len(pos)
    for n in ("c", "kr"):
        want = np.asarray(jnew[n], np.float32)[np.arange(b), pos][:, None]
        assert prows[n].dtype == torch.bfloat16
        assert prows[n].shape == (b, 1) + lat[n].shape[2:]
        np.testing.assert_array_equal(prows[n].float().numpy(), want)
        # the slab itself took the rows in place
        np.testing.assert_array_equal(
            pcache[n].float().numpy(), np.asarray(jnew[n], np.float32))


def test_apply_mla_decode_over_packed_rows():
    """Under ``kv_mode="int4"`` the offloaded engine hands the decode
    ``PackedRows``; they dequantize to the rows' compute dtype (bf16)
    first, which is what the JAX store's load gives its decode on the
    transfer thread: the same output as the JAX function over that
    dequantized slab."""
    jw, pw = _weights()
    pos = [7, 20, 3]
    lat = _latent(9, 3, 32)
    packed, jcache = {}, {}
    for n, a in lat.items():
        g = PK.kv_group(a.shape[-1])
        pq, ps = PK.quantize_kv_rows(torch.from_numpy(a).bfloat16(), g)
        packed[n] = PK.PackedRows(pq, ps, g, torch.bfloat16, a.shape[2:])
        jq, js = JK.quantize_kv_rows(np.asarray(
            jnp.asarray(a).astype(jnp.bfloat16)), g)
        jcache[n] = jnp.asarray(JK.dequantize_kv_rows(jq, js, g,
                                                      jnp.bfloat16))
    jx, jnew, px, prows = _decode(jw, pw, pos, jcache, packed)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    for n in ("c", "kr"):
        want = np.asarray(jnew[n], np.float32)[np.arange(3), pos][:, None]
        np.testing.assert_array_equal(prows[n].float().numpy(), want)


def test_apply_mla_decode_takes_one_row():
    _, pw = _weights()
    pctx = PL.Ctx(cfg=PC, mode="decode", angles=None, pos=3)
    cache = {"c": torch.zeros(1, 8, R), "kr": torch.zeros(1, 8, DR)}
    with pytest.raises(ValueError, match="one row"):
        PL.apply_mla(pw, torch.zeros(1, 2, PC.d_model), pctx, cache,
                     PC.pattern[0])


def test_apply_layer_routes_mla():
    """``apply_layer`` runs the MLA mixer and the MoE feed-forward with
    its shared expert; the same hidden states as the JAX layer on a whole
    drawn table (rtol 1e-5 besides atol 2e-5: the experts' 1/sqrt(E)
    draws put the states at magnitudes of about 50)."""
    tab = PT.table_params(PC, 0, "pat", 0, 0)
    jw = {n: jnp.asarray(a) for n, a in tab.items()}
    pw = {n: torch.from_numpy(a) for n, a in tab.items()}
    s = 11
    x = np.random.default_rng(3).standard_normal(
        (2, s, PC.d_model)).astype(np.float32)
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="prefill",
                  angles=JT._angles(JC, jnp.arange(s)), cache_len=32,
                  batch_size=2)
    jx, _, _ = JL.apply_layer(jw, jnp.asarray(x), jctx, None, JC.pattern[0])
    pctx = PL.Ctx(cfg=PC, mode="prefill",
                  angles=PT._angles(PC, torch.arange(s)))
    px, rows, _ = PL.apply_layer(pw, torch.from_numpy(x), pctx, None,
                              PC.pattern[0])
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL,
                               rtol=1e-5)
    assert sorted(rows) == ["c", "kr"]


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------


def test_cache_struct_matches_reference():
    jstruct, jkinds = JT.cache_struct(JC, 3, 96)
    pstruct, pkinds = PT.cache_struct(PC, 3, 96)
    assert pkinds == jkinds
    assert pkinds["pat"][0] == {"c": "kv", "kr": "kv"}
    for jt, pt in zip(jstruct["pat"], pstruct["pat"]):
        assert sorted(jt) == sorted(pt) == ["c", "kr"]
        for n in jt:
            assert tuple(jt[n].shape) == tuple(pt[n][0])
            assert pt[n][1] == torch.bfloat16
    assert pstruct["pat"][0]["c"][0] == (PC.num_periods, 3, 96, R)
    assert pstruct["pat"][0]["kr"][0] == (PC.num_periods, 3, 96, DR)
    full, _ = PT.cache_struct(port_config(ARCH), 1, 1)
    row = sum(np.prod(s[2:]) for s, _ in full["pat"][0].values())
    assert row == 576                                 # 1,152 B a token bf16
    caches = PT.init_cache(PC, 3, 96, device="cpu")
    assert caches["pat"][0]["c"].shape == (PC.num_periods, 3, 96, R)
    assert caches["pat"][0]["c"].dtype == torch.bfloat16


def test_init_cache_defaults_to_the_card():
    """``init_cache`` takes ``device="cuda"`` by default, as every entry
    point: without a card the call raises ``device.py``'s error instead of
    building the cache on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default builds there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        PT.init_cache(PC, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        build_model(PC).init_cache(1, 8)


def test_model_prefill_decode_match_reference():
    """The whole-model ``prefill`` (MLA + MoE with a shared expert, two
    periods) and three ragged ``decode_step``s on the JAX tree: the same
    tokens; the latent slabs equal after the prefill (atol 2e-5)."""
    from repro.models import build_model as jax_build_model
    jm = jax_build_model(JC)
    import jax
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    pp = PT.to_device(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(4).integers(0, JC.vocab_size,
                                               (2, 13)).astype(np.int32)
    jtok, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens)},
                              Dist.local(), 48)
    ptok, pcache = build_model(PC).prefill(
        pp, {"tokens": torch.from_numpy(tokens)}, 48)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    for n in ("c", "kr"):
        np.testing.assert_allclose(pcache["pat"][0][n].numpy(),
                                   np.asarray(jcache["pat"][0][n]),
                                   atol=ATOL, rtol=0)
    jc = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jcache)
    pc = {g: tuple({n: a.bfloat16() for n, a in t.items()}
                   for t in pcache[g]) for g in ("pat", "rem")}
    pos = np.array([13, 13], np.int32)
    jt_, pt_ = np.asarray(jtok), ptok
    for _ in range(3):
        jt_, jc = jm.decode_step(jp, {"token": jnp.asarray(jt_)[:, None],
                                      "pos": jnp.asarray(pos)}, jc,
                                 Dist.local())
        pt_, pc = build_model(PC).decode_step(
            pp, {"token": pt_[:, None], "pos": torch.from_numpy(pos)}, pc)
        np.testing.assert_array_equal(pt_.numpy(), np.asarray(jt_))
        pos = pos + 1


def _stores(kv_mode, b_max=3, max_len=40, full=False):
    cfg_j, cfg_p = ((get_config(ARCH), port_config(ARCH)) if full
                    else (JC, PC))
    js, jk = JT.cache_struct(cfg_j, b_max, max_len)
    ps, pk = PT.cache_struct(cfg_p, b_max, max_len)
    jshapes = [{n: (tuple(a.shape[1:]), a.dtype)
                for n, a in js["pat"][0].items()}] * 2
    pshapes = [{n: (s[1:], dt) for n, (s, dt) in ps["pat"][0].items()}] * 2
    kinds = [dict(pk["pat"][0])] * 2
    return (JK.TieredKVStore(jshapes, [dict(jk["pat"][0])] * 2,
                             b_max=b_max, max_len=max_len, kv_mode=kv_mode),
            PK.TieredKVStore(pshapes, kinds, b_max=b_max, max_len=max_len,
                             kv_mode=kv_mode, device="cpu"))


def _save(st, torch_side, seed=0, full=False):
    """A prefill into slot 1 (23 rows) and two decode steps of slots 0-2
    at ragged positions, on both units."""
    r, dr = (512, 64) if full else (R, DR)
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 10.0 ** rng.uniform(
        -2, 2, s[:-1] + (1,))).astype(np.float32)
    cvt = (lambda a: torch.from_numpy(a)) if torch_side else (lambda a: a)
    # the port's store takes the prompt's rows, the JAX one the slab
    pad = (lambda a: a) if torch_side else (
        lambda a: np.pad(a, ((0, st.max_len - len(a)), (0, 0))))
    for j in range(2):
        st.save_prefill(j, 1, {"c": cvt(pad(f(23, r))),
                               "kr": cvt(pad(f(23, dr)))})
    pos = np.array([4, 23, 9], np.int32)
    for t in range(2):
        rows = {"c": f(3, 1, r), "kr": f(3, 1, dr)}
        for j in range(2):
            st.save_decode(j, {n: cvt(a) for n, a in rows.items()},
                           [0, 1, 2], pos + t)


def _arrays(st, torch_side):
    out = []
    for j in range(len(st)):
        for n in ("c", "kr"):
            leaf = st._units[j][n]
            if torch_side:
                arrs = ((leaf.packed, leaf.scale)
                        if isinstance(leaf, PK._QuantLeaf) else (leaf,))
                out += [a.float().numpy() if a.dtype == torch.bfloat16
                        else a.numpy() for a in arrs]
            else:
                arrs = ((leaf.packed, leaf.scale)
                        if isinstance(leaf, JK._QuantLeaf) else (leaf.arr,))
                out += [np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else a for a in arrs]
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_latent_rows_store_like_reference(kv_mode, full):
    """``c`` (F = 16 scaled, 512 full) and ``kr`` (F = 8, 64) store as
    the JAX store's: groups ``kv_group(F)``, the packed bytes and scales
    (or the bf16 rows) bit for bit after the same saves, and the same
    byte accounting."""
    js, ps = _stores(kv_mode, full=full)
    _save(js, False, full=full)
    _save(ps, True, full=full)
    r, dr = (512, 64) if full else (R, DR)
    for j in range(2):
        for n, F in (("c", r), ("kr", dr)):
            pm, jm = ps.leaf_meta(j)[n], js.leaf_meta(j)[n]
            assert pm.quant == jm.quant == (kv_mode == "int4")
            assert pm.group == jm.group
            if kv_mode == "int4":
                assert pm.group == PK.kv_group(F) == min(F, 32)
    for a, b in zip(_arrays(ps, True), _arrays(js, False)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for lb, ll in ((1, 1), (2, 13), (3, 26), (None, None)):
        assert ps.load_nbytes(0, lb, ll) == js.load_nbytes(0, lb, ll)
        assert ps.dequant_nbytes(0, lb, ll) == js.dequant_nbytes(0, lb, ll)
    assert ps.save_nbytes(0, 3) == js.save_nbytes(0, 3)
    assert ps.prefill_save_nbytes(0) == js.prefill_save_nbytes(0)
    assert ps.host_nbytes() == js.host_nbytes()


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_latent_rows_load_by_live_rows(kv_mode):
    """A load ships the live slots' rows (packed under INT4, as
    ``PackedRows``); dequantized, they equal the JAX store's load, with
    zeros past the live extent."""
    js, ps = _stores(kv_mode)
    _save(js, False)
    _save(ps, True)
    lb, ll = 2, 26
    got, want = ps.load(0, lb, ll), js.load(0, lb, ll)
    for n in ("c", "kr"):
        rows = got[n]
        if kv_mode == "int4":
            assert isinstance(rows, PK.PackedRows)
            rows = rows.dequantize()
        assert rows.dtype == torch.bfloat16
        deq = rows.float().numpy()
        np.testing.assert_array_equal(
            deq[:lb, :ll], np.asarray(want[n], np.float32)[:lb, :ll])
        assert not deq[lb:].any() and not deq[:, ll:].any()
    assert ps.dequant_bytes_total == js.dequant_bytes_total


@pytest.mark.parametrize("kv_mode", ["fp32", "int4"])
def test_latent_rows_spill_restore(kv_mode):
    """A slot spilled (under the JAX store's keys), clobbered and restored
    is bit for bit what it was."""
    js, ps = _stores(kv_mode)
    _save(ps, True)
    _save(js, False)
    before = [a.copy() for a in _arrays(ps, True)]
    host, jhost = HostStore(), JaxHostStore()
    ps.spill(host, "e1/slot1", 1)
    js.spill(jhost, "e1/slot1", 1)
    assert sorted(host.keys()) == sorted(jhost.keys())
    for j in range(2):
        ps.save_prefill(j, 1, {"c": torch.ones(40, R),
                               "kr": torch.ones(40, DR)})
    assert any(not np.array_equal(a, b)
               for a, b in zip(_arrays(ps, True), before))
    ps.restore(host, "e1/slot1", 1)
    for a, b in zip(_arrays(ps, True), before):
        np.testing.assert_array_equal(_bits(a), _bits(b))
