"""The layer functions of Qwen3 (``qk_norm``) and Gemma 3 (sliding-window
``ATTN_LOCAL`` layers, a rolling KV buffer) in the port against their JAX
twins, on the same numpy-seeded inputs, at the scaled configs (head_dim
16, Gemma 3's window 64), on the CPU:

  * ``apply_attention`` with ``qk_norm`` (prefill and ragged decode) and
    with a window (a prefill longer than it, a decode over the buffer);
  * ``_build_cache`` with a window, prompts shorter and longer than W;
  * ``local_decode_attention`` with ragged positions on both sides of W
    (and an int position), the identity its kernel route rests on
    (``decode_attention`` over the buffer at ``min(pos, W - 1)``), and
    the sliding-window attention it computes over the full history;
  * ``apply_layer_chunk`` with ``qk_norm``;
  * the parameter tables and ``cache_struct``;
  * the whole-model ``prefill``/``decode_step`` on the JAX tree.

Tolerances: f32 paths atol 2e-5 (as ``tests/test_torch_serving.py``);
the rows written into bf16 caches equal bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ATOL = 2e-5
CFGS = {a: (scaled_down(get_config(a)), PB.scaled_down(port_config(a)))
        for a in ("qwen3-8b", "gemma3-4b")}
W = CFGS["gemma3-4b"][0].window


def _specs(arch):
    """(JAX spec, port spec) of the arch's first layer: qwen3's global
    attention, gemma3's sliding window."""
    jc, pc = CFGS[arch]
    return jc.pattern[0], pc.pattern[0]


def _weights(arch, seed=5):
    """One layer's tensors from its JAX table, norms at scale 0.1 so that
    ``q_norm``/``k_norm`` act: (JAX params, port params)."""
    jc, _ = CFGS[arch]
    rng = np.random.default_rng(seed)
    tab = JL.layer_table(jc, jc.pattern[0])
    w = {n: (rng.standard_normal(pd.shape) * (0.1 if pd.scale == 0 else
                                              1 / np.sqrt(pd.shape[0])))
         .astype(np.float32) for n, pd in tab.items()}
    return ({n: jnp.asarray(a) for n, a in w.items()},
            {n: torch.from_numpy(a) for n, a in w.items()})


def _x(rng, b, s, d=64):
    return rng.standard_normal((b, s, d)).astype(np.float32)


def test_tables_match_reference():
    """``q_norm``/``k_norm`` (dh,) zeros under ``qk_norm``; both archs'
    layer tables and the model tables name the JAX package's tensors at
    its shapes and scales."""
    for arch, (jc, pc) in CFGS.items():
        for jspec, pspec in zip(jc.pattern + jc.remainder,
                                pc.pattern + pc.remainder):
            jt, pt = JL.layer_table(jc, jspec), PL.layer_table(pc, pspec)
            assert sorted(jt) == sorted(pt), arch
            for n in jt:
                assert tuple(jt[n].shape) == tuple(pt[n].shape), (arch, n)
                assert jt[n].scale == pt[n].scale, (arch, n)
        assert ("q_norm" in PL.attn_table(pc)) == (arch == "qwen3-8b")
    pc = CFGS["qwen3-8b"][1]
    assert PL.attn_table(pc)["q_norm"] == PL.ParamDef((16,), (None,), 0.0)
    p = PT.init_params(pc, 0)
    assert p["pat"][0]["k_norm"].shape == (pc.num_periods, 16)
    assert not p["pat"][0]["k_norm"].any()


def test_dense_only_names_what_is_still_unported():
    """Whisper's CROSS and ENC layers now build, their tables equal to
    the JAX package's; resident INT4 tables (``quant_weights``) build
    too since the tooling slice, qwen3's (with ``qk_norm``) equal to the
    JAX package's: nothing of a registry arch is left unported."""
    for arch in ("whisper-base",):
        jc = scaled_down(get_config(arch))
        cfg = PB.scaled_down(port_config(arch))
        for jspec, spec in ((jc.pattern[0], cfg.pattern[0]),
                            (JT.LayerSpec(JT.ENC, JT.DENSE),
                             PB.LayerSpec(PB.ENC, PB.DENSE))):
            jt, pt = JL.layer_table(jc, jspec), PL.layer_table(cfg, spec)
            assert sorted(jt) == sorted(pt), spec
            for n in jt:
                assert tuple(jt[n].shape) == tuple(pt[n].shape), (spec, n)
                assert jt[n].scale == pt[n].scale, (spec, n)
        assert "cwq" in PL.layer_table(cfg, cfg.pattern[0])
    jc, pc = CFGS["qwen3-8b"]
    wide = dict(d_model=256, num_heads=4, head_dim=64, quant_weights=True)
    jt = JL.layer_table(dataclasses.replace(jc, **wide), jc.pattern[0])
    pt = PL.layer_table(dataclasses.replace(pc, **wide), pc.pattern[0])
    assert sorted(pt) == sorted(jt) and "wq#q" in pt and "q_norm" in pt
    for n in jt:
        assert tuple(jt[n].shape) == tuple(pt[n].shape), n
        assert jt[n].scale == pt[n].scale, n


@pytest.mark.parametrize("arch,s", [("qwen3-8b", 9), ("gemma3-4b", 9),
                                    ("gemma3-4b", 80)])
def test_apply_attention_prefill_matches_reference(arch, s):
    """``qk_norm`` before rope (qwen3); the flash window (gemma3, binding
    at 80 rows > W) and the rolling buffer the prefill returns."""
    jc, pc = CFGS[arch]
    jspec, pspec = _specs(arch)
    jw, pw = _weights(arch)
    x = _x(np.random.default_rng(6), 1, s)
    jctx = JL.Ctx(cfg=jc, dist=Dist.local(), mode="prefill",
                  angles=JT._angles(jc, jnp.arange(s)), cache_len=96,
                  batch_size=1)
    jx, jcache = JL.apply_attention(jw, jnp.asarray(x), jctx, None, jspec)
    pctx = PL.Ctx(cfg=pc, mode="prefill",
                  angles=PT._angles(pc, torch.arange(s)))
    px, pcache = PL.apply_attention(pw, torch.from_numpy(x), pctx, None,
                                    pspec)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    for n in ("k", "v"):
        want = np.asarray(jcache[n])
        got = pcache[n].numpy()
        if arch == "qwen3-8b":          # the port ships the prompt's rows
            want = want[:, :s]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch,pos", [("qwen3-8b", [5, 0, 30]),
                                      ("gemma3-4b", [5, 63, 64]),
                                      ("gemma3-4b", [0, 130, 200])])
def test_apply_attention_decode_matches_reference(arch, pos):
    """A ragged decode step over a bf16 cache: qwen3's ``max_len`` slab,
    gemma3's rolling buffer (positions before, at and past the wrap).
    The output within 2e-5; the written rows (gemma3: the whole updated
    buffer) bit for bit."""
    jc, pc = CFGS[arch]
    jspec, pspec = _specs(arch)
    jw, pw = _weights(arch)
    rng = np.random.default_rng(7)
    b, hkv, dh = len(pos), jc.num_kv_heads, jc.head_dim
    S = W if arch == "gemma3-4b" else 32
    pos = np.array(pos, np.int32)
    x = _x(rng, b, 1)
    cache = {n: rng.standard_normal((b, S, hkv, dh)).astype(np.float32)
             for n in ("k", "v")}
    jcache = {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in cache.items()}
    pcache = {n: torch.from_numpy(a).bfloat16() for n, a in cache.items()}
    jctx = JL.Ctx(cfg=jc, dist=Dist.local(), mode="decode",
                  angles=JT._angles(jc, jnp.asarray(pos)[:, None]),
                  pos=jnp.asarray(pos), batch_size=b)
    jx, jnew = JL.apply_attention(jw, jnp.asarray(x), jctx, jcache, jspec)
    pp = torch.from_numpy(pos)
    pctx = PL.Ctx(cfg=pc, mode="decode", angles=PT._angles(pc, pp[:, None]),
                  pos=pp)
    px, prows = PL.apply_attention(pw, torch.from_numpy(x), pctx, pcache,
                                   pspec)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    for n in ("k", "v"):
        want = np.asarray(jnew[n], np.float32)
        if arch == "qwen3-8b":
            want = want[np.arange(b), pos][:, None]
        assert prows[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(prows[n].float().numpy(), want)


@pytest.mark.parametrize("s", [20, 63, 64, 65, 100, 128, 130])
def test_build_cache_window_matches_reference(s):
    """Shorter than W: zero-padded to W rows; longer: slot j holds the
    latest position p < s with p % W == j."""
    jc, pc = CFGS["gemma3-4b"]
    rng = np.random.default_rng(s)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    jctx = JL.Ctx(cfg=jc, dist=Dist.local(), mode="prefill", cache_len=256)
    want = JL._build_cache(jnp.asarray(k), jnp.asarray(v), jctx, W)
    got = PL._build_cache(torch.from_numpy(k), torch.from_numpy(v),
                          PL.Ctx(cfg=pc, mode="prefill"), W)
    for n, a in (("k", k), ("v", v)):
        assert got[n].shape == (2, W, 2, 16)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        for j in range(W):
            p = s - W + (j - s % W) % W if s >= W else j
            expect = a[:, p] if p < s else np.zeros_like(a[:, 0])
            np.testing.assert_array_equal(got[n][:, j].numpy(), expect)


@pytest.mark.parametrize("pos,cdt", [([3, 63, 64, 150], torch.bfloat16),
                                     ([0, 1, 127, 64], torch.float32),
                                     (70, torch.bfloat16),
                                     (12, torch.float32)])
def test_local_decode_attention_matches_reference(pos, cdt):
    """Ragged positions before, at and past W (and an int position):
    the output and the updated buffers against the JAX function; and
    the identity the kernel route rests on, ``decode_attention`` over
    the updated buffer at ``min(pos, W - 1)``, bit for bit."""
    rng = np.random.default_rng(11)
    b = len(pos) if isinstance(pos, list) else 2
    h, hkv, dh = 8, 4, 16
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, W, hkv, dh)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((b, 1, hkv, dh)).astype(np.float32)
              for _ in range(2))
    jdt = jnp.bfloat16 if cdt == torch.bfloat16 else jnp.float32
    jpos = jnp.asarray(np.array(pos, np.int32))
    jo, jk, jv = JA.local_decode_attention(
        jnp.asarray(q), jnp.asarray(kc).astype(jdt),
        jnp.asarray(vc).astype(jdt), jnp.asarray(kn), jnp.asarray(vn), jpos,
        W)
    ppos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) \
        else pos
    pk, pv = torch.from_numpy(kc).to(cdt), torch.from_numpy(vc).to(cdt)
    po, pk2, pv2 = PA.local_decode_attention(
        torch.from_numpy(q), pk, pv, torch.from_numpy(kn),
        torch.from_numpy(vn), ppos, W)
    assert pk2.data_ptr() == pk.data_ptr()          # updated in place
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pk2.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(pv2.float().numpy(),
                                  np.asarray(jv, np.float32))
    clamped = (torch.clamp(ppos, max=W - 1) if isinstance(ppos, torch.Tensor)
               else min(ppos, W - 1))
    twin = R.decode_attention_ref(torch.from_numpy(q)[:, 0], pk2, pv2,
                                  clamped)
    assert torch.equal(po[:, 0], twin)


@pytest.mark.parametrize("pos", [[10, 63, 64, 99]])
def test_local_decode_is_sliding_window_attention(pos):
    """Over a full f32 history of T positions: the rolling buffer built by
    ``_build_cache`` from the first ``pos`` rows, then one
    ``local_decode_attention`` step at ``pos``, equals attention at
    ``pos`` over the last W positions of the history (atol 2e-5)."""
    rng = np.random.default_rng(3)
    h, hkv, dh, T = 4, 2, 16, 100
    pc = CFGS["gemma3-4b"][1]
    for r, p in enumerate(pos):
        k, v = (torch.from_numpy(rng.standard_normal(
            (1, T, hkv, dh)).astype(np.float32)) for _ in range(2))
        q = torch.from_numpy(rng.standard_normal(
            (1, 1, h, dh)).astype(np.float32))
        buf = PL._build_cache(k[:, :p], v[:, :p],
                              PL.Ctx(cfg=pc, mode="prefill"), W) \
            if p else {"k": torch.zeros(1, W, hkv, dh),
                       "v": torch.zeros(1, W, hkv, dh)}
        out, _, _ = PA.local_decode_attention(
            q, buf["k"].clone(), buf["v"].clone(), k[:, p:p + 1],
            v[:, p:p + 1], torch.tensor([p], dtype=torch.int32), W)
        want = R.ref_attention(q, k[:, :p + 1], v[:, :p + 1], causal=True,
                               window=W, q_offset=p)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("c0,c", [(0, 5), (5, 3), (8, 1)])
def test_apply_layer_chunk_qk_norm_matches_reference(c0, c):
    jc, pc = CFGS["qwen3-8b"]
    jw, pw = _weights("qwen3-8b")
    # the whole layer: the feed-forward's tensors too
    rng = np.random.default_rng(6 + c0)
    x = _x(rng, 1, c)
    hkv, dh = jc.num_kv_heads, jc.head_dim
    pk = rng.standard_normal((1, c0, hkv, dh)).astype(np.float32)
    pv = rng.standard_normal((1, c0, hkv, dh)).astype(np.float32)
    jctx = JL.Ctx(cfg=jc, dist=Dist.local(), mode="prefill",
                  angles=JT._angles(jc, jnp.arange(c0, c0 + c)),
                  batch_size=1)
    jx, jk, jv = JL.apply_layer_chunk(
        jw, jnp.asarray(x), jctx, jnp.asarray(pk) if c0 else None,
        jnp.asarray(pv) if c0 else None, c0)
    pctx = PL.Ctx(cfg=pc, mode="prefill",
                  angles=PT._angles(pc, torch.arange(c0, c0 + c)))
    px, k, v = PL.apply_layer_chunk(
        pw, torch.from_numpy(x), pctx, torch.from_numpy(pk) if c0 else None,
        torch.from_numpy(pv) if c0 else None, c0)
    for a, b in ((px, jx), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen3-8b"])
def test_cache_struct_matches_reference(arch):
    """Shapes, dtypes and kinds: ``(b, W, hkv, dh)`` bf16 ``"rep"`` for a
    sliding-window layer beside the ``max_len`` ``"kv"`` slabs."""
    jc, pc = CFGS[arch]
    jstruct, jkinds = JT.cache_struct(jc, 3, 96)
    pstruct, pkinds = PT.cache_struct(pc, 3, 96)
    assert pkinds == jax.tree.map(lambda k: k, jkinds)
    for grp in ("pat", "rem"):
        for jt, pt in zip(jstruct[grp], pstruct[grp]):
            assert sorted(jt) == sorted(pt)
            for n in jt:
                assert tuple(jt[n].shape) == tuple(pt[n][0])
                assert pt[n][1] == torch.bfloat16 and \
                    jt[n].dtype == jnp.bfloat16
    if arch == "gemma3-4b":
        assert pkinds["pat"][0] == {"k": "rep", "v": "rep"}
        assert pstruct["pat"][0]["k"][0] == (jc.num_periods, 3, W, 2, 16)
        assert pstruct["pat"][-1]["k"][0] == (jc.num_periods, 3, 96, 2, 16)
    caches = PT.init_cache(pc, 3, 96, device="cpu")
    for grp in ("pat", "rem"):
        for ct, st in zip(caches[grp], pstruct[grp]):
            assert ct["k"].shape == st["k"][0]


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen3-8b"])
def test_model_prefill_decode_match_reference(arch):
    """The whole-model ``prefill`` (a prompt past the window) and three
    ragged ``decode_step``s on the JAX tree: the same tokens; the caches'
    rolling buffers and slabs equal after the prefill (atol 2e-5 at f32)."""
    jc, pc = CFGS[arch]
    params = jax.tree.map(np.asarray, JT.init_params(
        jc, jax.random.PRNGKey(0), jnp.float32))
    prompt = np.random.default_rng(4).integers(
        0, jc.vocab_size, (2, 70)).astype(np.int32)
    jtok, jcache = JT.prefill(jax.tree.map(jnp.asarray, params),
                              {"tokens": jnp.asarray(prompt)}, jc,
                              Dist.local(), 96)
    pparams = PT.to_device(params, "cpu")
    ptok, pcache = PT.prefill(pparams, {"tokens": torch.from_numpy(prompt)},
                              pc, 96)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    for grp in ("pat", "rem"):
        for jt, pt in zip(jcache[grp], pcache[grp]):
            for n in jt:
                np.testing.assert_allclose(pt[n].numpy(),
                                           np.asarray(jt[n], np.float32),
                                           atol=ATOL, rtol=0)
    # decode over bf16 caches at ragged positions, wrapping the buffer
    jc16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                        jcache)
    pc16 = {g: tuple({n: a.bfloat16() for n, a in t.items()}
                     for t in pcache[g]) for g in ("pat", "rem")}
    jt_, pt_ = np.asarray(jtok), ptok
    for step in range(3):
        pos = np.array([70 + step, 60 + step], np.int32)
        jt_, jc16 = JT.decode_step(
            jax.tree.map(jnp.asarray, params),
            {"token": jnp.asarray(jt_)[:, None], "pos": jnp.asarray(pos)},
            jc16, jc, Dist.local())
        pt_, pc16 = PT.decode_step(
            pparams, {"token": pt_[:, None].long(),
                      "pos": torch.from_numpy(pos)}, pc16, pc)
        np.testing.assert_array_equal(pt_.numpy(), np.asarray(jt_))


def test_quant_roundtrip_params_on_tensors():
    """``core.convert.quant_roundtrip_params`` on a tree of tensors (what
    the resident engine holds on its device) equals it on the numpy
    tree, leaf for leaf, ``q_norm``/``k_norm`` and norms untouched."""
    from repro_torch.core.convert import quant_roundtrip_params
    pc = dataclasses.replace(CFGS["qwen3-8b"][1], d_model=128, d_ff=256)
    tree = PT.init_params(pc, 1)
    want = quant_roundtrip_params(pc, tree)
    got = quant_roundtrip_params(pc, PT.to_device(tree, "cpu"))
    for grp in ("pat", "rem"):
        for wt, gt, t in zip(want[grp], got[grp], tree[grp]):
            for n in wt:
                assert isinstance(gt[n], torch.Tensor)
                np.testing.assert_array_equal(gt[n].numpy(), wt[n])
            assert not np.array_equal(wt["wq"], t["wq"])
            np.testing.assert_array_equal(wt["q_norm"], t["q_norm"])
