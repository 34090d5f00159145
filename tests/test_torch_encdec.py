"""Whisper's encoder-decoder in the port against the JAX package, on the
CPU at the scaled config (2 encoder and 2 decoder layers, 24 frames, d
64, 4 heads of 16, ``rope_theta`` 0), on the same numpy-seeded inputs:

  * the tables (``ENC`` as ``ATTN``; ``CROSS`` with ``cwq``/``cwk``/
    ``cwv``/``cwo`` and ``norm_cross``), the ``"enc"`` subtree of
    ``init_params`` and ``cache_struct``'s ``ck``/``cv`` rows;
  * ``sinusoidal_positions`` and the decode rows at ragged positions;
  * ``_encode`` (f32, atol 1e-5 x max);
  * ``apply_cross_layer`` at prefill (hidden states and all four cache
    leaves, atol 1e-5 x max) and at decode over bf16 caches (hidden
    states 2e-2 x max, ``ck``/``cv`` passed through unchanged), and
    ``cross_decode_attention``'s plain version against the reference's
    ``ref_attention`` over bf16 rows;
  * the whole-model ``prefill`` and ``decode_step`` at ragged positions,
    with frames and with the zero stub: hidden states within 1e-4 x max
    (f32 prefill) and 2e-2 x max (decode over bf16 caches), equal next
    tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rope as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import rope as PR  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

JC = scaled_down(get_config("whisper-base"))
PC = PB.scaled_down(port_config("whisper-base"))
H, HKV, DH, D = PC.num_heads, PC.num_kv_heads, PC.head_dim, PC.d_model
S_ENC = PC.encoder_seq_len
BF16_REL = 2e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _tree(seed=0):
    """The JAX model's f32 tree (numpy leaves), with every zero-scale
    norm drawn at 0.1 so that the norms act: (JAX tree, port tree)."""
    tree = jax.tree.map(np.asarray,
                        JT.init_params(JC, jax.random.PRNGKey(seed),
                                       jnp.float32))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                   if not a.any() else a), tree)
    return (jax.tree.map(jnp.asarray, tree),
            PT.to_device(jax.tree.map(np.array, tree), "cpu"))


def _layer(tree, q=0, p=0):
    return {n: t[p] for n, t in tree["pat"][q].items()}


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# tables, init, caches
# ---------------------------------------------------------------------------


def test_tables_and_init_match_reference():
    """Every table (the encoder's included) names the JAX tensors at its
    shapes and scales; ``init_params`` has the JAX tree's structure and
    shapes, the encoder stacked over ``num_encoder_layers``."""
    jt, pt = JT.model_tables(JC), PT.model_tables(PC)
    pairs = ([(jt["pat"][0], pt["pat"][0]), (jt["embed"], pt["embed"]),
              (jt["enc"]["pat"][0], pt["enc"]["pat"][0]),
              (jt["enc"]["final_norm"], pt["enc"]["final_norm"])])
    for a, b in pairs:
        assert sorted(a) == sorted(b)
        for n in a:
            assert tuple(a[n].shape) == tuple(b[n].shape), n
            assert a[n].scale == b[n].scale, n
    cross = pt["pat"][0]
    assert {"cwq", "cwk", "cwv", "cwo", "norm_cross"} <= set(cross)
    assert sorted(PL.layer_table(PC, PB.LayerSpec(PB.ENC, PB.DENSE))) == \
        sorted(PL.layer_table(PC, PB.LayerSpec(PB.ATTN, PB.DENSE)))
    jp = JT.init_params(JC, jax.random.PRNGKey(0), jnp.float32)
    pp = PT.init_params(PC, 0)
    jl, jdef = jax.tree_util.tree_flatten_with_path(jp)
    pl, pdef = jax.tree_util.tree_flatten_with_path(pp)
    assert [k for k, _ in jl] == [k for k, _ in pl]
    assert [a.shape for _, a in jl] == [a.shape for _, a in pl]
    assert pp["enc"]["pat"][0]["wq"].shape == (JC.num_encoder_layers, D,
                                               H * DH)
    # the encoder's layers draw apart
    assert not np.array_equal(pp["enc"]["pat"][0]["wq"][0],
                              pp["enc"]["pat"][0]["wq"][1])


@pytest.mark.parametrize("enc_len", [None, 10])
def test_cache_struct_matches_reference(enc_len):
    js, jk = JT.cache_struct(JC, 3, 32, enc_len)
    ps, pk = PT.cache_struct(PC, 3, 32, enc_len)
    assert jk == {g: tuple(t) for g, t in pk.items()}
    for g in ("pat", "rem"):
        for jt_, pt_ in zip(js[g], ps[g]):
            assert {n: tuple(s.shape) for n, s in jt_.items()} == \
                {n: tuple(s) for n, (s, _) in pt_.items()}
    c = PT.init_cache(PC, 3, 32, "cpu", enc_len)
    assert c["pat"][0]["ck"].shape == (PC.num_periods, 3, enc_len or S_ENC,
                                       HKV, DH)
    assert c["pat"][0]["ck"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(24, 64), (448, 512), (1500, 512)])
def test_sinusoidal_positions_match_reference(n, d):
    want = np.asarray(JR.sinusoidal_positions(n, d))
    got = PR.sinusoidal_positions(n, d).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pos = torch.tensor([0, n - 1, n // 3, 7])
    assert torch.equal(PR.sinusoidal_rows(pos, d),
                       PR.sinusoidal_positions(n, d)[pos])


@pytest.mark.parametrize("pos", [[9, 0, 31], 17])
def test_decode_inputs_add_the_rows_at_pos(pos):
    """``_inputs_to_x`` at decode: the table row at each ragged position
    (or at the int position), as the reference's ``take`` /
    ``dynamic_slice`` of its ``max_seq_len`` table."""
    jp, pp = _tree()
    rng = np.random.default_rng(3)
    tok = rng.integers(0, PC.vocab_size, (3, 1)).astype(np.int32)
    jpos = jnp.asarray(np.array(pos, np.int32))
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="decode", pos=jpos,
                  batch_size=3)
    want = JT._inputs_to_x(jp, JC, jctx, {"token": jnp.asarray(tok)})
    ppos = torch.tensor(pos) if isinstance(pos, list) else pos
    pctx = PL.Ctx(cfg=PC, mode="decode", pos=ppos)
    got = PT._inputs_to_x(pp, PC, pctx, {"token": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2])
def test_encode_matches_reference(b):
    jp, pp = _tree()
    enc = _f(np.random.default_rng(11), b, S_ENC, D)
    want = np.asarray(JT._encode(jp, JC, Dist.local(), jnp.asarray(enc),
                                 "prefill"))
    got = PT._encode(pp, PC, torch.from_numpy(enc)).numpy()
    assert got.shape == (b, S_ENC, D)
    assert _rel(got, want) <= 1e-5


def test_encoder_layer_is_bidirectional_without_rope():
    """An ENC layer attends every row: the first row's output changes
    when the last frame does (it would not under a causal mask)."""
    _, pp = _tree()
    enc = _f(np.random.default_rng(12), 1, S_ENC, D)
    ctx = PL.Ctx(cfg=PC, mode="prefill", is_encoder=True,
                 angles=PT._angles(PC, torch.arange(S_ENC)))
    spec = PB.LayerSpec(PB.ENC, PB.DENSE)
    w = {n: t[0] for n, t in pp["enc"]["pat"][0].items()}
    a, cache, _ = PL.apply_layer(w, torch.from_numpy(enc), ctx, None, spec)
    enc[0, -1] += 1.0
    b, _, _ = PL.apply_layer(w, torch.from_numpy(enc), ctx, None, spec)
    assert cache is None
    assert not torch.equal(a[0, 0], b[0, 0])


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------


def test_apply_cross_layer_prefill_matches_reference():
    jp, pp = _tree()
    rng = np.random.default_rng(21)
    b, s = 2, 7
    x, mem = _f(rng, b, s, D), _f(rng, b, S_ENC, D)
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="prefill",
                  memory=jnp.asarray(mem), batch_size=b)
    jx, jc = JL.apply_cross_layer(_layer(jp), jnp.asarray(x), jctx, None,
                                  JC.pattern[0])
    pctx = PL.Ctx(cfg=PC, mode="prefill", memory=torch.from_numpy(mem))
    px, pc = PL.apply_cross_layer(_layer(pp), torch.from_numpy(x), pctx,
                                  None, PC.pattern[0])
    assert _rel(px.numpy(), jx) <= 1e-5
    assert sorted(pc) == sorted(jc) == ["ck", "cv", "k", "v"]
    for n in pc:
        assert pc[n].shape == jc[n].shape, n
        assert _rel(pc[n].numpy(), jc[n]) <= 1e-5, n


@pytest.mark.parametrize("pos", [[6, 0, 13], 9])
def test_apply_cross_layer_decode_matches_reference(pos):
    """One decode token over bf16 caches: the self-attention's ragged (or
    int) step, then the cross attention over every encoder row; the
    encoder rows come back unchanged."""
    jp, pp = _tree()
    rng = np.random.default_rng(22)
    b, L = 3, 16
    x = _f(rng, b, 1, D)
    caches = {"k": _f(rng, b, L, HKV, DH), "v": _f(rng, b, L, HKV, DH),
              "ck": _f(rng, b, S_ENC, HKV, DH),
              "cv": _f(rng, b, S_ENC, HKV, DH)}
    jcache = {n: jnp.asarray(a).astype(jnp.bfloat16)
              for n, a in caches.items()}
    pcache = {n: torch.from_numpy(a).to(torch.bfloat16)
              for n, a in caches.items()}
    jpos = jnp.asarray(np.array(pos, np.int32))
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="decode", pos=jpos,
                  batch_size=b)
    jx, jc = JL.apply_cross_layer(_layer(jp), jnp.asarray(x), jctx, jcache,
                                  JC.pattern[0])
    ppos = torch.tensor(pos) if isinstance(pos, list) else pos
    pctx = PL.Ctx(cfg=PC, mode="decode", pos=ppos)
    ck, cv = pcache["ck"].clone(), pcache["cv"].clone()
    px, pc = PL.apply_cross_layer(_layer(pp), torch.from_numpy(x), pctx,
                                  pcache, PC.pattern[0])
    assert _rel(px.numpy(), jx) <= BF16_REL
    assert pc["ck"] is pcache["ck"] and torch.equal(pc["ck"], ck)
    assert pc["cv"] is pcache["cv"] and torch.equal(pc["cv"], cv)
    for n in ("ck", "cv"):
        np.testing.assert_array_equal(
            pc[n].float().numpy(), np.asarray(jc[n].astype(jnp.float32)))
    # the self-attention's row landed in the slab at each position
    jk = np.asarray(jc["k"].astype(jnp.float32))
    pk = pcache["k"].float().numpy()
    for r, at in enumerate(np.broadcast_to(np.array(pos), (b,))):
        np.testing.assert_allclose(pk[r, at], jk[r, at], rtol=1e-2, atol=0)


def test_cross_decode_attention_plain_is_the_reference_arithmetic():
    """The plain version is ``ref_attention`` over bf16 rows: the same
    bf16 output as the JAX function (probabilities rounded to bf16, the
    product at bf16), within one bf16 rounding."""
    rng = np.random.default_rng(23)
    q = _f(rng, 3, 1, H, DH)
    ck, cv = _f(rng, 3, S_ENC, HKV, DH), _f(rng, 3, S_ENC, HKV, DH)
    want = JA.ref_attention(jnp.asarray(q),
                            jnp.asarray(ck).astype(jnp.bfloat16),
                            jnp.asarray(cv).astype(jnp.bfloat16),
                            causal=False)
    got = PA.cross_decode_attention(torch.from_numpy(q),
                                    torch.from_numpy(ck).to(torch.bfloat16),
                                    torch.from_numpy(cv).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert got.shape == (3, 1, H, DH)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=1e-2)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _jax_hidden_prefill(jp, batch, cache_len):
    """The reference's ``prefill`` body up to the final norm (the hidden
    states the port's ``_head`` takes): (hidden states, caches)."""
    b, s = batch["tokens"].shape
    memory = JT._encode(jp, JC, Dist.local(), batch["enc_embeds"],
                        "prefill")
    ctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="prefill",
                 angles=JT._angles(JC, jnp.arange(s)), memory=memory,
                 cache_len=cache_len, batch_size=b)
    x = JT._inputs_to_x(jp, JC, ctx, batch)
    x, _, caches = JT._run_stack(jp, x, ctx, None, JC, JC.pattern,
                                 JC.remainder, remat=False)
    return x, caches


def _jax_hidden_decode(jp, batch, caches):
    pos = batch["pos"]
    b = batch["token"].shape[0]
    ctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="decode", pos=pos,
                 batch_size=b)
    x = JT._inputs_to_x(jp, JC, ctx, batch)
    x, _, _ = JT._run_stack(jp, x, ctx, caches, JC, JC.pattern,
                            JC.remainder, remat=False)
    return x


def _grab_heads(monkeypatch):
    seen, head = [], PT._head

    def grab(params, x, cfg):
        seen.append(x)
        return head(params, x, cfg)
    monkeypatch.setattr(PT, "_head", grab)
    return seen


@pytest.mark.parametrize("frames", ["seeded", "zero_stub"])
def test_whole_model_matches_reference(frames, monkeypatch):
    """Prefill (two prompts at once, frames or the zero stub), then one
    decode step at ragged positions over the bf16 caches the serving
    engine keeps."""
    jp, pp = _tree()
    rng = np.random.default_rng(31)
    b, s, L = 2, 9, 32
    toks = rng.integers(0, PC.vocab_size, (b, s)).astype(np.int32)
    enc = (_f(rng, b, S_ENC, D) if frames == "seeded"
           else np.zeros((b, S_ENC, D), np.float32))
    jb = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}
    pb = {"tokens": torch.from_numpy(toks),
          "enc_embeds": torch.from_numpy(enc)}
    seen = _grab_heads(monkeypatch)
    jtok, jcache = JT.prefill(jp, jb, JC, Dist.local(), L)
    ptok, pcache = PT.prefill(pp, pb, PC, L)
    jh, _ = _jax_hidden_prefill(jp, jb, L)
    assert _rel(seen[-1].numpy(), jh) <= 1e-4
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    for n in ("k", "v", "ck", "cv"):
        assert pcache["pat"][0][n].shape == jcache["pat"][0][n].shape, n
        assert _rel(pcache["pat"][0][n].numpy(), jcache["pat"][0][n]) <= 1e-5
    # decode over the bf16 caches, each row at its own position
    jbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jcache)
    pbf = {g: tuple({n: torch.from_numpy(np.asarray(
        a.astype(jnp.float32))).to(torch.bfloat16) for n, a in t.items()}
        for t in jbf[g]) for g in ("pat", "rem")}
    pos = np.array([s, 4], np.int32)
    tok = rng.integers(0, PC.vocab_size, (b, 1)).astype(np.int32)
    jd = {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)}
    jtok2, _ = JT.decode_step(jp, jd, jbf, JC, Dist.local())
    jh2 = _jax_hidden_decode(jp, jd, jbf)
    ptok2, _ = PT.decode_step(pp, {"token": torch.from_numpy(tok),
                                   "pos": torch.from_numpy(pos)}, pbf, PC)
    assert _rel(seen[-1].numpy(), jh2) <= BF16_REL
    np.testing.assert_array_equal(ptok2.numpy(), np.asarray(jtok2))
