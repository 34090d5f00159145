"""Resident INT4 tables (``cfg.quant_weights``, the dry run's ``w4``
variant) in the port against the JAX package, on the CPU at a scaled
tinyllama wide enough that the rule packs some projections and not
others (d_model 256, 4 heads of 64, 2 kv heads, d_ff 512: ``wq``,
``wo``, ``w_gate``, ``w_up`` and ``w_down`` pack, ``wk``/``wv`` at
256x128 stay plain because K*N < 2**16):

  * the tables (names, shapes, axes) and ``param_struct``'s dtypes
    (whisper too, whose encoder the reference types at the tree's dtype;
    the spec trees are ``tests/test_torch_sharding.py``'s ``_w4`` cases);
  * the draws: ``#q`` uint8 in [0, 255), ``#s`` f32 in [1e-3, 2e-3),
    kept through ``to_device`` and ``from_reference_train_state``;
  * ``prefill`` and ``decode_step`` on the JAX package's carried
    weights: hidden states within 1e-4 x max at the f32 prefill (both
    dequantize to f32) and 2e-2 x max at decode over bf16 caches, equal
    next tokens; the dense feed-forward is skipped in both, as the
    reference's ``apply_dense_ffn`` looks for an unpacked ``w_gate``
    (ROADMAP Queue 3 item 24), so ``wq`` and ``wo`` are the packed
    projections that run;
  * the train step's refusal (``TypeError`` naming uint8 in both);
  * ``int4_matmul_op``, ``flash_attention_op`` and
    ``decode_attention_op`` on bf16 inputs (widened to f32, cast back;
    the card's launches are ``tests/test_torch_gpu.py``'s, marked
    ``cuda``) and
    ``quantize_tree``'s leaves and path set, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, scaled_down  # noqa: E402
from repro.models import Dist  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant.int4 import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.core.convert import from_reference_train_state  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import int4_matmul_ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.quant.int4 import quantize_int4, quantize_tree  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

WIDE = dict(d_model=256, num_heads=4, head_dim=64, d_ff=512,
            quant_weights=True)
JC = scaled_down(get_config("tinyllama-1.1b"), **WIDE)
PC = PB.scaled_down(port_config("tinyllama-1.1b"), **WIDE)
PACKED = ("wq", "wo", "w_gate", "w_up", "w_down")
F32_REL = 1e-4
BF16_REL = 2e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), leaf) for path, leaf in flat]


def _tree(seed=0):
    """The JAX model's f32 tree (numpy leaves; ``#q`` uint8, ``#s`` f32),
    the zero-scale norms drawn at 0.1 so that they act: (JAX tree, port
    tree carried leaf for leaf)."""
    tree = jax.tree.map(np.asarray, JT.init_params(
        JC, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                   if a.dtype == np.float32 and not a.any() else a), tree)
    pp, _ = from_reference_train_state(tree, None, "cpu")
    return jax.tree.map(jnp.asarray, tree), pp


# ---------------------------------------------------------------------------
# tables, structs, draws, specs
# ---------------------------------------------------------------------------

def test_tables_match_reference():
    jt, pt = JT.model_tables(JC), PT.model_tables(PC)
    for grp in ("pat", "rem"):
        for j, p in zip(jt[grp], pt[grp]):
            assert sorted(j) == sorted(p)
            for n in j:
                assert (tuple(p[n].shape), tuple(p[n].axes), p[n].scale) == \
                    (tuple(j[n].shape), tuple(j[n].axes), j[n].scale), n
    names = set(pt["pat"][0])
    assert {n + "#q" for n in PACKED} | {n + "#s" for n in PACKED} <= names
    assert {"wk", "wv"} <= names and not names & set(PACKED)
    assert pt["pat"][0]["wq#q"].shape == (256, 128)
    assert pt["pat"][0]["wq#s"].shape == (2, 256)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-base",
                                  "llama4-scout-17b-a16e"])
def test_param_struct_matches_reference(arch):
    """Paths, shapes and dtypes leaf for leaf: ``#q`` uint8 and ``#s``
    f32, except in an encoder's stack, which the reference's
    ``param_struct`` types at the tree's dtype (ROADMAP Queue 3 item
    23); MoE expert stacks stay unpacked."""
    jc = scaled_down(get_config(arch), **WIDE)
    pc = PB.scaled_down(port_config(arch), **WIDE)
    want = [(p, tuple(s.shape), str(s.dtype))
            for p, s in _jax_flat(JT.param_struct(jc))]
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in flatten_with_path(PT.param_struct(pc))]
    assert got == want
    assert any(p.endswith("#q") for p, _, _ in got)


def test_init_draws_packed_tables():
    params = PT.init_params(PC, 0)
    lay = params["pat"][0]
    q, s = lay["wq#q"], lay["w_down#s"]
    assert q.dtype == np.uint8 and q.shape == (PC.num_periods, 256, 128)
    assert q.max() <= 254 and len(np.unique(q)) > 200
    assert s.dtype == np.float32 and 1e-3 <= s.min() and s.max() < 2e-3
    dev = PT.to_device(params, "cpu", torch.bfloat16)
    assert dev["pat"][0]["wq#q"].dtype == torch.uint8
    assert dev["pat"][0]["wq#s"].dtype == torch.float32
    assert dev["pat"][0]["wk"].dtype == torch.bfloat16
    again = PT.init_params(PC, 0)
    assert np.array_equal(again["pat"][0]["w_up#q"], lay["w_up#q"])


def test_train_state_carries_packed_leaves_bit_for_bit():
    jp, _ = _tree()
    tree = jax.tree.map(np.asarray, jp)
    got, _ = from_reference_train_state(tree, None, "cpu",
                                        dtype=torch.bfloat16)
    for (path, want), (_, t) in zip(_jax_flat(tree), flatten_with_path(got)):
        if path.endswith(("#q", "#s")):
            assert str(t.dtype) == f"torch.{want.dtype}", path
            assert np.array_equal(t.numpy(), want), path


def test_resident_engine_carries_packed_tables_bit_for_bit():
    """``from_reference_resident`` lays the JAX tree's ``#q``/``#s``
    leaves into a resident engine built on the ``quant_weights`` config
    (uint8 and f32, bit for bit), which then serves."""
    from repro_torch.core.convert import from_reference_resident
    from repro_torch.serving.base import Request
    from repro_torch.serving.spec import EngineSpec, create_engine
    eng = create_engine(EngineSpec(arch="tinyllama-1.1b", cfg=PC,
                                   max_len=64).resolve(), device="cpu")
    tree = jax.tree.map(np.asarray, _tree()[0])
    from_reference_resident(tree, eng)
    for (path, want), (_, got) in zip(_jax_flat(tree),
                                      flatten_with_path(eng.params)):
        if path.endswith(("#q", "#s")):
            assert str(got.dtype) == f"torch.{want.dtype}", path
            assert np.array_equal(got.numpy(), want), path
    eng.submit(Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                       max_new=3))
    assert len(eng.run()[0].out) == 3


# ---------------------------------------------------------------------------
# the model on packed tables
# ---------------------------------------------------------------------------

def _jax_hidden(jp, batch, ctx_kw, caches=None):
    """The reference's stack up to the final norm (the hidden states the
    port's ``_head`` takes)."""
    key = "tokens" if "tokens" in batch else "token"
    b, s = batch[key].shape
    mode = "prefill" if caches is None else "decode"
    ctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode=mode, batch_size=b,
                 **ctx_kw)
    x = JT._inputs_to_x(jp, JC, ctx, batch)
    x, _, _ = JT._run_stack(jp, x, ctx, caches, JC, JC.pattern,
                            JC.remainder, remat=False)
    return x


def test_prefill_and_decode_match_reference(monkeypatch):
    """Prefill of two prompts (f32, both dequantize to f32), then one
    decode step at ragged positions over bf16 caches; every packed
    projection goes through ``int4_matmul_op``."""
    jp, pp = _tree()
    seen, head = [], PT._head

    def grab(params, x, cfg):
        seen.append(x)
        return head(params, x, cfg)
    monkeypatch.setattr(PT, "_head", grab)
    calls = []
    mm = ops.int4_matmul_op

    def counted(*a, **k):
        calls.append(a[1].shape)
        return mm(*a, **k)
    monkeypatch.setattr(PL, "int4_matmul_op", counted)
    rng = np.random.default_rng(5)
    b, s, L = 2, 12, 32
    toks = rng.integers(0, PC.vocab_size, (b, s)).astype(np.int32)
    jtok, jcache = JT.prefill(jp, {"tokens": jnp.asarray(toks)}, JC,
                              Dist.local(), L)
    ptok, pcache = PT.prefill(pp, {"tokens": torch.from_numpy(toks)}, PC, L)
    jh = _jax_hidden(jp, {"tokens": jnp.asarray(toks)},
                     dict(angles=JT._angles(JC, jnp.arange(s)),
                          cache_len=L))
    assert _rel(seen[-1].numpy(), jh) <= F32_REL
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    # wq and wo a layer: the feed-forward's packed tables are skipped
    assert calls == [(256, 128), (256, 128)] * PC.num_layers
    # decode over bf16 caches, each row at its own position
    jbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jcache)
    pbf = {g: tuple({n: torch.from_numpy(np.asarray(
        a.astype(jnp.float32))).to(torch.bfloat16) for n, a in t.items()}
        for t in jbf[g]) for g in ("pat", "rem")}
    pos = np.array([s, 5], np.int32)
    tok = rng.integers(0, PC.vocab_size, (b, 1)).astype(np.int32)
    jd = {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)}
    jtok2, _ = JT.decode_step(jp, jd, jbf, JC, Dist.local())
    jpos = jnp.asarray(pos)
    jh2 = _jax_hidden(jp, jd, dict(angles=JT._angles(JC, jpos[:, None]),
                                   pos=jpos), caches=jbf)
    ptok2, _ = PT.decode_step(pp, {"token": torch.from_numpy(tok),
                                   "pos": torch.from_numpy(pos)}, pbf, PC)
    assert _rel(seen[-1].numpy(), jh2) <= BF16_REL
    np.testing.assert_array_equal(ptok2.numpy(), np.asarray(jtok2))


def test_dense_ffn_skipped_under_quant_weights_as_the_reference():
    """The reference's ``apply_dense_ffn`` returns its input when the
    table has no ``w_gate`` (it holds ``w_gate#q``): the port does the
    same, and still runs a streamed unit's packed pairs."""
    jp, pp = _tree()
    lay_j = {n: t[0] for n, t in jp["pat"][0].items()}
    lay_p = {n: t[0] for n, t in pp["pat"][0].items()}
    x = np.random.default_rng(7).standard_normal((2, 3, 256)).astype(
        np.float32)
    jctx = JL.Ctx(cfg=JC, dist=Dist.local(), mode="prefill")
    jy, _ = JL.apply_dense_ffn(lay_j, jnp.asarray(x), jctx)
    py = PL.apply_dense_ffn(lay_p, torch.from_numpy(x),
                            PL.Ctx(cfg=PC, mode="prefill"))
    assert np.array_equal(np.asarray(jy), x)
    assert np.array_equal(py.numpy(), x)
    streamed = PL.apply_dense_ffn(lay_p, torch.from_numpy(x), PL.Ctx(
        cfg=dataclasses.replace(PC, quant_weights=False), mode="prefill"))
    assert not np.array_equal(streamed.numpy(), x)


def test_train_step_refuses_packed_tables_as_the_reference():
    """``jax.value_and_grad`` refuses the uint8 ``#q`` leaves; the port's
    train step raises the same ``TypeError`` before any work, naming the
    leaf."""
    jp, pp = _tree()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, PC.vocab_size, (2, 8)).astype(np.int32)
    with pytest.raises(TypeError) as jerr:
        jax.value_and_grad(lambda p: JT.train_loss(
            p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            JC, Dist.local()))(jp)
    step = make_train_step(Model(PC), AdamW())
    with pytest.raises(TypeError) as perr:
        step(pp, AdamW().init(pp), {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(toks)})
    head = "grad requires real- or complex-valued inputs"
    assert str(jerr.value).startswith(head) and "uint8" in str(jerr.value)
    assert str(perr.value).startswith(head) and "uint8" in str(perr.value)
    assert "#q" in str(perr.value)


def test_int4_matmul_op_takes_bf16_x():
    """bf16 ``x``: widened to f32, the f32 kernel's plain version here,
    the output cast back to bf16 (bit-equal to that recipe); the plain
    arm (``use_kernels(False)``) gives the same bf16 output."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    packed, scale = quantize_int4(w)
    xb = x.to(torch.bfloat16)
    got = ops.int4_matmul_op(xb, packed, scale, group=128)
    want = int4_matmul_ref(xb.float(), packed, scale, 128).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    ops.use_kernels(False)
    try:
        plain = ops.int4_matmul_op(xb, packed, scale, group=128)
    finally:
        ops.use_kernels(True)
    assert plain.dtype == torch.bfloat16
    assert torch.equal(plain, want)


def _bf16(rng, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("op", ["flash", "decode"])
def test_attention_ops_take_bf16(op):
    """bf16 q (and k, v): the kernel arm hands them to the kernel wrapper
    as they are, which here runs the plain version at bf16, so it equals
    the plain arm (``use_kernels(False)``) bit for bit, in bf16.  Flash no
    longer equals widening to f32, the f32 plain version and a cast back
    (the bf16 arithmetic rounds P to bf16, as the TPU kernel does); it
    stays within 2e-2 of it.  Decode widens q and keeps its arithmetic in
    f32, so it still equals that recipe bit for bit."""
    rng = np.random.default_rng(11)
    if op == "flash":
        q, k, v = _bf16(rng, 2, 24, 4, 32), _bf16(rng, 2, 24, 2, 32), \
            _bf16(rng, 2, 24, 2, 32)
        run = lambda q, k, v: ops.flash_attention_op(q, k, v, causal=True)
        widened = ops.flash_attention_op(q.float(), k.float(), v.float(),
                                         causal=True).to(torch.bfloat16)
    else:
        q, k, v = _bf16(rng, 2, 4, 32), _bf16(rng, 2, 40, 2, 32), \
            _bf16(rng, 2, 40, 2, 32)
        pos = torch.tensor([39, 17])
        run = lambda q, k, v: ops.decode_attention_op(q, k, v, pos)
        widened = ops.decode_attention_op(q.float(), k, v,
                                          pos).to(torch.bfloat16)
    got = run(q, k, v)
    assert got.dtype == torch.bfloat16
    ops.use_kernels(False)
    try:
        plain = run(q, k, v)
    finally:
        ops.use_kernels(True)
    assert plain.dtype == torch.bfloat16
    assert torch.equal(got, plain)
    if op == "flash":
        assert not torch.equal(got, widened)
    else:
        assert torch.equal(got, widened)
    torch.testing.assert_close(got.float(), widened.float(), rtol=0,
                               atol=BF16_REL)


# ---------------------------------------------------------------------------
# quantize_tree
# ---------------------------------------------------------------------------

def test_quantize_tree_matches_reference():
    """The same ``{packed, scale}`` leaves bit for bit and the same path
    set, on a tree with eligible, too-small, odd-N and stacked leaves."""
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"a": f(256, 256), "b": {"c": f(128, 64), "d": f(128, 513)},
            "e": (f(512, 128), f(3, 256, 256)), "f": f(256)}
    jq, jpaths = jax_quantize_tree(jax.tree.map(jnp.asarray, tree))
    pq, ppaths = quantize_tree(jax.tree.map(torch.from_numpy, tree))
    assert ppaths == jpaths == {"a", "e/0"}
    jflat = dict(_jax_flat(jq))
    pflat = dict(flatten_with_path(pq))
    assert sorted(jflat) == sorted(pflat)
    for path, want in jflat.items():
        got = pflat[path].numpy()
        assert got.dtype == np.asarray(want).dtype, path
        assert np.array_equal(got, np.asarray(want)), path
