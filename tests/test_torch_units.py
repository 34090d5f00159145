"""Each unit function of the port's engine against the JAX engine's, on
the same numpy weights and activations (config of tests/test_engine.py:
d_model=128, d_ff=256, so INT4 engages).  fp32, atol 2e-5: the two sides
sum in different orders; INT4 units compare the port's packed
``int4_matmul`` path with the JAX path over the dequantized weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ATTN, DENSE, LayerSpec, ModelConfig  # noqa: E402
from repro.core import engine as J  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import rope as jax_rope  # noqa: E402
from repro.quant.int4 import dequantize_int4, quantize_int4  # noqa: E402
from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.core import engine as P  # noqa: E402
from repro_torch.models import attention, common, rope  # noqa: E402

KW = dict(name="pipo-tiny", num_layers=3, d_model=128, num_heads=4,
          num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
JCFG = ModelConfig(**KW, pattern=(LayerSpec(ATTN, DENSE),))
PCFG = PB.ModelConfig(**KW, pattern=(PB.LayerSpec(PB.ATTN, PB.DENSE),))
ATOL = 2e-5


def _weights(kind, quant, seed=0):
    """(jax weights, port weights): fp32 arrays, or for INT4 the JAX side
    gets the dequantized weights and the port the packed pairs."""
    rng = np.random.default_rng(seed)
    d, f = 128, 256
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    if kind == "mha":
        w = {"wq": mk(d, 128), "wk": mk(d, 64), "wv": mk(d, 64),
             "wo": mk(128, d)}
    else:
        w = {"w_gate": mk(d, f), "w_up": mk(d, f), "w_down": mk(f, d)}
    norm = (rng.standard_normal(d) * 0.1).astype(np.float32)
    jw, pw = {"norm": jnp.asarray(norm)}, {"norm": torch.from_numpy(norm)}
    for name, a in w.items():
        if quant:
            p, s = quantize_int4(jnp.asarray(a))
            jw[name] = dequantize_int4(p, s, jnp.float32)
            pw[name + "#q"] = torch.from_numpy(np.array(p))
            pw[name + "#s"] = torch.from_numpy(np.array(s))
        else:
            jw[name] = jnp.asarray(a)
            pw[name] = torch.from_numpy(a)
    return jw, pw


def _close(p, j, atol=ATOL):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 128)).astype(np.float32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos", [0, 17])
def test_qkv(quant, pos):
    jw, pw = _weights("mha", quant)
    x = _x(2, 5)
    jq, jk, jv = J._qkv(jnp.asarray(x), jw, jnp.int32(pos), JCFG)
    pq, pk, pv = P._qkv(torch.from_numpy(x), pw, pos, PCFG)
    for p, j in ((pq, jq), (pk, jk), (pv, jv)):
        _close(p, j)


@pytest.mark.parametrize("quant", [False, True])
def test_attn_prefill_unit(quant):
    jw, pw = _weights("mha", quant)
    x = _x(2, 12)
    jx, jk, jv = J._attn_prefill_unit(jnp.asarray(x), jw, cfg=JCFG)
    px, pk, pv = P._attn_prefill_unit(torch.from_numpy(x), pw, cfg=PCFG)
    for p, j in ((px, jx), (pk, jk), (pv, jv)):
        _close(p, j)


def _caches(b, L, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, L, 2, 32)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos", [0, 13, 47])
def test_attn_decode_unit_scalar_pos(quant, pos):
    jw, pw = _weights("mha", quant)
    x = _x(2, 1)
    kc, vc = _caches(2, 48)
    jx, jk, jv, jkc, jvc = J._attn_decode_unit(
        jnp.asarray(x), jw, jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(pos), cfg=JCFG)
    px, pk, pv, pkc, pvc = P._attn_decode_unit(
        torch.from_numpy(x), pw, torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), pos, cfg=PCFG)
    for p, j in ((px, jx), (pk, jk), (pv, jv), (pkc, jkc), (pvc, jvc)):
        _close(p, j)


@pytest.mark.parametrize("quant", [False, True])
def test_attn_decode_unit_ragged_pos(quant):
    """A (b,) pos: each row equals the JAX unit run on that row alone at
    its own scalar position (the JAX ``_qkv`` broadcasts a (b,) pos into
    a (b, b, ...) rope grid, so it is not called with one)."""
    jw, pw = _weights("mha", quant)
    pos = [3, 40, 0]
    x = _x(3, 1)
    kc, vc = _caches(3, 48)
    px, pk, pv, pkc, pvc = P._attn_decode_unit(
        torch.from_numpy(x), pw, torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), torch.tensor(pos, dtype=torch.int32),
        cfg=PCFG)
    for r, p in enumerate(pos):
        jx, jk, jv, jkc, jvc = J._attn_decode_unit(
            jnp.asarray(x[r:r + 1]), jw, jnp.asarray(kc[r:r + 1]),
            jnp.asarray(vc[r:r + 1]), jnp.int32(p), cfg=JCFG)
        for pt, j in ((px, jx), (pk, jk), (pv, jv), (pkc, jkc), (pvc, jvc)):
            _close(pt[r:r + 1], j)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s", [1, 9])
def test_mlp_unit(quant, s):
    jw, pw = _weights("mlp", quant)
    x = _x(2, s)
    _close(P._mlp_unit(torch.from_numpy(x), pw, cfg=PCFG),
           J._mlp_unit(jnp.asarray(x), jw, cfg=JCFG))


def test_embed_and_head_units():
    rng = np.random.default_rng(4)
    emb = (rng.standard_normal((512, 128)) / np.sqrt(128)).astype(np.float32)
    toks = rng.integers(0, 512, (3, 7)).astype(np.int32)
    je = J._embed_unit(jnp.asarray(toks), jnp.asarray(emb))
    pe = P._embed_unit(torch.from_numpy(toks), torch.from_numpy(emb))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    x = _x(3, 4)
    np.testing.assert_array_equal(
        P._head_unit(torch.from_numpy(x), torch.from_numpy(emb)).numpy(),
        np.asarray(J._head_unit(jnp.asarray(x), jnp.asarray(emb))))


def test_norm_rope_and_partials():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    sc = (rng.standard_normal(32) * 0.2).astype(np.float32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(sc)),
           jax_common.rms_norm(jnp.asarray(x), jnp.asarray(sc)))
    _close(common.silu(torch.from_numpy(x)), jax_common.silu(jnp.asarray(x)))
    ang_p = rope.rope_angles(torch.arange(3, 9), 32, 10000.0)
    ang_j = jax_rope.rope_angles(jnp.arange(3, 9), 32, 10000.0)
    _close(ang_p, ang_j, atol=1e-6)
    _close(rope.apply_rope(torch.from_numpy(x), ang_p),
           jax_rope.apply_rope(jnp.asarray(x), ang_j))
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    mask = np.tril(np.ones((5, 9), bool), 4)
    mask[0] = False                                   # a fully masked row
    pa = attention.attn_partials(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(mask))
    ja = jax_attention.attn_partials(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(mask))
    for p, j in zip(pa, ja):
        _close(p, j)
    # merging the partials of two key blocks (port and JAX alike)
    blocks = [(slice(0, 4), slice(4, 9))]
    for lo, hi in blocks:
        pp = [attention.attn_partials(
            torch.from_numpy(q), torch.from_numpy(k[:, sl]),
            torch.from_numpy(v[:, sl]), torch.from_numpy(mask[:, sl]))
            for sl in (lo, hi)]
        jp = [jax_attention.attn_partials(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(mask[:, sl])) for sl in (lo, hi)]
        for p, j in zip(common.merge_partials(*pp),
                        jax_common.merge_partials(*jp)):
            _close(p, j)
        _close(common.finalize_partials(*common.merge_partials(*pp)),
               jax_common.finalize_partials(*ja))
    _close(common.finalize_partials(*pa), jax_common.finalize_partials(*ja))
