"""The port's optimizers against the JAX package's (``optim/``): one
AdamW step and one Adafactor step, each with a ``cosine_schedule`` and
global-norm clipping, on the same seeded parameters, state and
gradients (f32 and bf16 parameters, vectors, matrices and stacked 3-D
leaves): updates and new state within 1e-6 relative of each leaf's max,
Adafactor's bf16 momentum within one bf16 ulp; ``global_norm`` and
``cosine_schedule`` too, the update written into the caller's
(donated) tensors, and the state's keys, shapes and dtypes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import AdamW as JAdamW
from repro.optim import apply_updates as j_apply
from repro.optim import cosine_schedule as j_cosine
from repro.optim import global_norm as j_norm
from repro.optim.adafactor import Adafactor as JAdafactor
from repro_torch import tree as PT
from repro_torch.core.convert import from_reference_train_state
from repro_torch.optim import AdamW, Adafactor, apply_updates, cosine_schedule
from repro_torch.optim import global_norm

SHAPES = {"w": (16, 8), "b": (8,), "stack": ((3, 8, 4), jnp.bfloat16),
          "tab": ({"e": (12, 6), "n": ((6,), jnp.bfloat16)},)}


def _tree(rng, scale=1.0):
    def leaf(spec):
        shape, dt = spec if isinstance(spec[0], tuple) else (spec,
                                                             jnp.float32)
        return jnp.asarray(rng.standard_normal(shape) * scale, dt)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if isinstance(s, tuple) and not isinstance(s[0], int) \
                and isinstance(s[0], dict):
            return tuple(walk(v) for v in s)
        return leaf(s)
    return walk(SHAPES)


def _port(tree):
    return from_reference_train_state(jax.tree.map(np.asarray, tree), None,
                                      "cpu")[0]


def _close(want, got, tol=1e-6):
    jw = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    pg = PT.leaves(got)
    assert len(jw) == len(pg)
    for w, g in zip(jw, pg):
        g = g.float().numpy()
        assert w.shape == g.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(w - g).max()) <= tol * scale


def _case(seed=0):
    rng = np.random.default_rng(seed)
    params, grads = _tree(rng), _tree(rng, 3.0)
    return params, grads


def test_global_norm_and_cosine_schedule():
    params, grads = _case()
    assert float(global_norm(_port(grads))) == pytest.approx(
        float(j_norm(grads)), rel=1e-6)
    j, p = j_cosine(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 55, 100, 140):
        assert float(p(torch.tensor(step, dtype=torch.int32))) == \
            pytest.approx(float(j(jnp.int32(step))), rel=1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference(steps):
    params, _ = _case()
    jopt = JAdamW(lr=j_cosine(1e-2, 2, 10), clip_norm=1.0)
    popt = AdamW(lr=cosine_schedule(1e-2, 2, 10), clip_norm=1.0)
    js, ps = jopt.init(params), popt.init(_port(params))
    jp, pp = params, _port(params)
    for i in range(steps):
        grads = _case(i + 1)[1]
        ju, js, jg = jopt.update(grads, js, jp)
        pu, ps, pg = popt.update(_port(grads), ps, pp)
        assert float(pg) == pytest.approx(float(jg), rel=1e-6)
        _close(ju, pu)
        jp, pp = j_apply(jp, ju), apply_updates(pp, pu)
        _close(js["m"], ps["m"])
        _close(js["v"], ps["v"])
        assert int(ps["step"]) == int(js["step"]) == i + 1
        assert ps["step"].dtype == torch.int32
        _close(jp, pp)
    assert all(t.dtype == torch.float32 for t in PT.leaves(ps["m"]))


def test_adafactor_matches_reference():
    params, grads = _case()
    jopt = JAdafactor(lr=j_cosine(1e-2, 2, 10), clip_norm=1.0,
                      weight_decay=0.01)
    popt = Adafactor(lr=cosine_schedule(1e-2, 2, 10), clip_norm=1.0,
                     weight_decay=0.01)
    js, ps = jopt.init(params), popt.init(_port(params))
    jp, pp = params, _port(params)
    for i in range(2):
        grads = _case(i + 1)[1]
        ju, js, _ = jopt.update(grads, js, jp)
        pu, ps, _ = popt.update(_port(grads), ps, pp)
        _close(ju, pu)
        for (path, jl), pl in zip(
                jax.tree_util.tree_flatten_with_path(js["s"])[0],
                PT.leaves(ps["s"])):
            if path[-1].key == "m":        # bf16: within one ulp
                assert pl.dtype == torch.bfloat16
                w = np.asarray(jl, np.float32)
                g = pl.float().numpy()
                mag = np.maximum(np.abs(w), 2.0 ** -126)
                ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
                assert np.all(np.abs(w - g) <= ulp), path
            else:
                _close(jl, pl)
        jp, pp = j_apply(jp, ju), apply_updates(pp, pu)
        _close(jp, pp)
    assert sorted(ps["s"]["w"]) == ["m", "vc", "vr"]
    assert sorted(ps["s"]["b"]) == ["m", "v"]
    assert tuple(ps["s"]["stack"]["vr"].shape) == (3, 8)
    assert tuple(ps["s"]["stack"]["vc"].shape) == (3, 4)


@pytest.mark.parametrize("opt_cls", [AdamW, Adafactor])
def test_update_writes_into_the_state(opt_cls):
    """The reference's launchers donate the parameters and the state to
    the step: the port's update and ``apply_updates`` write the new
    values into the caller's tensors and return those tensors."""
    params, grads = _case()
    opt = opt_cls(lr=cosine_schedule(1e-2, 2, 10))
    p = _port(params)
    s = opt.init(p)
    old_p = [t.clone() for t in PT.leaves(p)]
    old_s = [t for t in PT.leaves(s) if t.dim() > 0]
    u, s_new, _ = opt.update(_port(grads), s, p)
    p_new = apply_updates(p, u)
    for a, b in zip(PT.leaves(p), PT.leaves(p_new)):
        assert a is b
    new_s = [t for t in PT.leaves(s_new) if t.dim() > 0]
    assert len(new_s) == len(old_s)
    assert all(a is b for a, b in zip(old_s, new_s))
    assert int(s_new["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in zip(old_p, PT.leaves(p)))


@pytest.mark.parametrize("opt_pair", [(JAdamW, AdamW),
                                      (JAdafactor, Adafactor)])
def test_train_state_carries_over(opt_pair):
    """``from_reference_train_state`` turns a JAX optimizer state into the
    port's leaf for leaf: the structure, shapes and dtypes of the port's
    own ``init`` (int32 step, Adafactor's bf16 momentum and factored
    statistics), the bytes of the JAX one."""
    jcls, pcls = opt_pair
    params = _case()[0]
    jopt = jcls()
    _, jst, _ = jopt.update(_case(1)[1], jopt.init(params), params)
    pp, pst = from_reference_train_state(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, jst),
        "cpu", torch.float32)
    own = pcls().init(pp)
    assert [p for p, _ in PT.flatten_with_path(own)] == \
        [p for p, _ in PT.flatten_with_path(pst)]
    for a, b in zip(PT.leaves(own), PT.leaves(pst)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert all(t.dtype == torch.float32 for t in PT.leaves(pp))
    for w, g in zip(jax.tree.leaves(jst), PT.leaves(pst)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            w, g = w.view(np.uint16), g.view(torch.int16).numpy().view(
                np.uint16)
        else:
            g = g.numpy()
        np.testing.assert_array_equal(w, g)
