"""The sharded port against the JAX package on four gloo CPU ranks, a
(2, 2) ("data", "model") mesh: the counterpart of the reference's gold
check (``tests/test_distributed.py``), gradients included.

One spawn (``repro_torch.launch.ranks.spawn``: ``torch.multiprocessing``,
a ``FileStore`` under the test's temporary directory, one intra-op thread
per rank) runs every case of this module (``tests/dist_cases.py``, which
imports no JAX); the parent draws the JAX package's weights and inputs,
computes its references while the ranks run, and each test reads its
case from the ranks' files.

  * the five archs of the reference's check, scaled as there
    (``d_model=64, num_heads=4, num_kv_heads=4, vocab_size=256``), b 4,
    s 32, f32: the sharded loss within 2e-4 (relative) of the JAX
    package's ``Dist.local()`` loss, the reference's bound; every
    gradient leaf within 1e-4 x that leaf's max |g| of ``jax.grad`` of
    it.  The MoE archs' load-balance term is, in the reference's
    sharded loss, the mean over shards of each shard's own ``E * sum f
    p`` (``layers.py:736``), not the whole batch's, so their gradients
    are held to 1e-4 x max against ``jax.grad`` of the JAX package's
    own sharded loss on a (2, 2) mesh of four forced host devices
    (``tests/dist_jax_ref.py``, a process of its own that runs beside
    the ranks), whose loss the port's matches within 1e-5, and with the
    term off (``AUX_WEIGHT = 0`` in both packages) against the local
    ``jax.grad`` at 1e-4 x max;
  * prefill and one decode step's tokens equal to JAX's (KV over
    ``model``), and a batch-1 prefill with two decode steps with the KV
    over ``("data", "model")``;
  * ``moe_ffn`` (expert-parallel, tokens over the four ranks),
    ``moe_ffn_replicated`` and ``moe_ffn_decode`` (ff over ``data``)
    against the JAX ``moe_ffn`` at ``axis=None``, dropless, to 1e-5;
    ``ssd_sharded`` over the flattened ("data", "model") against
    ``ssd_chunked``;
  * every collective's forward and backward (the JAX transpose rules)
    against numpy over ``model``, ``data`` and ("data", "model").
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dist_cases as DC
from repro.configs import ASSIGNED
from repro.configs import scaled_down as jax_scaled_down
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import Dist, build_model
from repro.models import moe as JM
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import apply_updates as j_apply
from repro.optim import cosine_schedule as j_cosine
from repro.optim.adafactor import Adafactor as JAdafactor
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch import ranks

MOE = dict(num_experts=4, top_k=2, expert_d_ff=16, capacity_factor=4.0)


def _inputs(root):
    """Draw and write the ranks' inputs; return the JAX side's."""
    out = {}
    for arch in DC.ARCHS:
        jc = jax_scaled_down(ASSIGNED[arch], **DC.SCALE)
        params = build_model(jc).init(jax.random.PRNGKey(0), jnp.float32)
        np_params = jax.tree.map(np.asarray, params)
        save_checkpoint(os.path.join(root, "params", arch), 0, np_params)
        rng = np.random.default_rng(1)
        batch = {k: rng.integers(0, jc.vocab_size, (DC.B, DC.S))
                 .astype(np.int32) for k in ("labels", "tokens")}
        np.savez(os.path.join(root, f"batch_{arch}.npz"), **batch)
        out[arch] = (jc, params, batch)
        if arch in DC.OPTIM_ARCHS:
            rng = np.random.default_rng(3)
            grads = [jax.tree.map(lambda x: (3.0 * rng.standard_normal(
                x.shape)).astype(np.float32), np_params) for _ in range(2)]
            for i, g in enumerate(grads, 1):
                save_checkpoint(os.path.join(root, "grads", arch), i, g)
            out[arch] += (grads,)
    rng = np.random.default_rng(2)
    d, E, f = 16, MOE["num_experts"], MOE["expert_d_ff"]
    units = {"x": rng.standard_normal((16, d)),
             "wg": rng.standard_normal((d, E)),
             "w_gate": rng.standard_normal((E, d, f)) / 4,
             "w_up": rng.standard_normal((E, d, f)) / 4,
             "w_down": rng.standard_normal((E, f, d)) / 4,
             "xh": rng.standard_normal((2, 64, 4, 8)),
             "dt": np.log1p(np.exp(rng.standard_normal((2, 64, 4)))),
             "A": -np.exp(rng.standard_normal(4)),
             "B": rng.standard_normal((2, 64, 1, 16)),
             "C": rng.standard_normal((2, 64, 1, 16))}
    units = {k: v.astype(np.float32) for k, v in units.items()}
    np.savez(os.path.join(root, "units.npz"), **units)
    with open(os.path.join(root, "moe.json"), "w") as fh:
        json.dump(MOE, fh)
    return out, units


def _jax_model_refs(jc, params, batch):
    m = build_model(jc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def grads():
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: m.train_loss(p, jb, Dist.local())))(params)
        return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]
    ref = {}
    ref["loss"], ref["grads"] = grads()
    if jc.moe is not None:
        aux, JT.AUX_WEIGHT = JT.AUX_WEIGHT, 0.0
        try:
            ref["loss_noaux"], ref["grads0"] = grads()
        finally:
            JT.AUX_WEIGHT = aux
    s = DC.S
    pre = {"tokens": jb["tokens"]}
    nt, caches = m.prefill(params, pre, Dist.local(), cache_len=s + 4)
    dt, _ = m.decode_step(params, {"token": nt[:, None], "pos": jnp.int32(s)},
                          caches, Dist.local())
    ref["prefill"], ref["decode"] = np.asarray(nt), np.asarray(dt)
    t1, c1 = m.prefill(params, {"tokens": jb["tokens"][:1]}, Dist.local(),
                       cache_len=s + 4)
    toks = [t1]
    for k in range(2):
        t1, c1 = m.decode_step(params, {"token": toks[-1][:, None],
                                        "pos": jnp.int32(s + k)}, c1,
                               Dist.local())
        toks.append(t1)
    ref["long"] = np.stack([np.asarray(t) for t in toks], 1)
    return ref


def _jax_optim_refs(params, grads):
    """Each optimizer's two steps in the JAX package: the parameters,
    the state (leaves in order) and each step's global norm."""
    out = {}
    for name, opt in DC.optim_pair(JAdamW, JAdafactor, j_cosine):
        p, st, norms = params, opt.init(params), []
        for g in grads:
            g = jax.tree.map(jnp.asarray, g)
            upd, st, gn = opt.update(g, st, p)
            p = j_apply(p, upd)
            norms.append(float(gn))
        out[name] = {"params": [np.asarray(x) for x in jax.tree.leaves(p)],
                     "state": [np.asarray(x) for x in jax.tree.leaves(st)],
                     "norms": np.array(norms)}
    return out


def _jax_unit_refs(u):
    cfg = JaxMoEConfig(**MOE)
    out, _ = JM.moe_ffn(jnp.asarray(u["x"]), {k: jnp.asarray(u[k]) for k in
                                              ("wg", "w_gate", "w_up",
                                               "w_down")}, cfg, axis=None)
    y, h, _ = JSSM.ssd_chunked(*(jnp.asarray(u[k]) for k in
                                 ("xh", "dt", "A", "B", "C")), 8)
    return {"moe": np.asarray(out), "ssd_y": np.asarray(y),
            "ssd_h": np.asarray(h)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    jax_in, units = _inputs(root)
    ctx = ranks.spawn(DC.all_cases, 4, (root,), store_dir=root, join=False)
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"))
    sharded = subprocess.Popen(
        [sys.executable, str(here / "dist_jax_ref.py"), root,
         *DC.MOE_ARCHS], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    refs = {arch: _jax_model_refs(*jax_in[arch][:3]) for arch in DC.ARCHS}
    refs["optim"] = {arch: _jax_optim_refs(*jax_in[arch][1::2])
                     for arch in DC.OPTIM_ARCHS}
    refs["units"] = _jax_unit_refs(units)
    while not ctx.join():
        pass
    log, _ = sharded.communicate(timeout=600)
    assert sharded.returncode == 0, log[-3000:]
    for arch in DC.MOE_ARCHS:
        z = _out(root, f"jax_sharded_{arch}.npz")
        refs[arch]["sharded_loss"] = float(z.pop("loss"))
        refs[arch]["sharded_grads"] = [z[f"g{i}"] for i in range(len(z))]
    return root, refs


def _out(root, name):
    z = np.load(os.path.join(root, name))
    return {k: z[k] for k in z.files}


def _close_leaves(want, got, tol):
    assert len(want) == len(got)
    for w, (path, g) in zip(want, got.items()):
        assert w.shape == g.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(w - g).max())
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("arch", DC.ARCHS)
def test_sharded_loss_matches_jax(run, arch):
    root, refs = run
    got = _out(root, f"out_{arch}.npz")
    want = refs[arch]["loss"]
    assert abs(float(got["loss"]) - want) <= 2e-4 * abs(want)


@pytest.mark.parametrize("arch", DC.ARCHS)
def test_sharded_grads_match_jax(run, arch):
    root, refs = run
    want = refs[arch]["sharded_grads" if arch in DC.MOE_ARCHS else "grads"]
    _close_leaves(want, _out(root, f"grads_{arch}.npz"), 1e-4)


@pytest.mark.parametrize("arch", DC.MOE_ARCHS)
def test_sharded_loss_matches_jax_sharded_loss(run, arch):
    root, refs = run
    got = float(_out(root, f"out_{arch}.npz")["loss"])
    want = refs[arch]["sharded_loss"]
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("arch", DC.MOE_ARCHS)
def test_sharded_grads_without_aux_match_jax(run, arch):
    root, refs = run
    got = _out(root, f"out_{arch}.npz")
    want = refs[arch]["loss_noaux"]
    assert abs(float(got["loss_noaux"]) - want) <= 2e-4 * abs(want)
    _close_leaves(refs[arch]["grads0"], _out(root, f"grads0_{arch}.npz"),
                  1e-4)


@pytest.mark.parametrize("arch", DC.ARCHS)
def test_sharded_serve_tokens_match_jax(run, arch):
    root, refs = run
    got = _out(root, f"out_{arch}.npz")
    np.testing.assert_array_equal(got["prefill"], refs[arch]["prefill"])
    np.testing.assert_array_equal(got["decode"], refs[arch]["decode"])


@pytest.mark.parametrize("arch", DC.ARCHS)
def test_batch1_decode_kv_over_data_and_model(run, arch):
    root, refs = run
    got = _out(root, f"out_{arch}.npz")
    np.testing.assert_array_equal(got["long"], refs[arch]["long"])


@pytest.mark.parametrize("arch", DC.OPTIM_ARCHS)
@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_sharded_optimizer_matches_jax(run, name, arch):
    root, refs = run
    want = refs["optim"][arch][name]
    got = _out(root, f"{name}_norms_{arch}.npz")["norms"]
    np.testing.assert_allclose(got, want["norms"], rtol=1e-6)
    _close_leaves(want["params"], _out(root, f"{name}_params_{arch}.npz"),
                  1e-6)
    state = _out(root, f"{name}_state_{arch}.npz")
    assert len(state) == len(want["state"])
    for w, (path, g) in zip(want["state"], state.items()):
        if w.dtype.name == "bfloat16":       # Adafactor's momentum
            w = w.astype(np.float32)
            mag = np.maximum(np.abs(w), 2.0 ** -126)
            ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
            assert np.all(np.abs(w - g) <= ulp), path
        else:
            _close_leaves([w.astype(np.float32)], {path: g}, 1e-6)


@pytest.mark.parametrize("name", ("moe_ffn", "moe_ffn_replicated",
                                  "moe_ffn_decode"))
def test_moe_branches_match_jax(run, name):
    root, refs = run
    for r in range(4):
        got = _out(root, f"units_{r}.npz")[name]
        np.testing.assert_allclose(got, refs["units"]["moe"], rtol=1e-5,
                                   atol=1e-5)


def test_ssd_sharded_matches_ssd_chunked(run):
    root, refs = run
    for r in range(4):
        got = _out(root, f"units_{r}.npz")
        np.testing.assert_allclose(got["ssd_y"], refs["units"]["ssd_y"],
                                   rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(got["ssd_h"], refs["units"]["ssd_h"],
                                   rtol=1e-4, atol=2e-5)


def _group(r, name):
    """(ranks of r's group in order, r's index) on the (2, 2) mesh, rank
    = data * 2 + model."""
    d, m = divmod(r, 2)
    if name == "model":
        return [2 * d, 2 * d + 1], m
    if name == "data":
        return [m, m + 2], d
    return [0, 1, 2, 3], r


def _expected(op, xs, cts, r, name):
    """(y, gradient) on rank r from every rank's x and cotangent."""
    g, i = _group(r, name)
    n = len(g)
    blk = lambda a, j: np.split(a, n)[j]
    if op in ("psum", "pmean", "pvary"):
        y = xs[r] if op == "pvary" else sum(xs[s] for s in g)
        dx = sum(cts[s] for s in g)
        return (y / n, dx / n) if op == "pmean" else (y, dx)
    if op == "pmax":
        return np.max([xs[s] for s in g], 0), None
    if op == "all_gather":
        return (np.concatenate([xs[s] for s in g]),
                sum(blk(cts[s], i) for s in g))
    if op == "all_gather_stacked":
        return np.stack([xs[s] for s in g]), sum(cts[s][i] for s in g)
    if op == "psum_scatter":
        return (blk(sum(xs[s] for s in g), i),
                np.concatenate([cts[s] for s in g]))
    if op == "all_to_all":
        return (np.concatenate([blk(xs[s], i) for s in g]),
                np.concatenate([blk(cts[s], i) for s in g]))
    return xs[g[(i - 1) % n]], cts[g[(i + 1) % n]]       # ppermute ring


@pytest.mark.parametrize("name", list(DC.AXES))
@pytest.mark.parametrize("op", DC.OPS)
def test_collective_forward_backward(run, op, name):
    root, _ = run
    outs = [_out(root, f"units_{r}.npz") for r in range(4)]
    xs, cts = [], []
    for r in range(4):
        rng = np.random.default_rng(100 + r)
        xs.append(rng.standard_normal((4, 6)).astype(np.float32))
        ct = rng.standard_normal((16, 6)).astype(np.float32)
        y = outs[r][f"{op}_{name}_y"]
        cts.append(ct.reshape(-1)[:y.size].reshape(y.shape))
    for r in range(4):
        y, dx = _expected(op, xs, cts, r, name)
        np.testing.assert_allclose(outs[r][f"{op}_{name}_y"], y, rtol=1e-6,
                                   atol=1e-6)
        if dx is not None:
            np.testing.assert_allclose(outs[r][f"{op}_{name}_g"], dx,
                                       rtol=1e-6, atol=1e-6)
