"""The port's training substrates against the JAX package's: the data
pipeline (``SyntheticSource``, ``MemmapSource`` over a corpus the test
writes, host-sliced ``DataPipeline`` batches and the prefetch thread,
bit-equal), checkpoints (a JAX-written one with f32 and bf16 leaves and
AdamW state restores in the port bit for bit, and a port-written one in
JAX; atomic rename, ``latest_step``, the async writer's GC), the int8
gradient codec and error feedback (bit-equal), ``StragglerDetector``'s
statistics, and ``TrainRunner``: six steps of scaled tinyllama equal to
the JAX runner's losses within 1e-4 relative from the same initial
state, and a run killed by ``fail_at`` and resumed from its checkpoint
equal to an uninterrupted one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as JC
from repro import data as JD
from repro import runtime as JR
from repro.models import Dist
from repro.optim import AdamW as JAdamW
from repro.optim import apply_updates as j_apply
from repro.runtime import fault_tolerance as JF
from repro_torch import checkpoint as PC
from repro_torch import data as PD
from repro_torch import runtime as PR
from repro_torch import tree as PT
from repro_torch.core.convert import from_reference_train_state
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime import fault_tolerance as PF
from train_cases import configs, jax_params

from repro.models import build_model as jax_build_model


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_synthetic_pipeline_matches_reference(hosts):
    count, index = hosts
    kw = dict(seq_len=24, global_batch=8, vocab_size=300, seed=3,
              host_count=count, host_index=index)
    jcfg, pcfg = JD.DataConfig(**kw), PD.DataConfig(**kw)
    jp = JD.DataPipeline(JD.SyntheticSource(jcfg), jcfg)
    pp = PD.DataPipeline(PD.SyntheticSource(pcfg), pcfg)
    assert pp.local_batch == jp.local_batch == 8 // count
    for step in (0, 1, 7, 1000):
        a, b = jp.batch_at(step), pp.batch_at(step)
        assert sorted(a) == sorted(b) and b["step"] == step
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_memmap_source_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "corpus.bin")
    PD.MemmapSource.write_corpus(path, rng.integers(0, 500, 20_000))
    kw = dict(seq_len=64, global_batch=4, vocab_size=500, seed=1)
    jcfg, pcfg = JD.DataConfig(**kw), PD.DataConfig(**kw)
    jp = JD.DataPipeline(JD.MemmapSource(jcfg, path), jcfg)
    pp = PD.DataPipeline(PD.MemmapSource(pcfg, path), pcfg)
    for step in (0, 3, 99):
        np.testing.assert_array_equal(jp.batch_at(step)["tokens"],
                                      pp.batch_at(step)["tokens"])
    with pytest.raises(ValueError, match="too small"):
        PD.MemmapSource(PD.DataConfig(seq_len=30_000), path)


def test_prefetch_thread_in_order():
    cfg = PD.DataConfig(seq_len=8, global_batch=2, vocab_size=50,
                        prefetch=2)
    p = PD.DataPipeline(PD.SyntheticSource(cfg), cfg).start(from_step=3)
    batches = [next(p) for _ in range(4)]
    p.stop()
    assert [b["step"] for b in batches] == [3, 4, 5, 6]
    np.testing.assert_array_equal(batches[2]["tokens"],
                                  p.batch_at(5)["tokens"])


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def _jax_state():
    """Scaled tinyllama's bf16 parameters with f32 norms' kin, and the
    AdamW state after one step (nonzero moments, step 1)."""
    jc, _ = configs("tinyllama-1.1b")
    params = jax_params(jc, jnp.bfloat16)
    params["final_norm"]["scale"] = params["final_norm"]["scale"].astype(
        jnp.float32) + 0.25
    opt = JAdamW()
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, params)
    _, st, _ = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt": st}


def _bytes(x):
    """A leaf's raw bytes (bf16 as uint16) as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same(jtree, ptree):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    pl = PT.flatten_with_path(ptree)
    assert len(jl) == len(pl)
    for (jp, a), (pp, b) in zip(jl, pl):
        assert "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in jp) == pp
        a, b = _bytes(a), _bytes(b)
        assert a.dtype == b.dtype and a.shape == b.shape, pp
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_restores_in_port(tmp_path):
    state = _jax_state()
    JC.save_checkpoint(str(tmp_path), 5, state, meta={"loss": 1.5})
    assert PC.latest_step(str(tmp_path)) == 5
    _, pc = configs("tinyllama-1.1b")
    from repro_torch.models import transformer as T
    target = {"params": T.param_struct(pc, torch.bfloat16),
              "opt": {"m": T.param_struct(pc, torch.float32),
                      "v": T.param_struct(pc, torch.float32),
                      "step": torch.empty((), dtype=torch.int32,
                                          device="meta")}}
    tree, manifest = PC.restore_checkpoint(str(tmp_path), 5, target)
    assert manifest["step"] == 5 and manifest["loss"] == 1.5
    assert tree["params"]["pat"][0]["wq"].dtype == torch.bfloat16
    assert tree["params"]["final_norm"]["scale"].dtype == torch.float32
    assert tree["opt"]["step"].dtype == torch.int32
    _same(state, tree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _jax_state()
    params, opt = from_reference_train_state(
        jax.tree.map(np.asarray, state["params"]),
        jax.tree.map(np.asarray, state["opt"]), "cpu")
    PC.save_checkpoint(str(tmp_path), 9, {"params": params, "opt": opt},
                       meta={"loss": 2.0})
    assert not list(tmp_path.glob("*.tmp"))
    tree, manifest = JC.restore_checkpoint(str(tmp_path), 9, state)
    assert manifest["loss"] == 2.0
    assert tree["params"]["pat"][0]["wq"].dtype == jnp.bfloat16
    _same(tree, {"params": params, "opt": opt})
    # and back into the port, from its own files
    back, _ = PC.restore_checkpoint(str(tmp_path), 9,
                                    {"params": params, "opt": opt})
    _same(state, back)


def test_async_checkpointer_snapshots_and_gc(tmp_path):
    ck = PC.AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.ones(4)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": w})
        w.add_(1.0)                  # the next step touches the leaf
    ck.wait()
    assert ck.last_saved == 4 and PC.latest_step(str(tmp_path)) == 4
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    tree, _ = PC.restore_checkpoint(str(tmp_path), 4, {"w": w})
    assert torch.equal(tree["w"], torch.full((4,), 4.0))


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    ck = PC.AsyncCheckpointer(str(blocked))
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                        # raised once
    assert ck.last_saved is None


# ---------------------------------------------------------------------------
# gradient compression, stragglers
# ---------------------------------------------------------------------------

def test_compress_int8_matches_reference():
    rng = np.random.default_rng(1)
    for x in (rng.standard_normal((1024,)),
              rng.standard_normal((33, 7)) * 1e-3, np.zeros(5)):
        x = x.astype(np.float32)
        jq, js = JR.compress_int8(jnp.asarray(x))
        pq, ps = PR.compress_int8(torch.from_numpy(x))
        assert pq.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(jq), pq.numpy())
        assert np.float32(js) == ps.numpy()
        np.testing.assert_array_equal(
            np.asarray(JR.decompress_int8(jq, js)),
            PR.decompress_int8(pq, ps).numpy())


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((64,)).astype(np.float32) * 1e-3,
         "t": {"u": rng.standard_normal((4, 3)).astype(np.float32)}}
    jef, pef = JR.ErrorFeedbackCompressor(), PR.ErrorFeedbackCompressor()
    jg = jax.tree.map(jnp.asarray, g)
    pg = PT.tree_map(torch.from_numpy, g)
    jr, pr = jef.init(jg), pef.init(pg)
    for _ in range(5):
        jc, jr = jef.compress(jg, jr)
        pc, pr = pef.compress(pg, pr)
        jd, pd = jef.decompress(jc), pef.decompress(pc)
        for a, b in zip(jax.tree.leaves(jd), PT.leaves(pd)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jax.tree.leaves(jr), PT.leaves(pr)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(2)
    jd = JR.StragglerDetector(window=8, factor=2.0)
    pd = PR.StragglerDetector(window=8, factor=2.0)
    for i in range(12):
        t = rng.uniform(0.1, 0.2, 4)
        t[2] *= 5.0 if i > 3 else 1.0
        jd.observe(t)
        pd.observe(t)
    assert pd.stragglers() == jd.stragglers() == [2]
    assert pd.step_stats() == jd.step_stats()


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _runners(tmp_path, name, fail_at=None, max_steps=6):
    """A JAX and a port ``TrainRunner`` on scaled tinyllama from the same
    f32 initial state (the JAX ``init``, carried over)."""
    jc, pc = configs("tinyllama-1.1b")
    params0 = jax_params(jc)
    jm, jopt = jax_build_model(jc), JAdamW(lr=1e-3)

    @jax.jit
    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jm.train_loss(p, batch, Dist.local()))(params)
        upd, opt_state, gn = jopt.update(grads, opt_state, params)
        return j_apply(params, upd), opt_state, {"loss": loss}

    popt = AdamW(lr=1e-3)
    pstep = make_train_step(build_model(pc), popt)
    host = jax.tree.map(np.asarray, params0)

    def pinit():
        p = from_reference_train_state(host, None, "cpu")[0]
        return p, popt.init(p)

    kw = dict(seq_len=24, global_batch=2, vocab_size=jc.vocab_size)
    jdc, pdc = JD.DataConfig(**kw), PD.DataConfig(**kw)
    jr = JF.TrainRunner(
        JF.RunnerConfig(ckpt_dir=str(tmp_path / f"j{name}"), ckpt_every=2,
                        max_steps=max_steps),
        jstep, lambda: (params0, jopt.init(params0)),
        JD.DataPipeline(JD.SyntheticSource(jdc), jdc), fail_at=fail_at)
    pr = PF.TrainRunner(
        PF.RunnerConfig(ckpt_dir=str(tmp_path / f"p{name}"), ckpt_every=2,
                        max_steps=max_steps),
        pstep, pinit, PD.DataPipeline(PD.SyntheticSource(pdc), pdc),
        fail_at=fail_at)
    return jr, pr


def test_runner_losses_match_reference(tmp_path):
    jr, pr = _runners(tmp_path, "a")
    jout, pout = jr.run(), pr.run()
    assert pout["final_step"] == jout["final_step"] == 6
    np.testing.assert_allclose(pout["losses"], jout["losses"], rtol=1e-4)
    assert len(pout["step_s"]) == 6 and pout["restore_s"] is None
    # the port's final checkpoint restores in JAX, equal to its state
    tree, _ = JC.restore_checkpoint(
        str(tmp_path / "pa"), 6,
        {"params": jax.tree.map(np.asarray, jr.init_state()[0]),
         "opt": jax.tree.map(np.asarray, JAdamW().init(
             jr.init_state()[0]))})
    _same(tree, {"params": pout["params"], "opt": pout["opt_state"]})


def test_runner_resume_equals_uninterrupted(tmp_path):
    _, ref = _runners(tmp_path, "ref")
    ref_out = ref.run()
    _, crashed = _runners(tmp_path, "x", fail_at=3)
    with pytest.raises(PF.FailureInjector):
        crashed.run()
    crashed.ckpt.wait()
    assert PC.latest_step(str(tmp_path / "px")) == 2
    _, resumed = _runners(tmp_path, "x")
    out = resumed.run()
    assert out["final_step"] == 6 and resumed.restore_s is not None
    np.testing.assert_allclose(out["losses"], ref_out["losses"][2:],
                               rtol=1e-6)
    for a, b in zip(PT.leaves(out["params"]), PT.leaves(ref_out["params"])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
