"""The port's three examples (``examples/*_torch.py``) run on the CPU
through their ``main(argv)`` with ``--device cpu``; without a card and
without ``--device cpu`` they raise, as every entry point of the port
does.  ``quickstart_torch``'s autoconfig lines equal the JAX
``configure``'s for the same model and budget (exact), and its plan the
JAX example's spec resolved (its disk root aside); ``serve_offload_torch``'s
plan, engine stats and host KV bytes equal the JAX engine's on the same
spec and requests (exact)."""
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_the_cpu(capsys):
    out = _example("quickstart_torch").main(["--device", "cpu"])
    assert out["tokens"].shape == (2, 16)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 2048)).all()
    assert out["placement"] == "device" and out["pipeline"] == "performance"
    assert out["use_int4_kernel"] and out["plan"].quant == "int4"
    assert out["plan"].depth == out["depth"] == 8
    printed = capsys.readouterr().out
    assert "=== PIPO autoconfig" in printed and "tokens[0]" in printed

    from repro.configs import get_config as jax_get_config
    from repro.configs import scaled_down as jax_scaled_down
    from repro.core import MemoryBudget as JaxBudget
    from repro.core import configure as jax_configure
    from repro.serving import EngineSpec
    full = jax_get_config("llama3.1-8b")
    ac = jax_configure(full, batch=4, prompt_len=512, gen_len=32,
                       budget=JaxBudget(), quant="int4")
    assert (out["weights_gib"], out["kv_cache_gib"],
            out["peak_prefill_gib"]) == (ac.est.weights / 2**30,
                                         ac.est.kv_cache / 2**30,
                                         ac.est.peak_prefill / 2**30)
    assert (out["placement"], out["reason"], out["pipeline"],
            out["use_int4_kernel"], out["depth"]) == (
        ac.weight_placement, ac.reason, ac.pipeline, ac.use_int4_kernel,
        ac.preload_depth)
    cfg = jax_scaled_down(full, d_model=256, num_heads=8, num_kv_heads=4,
                          d_ff=1024, vocab_size=2048)
    jplan = EngineSpec(arch=full.name, cfg=cfg, offload=True,
                       placement=ac.weight_placement, pipeline=ac.pipeline,
                       b_max=2, max_len=96, depth=ac.preload_depth,
                       quant="int4", disk_root="/tmp/quickstart_disk"
                       ).resolve()
    want, got = jplan.to_json(), out["plan"].to_json()
    want.pop("disk_root")
    assert got.pop("disk_root").endswith("quickstart_torch_disk")
    assert got == want


def test_serve_offload_runs_on_the_cpu():
    out = _example("serve_offload_torch").main(["--device", "cpu"])
    assert out["completed"] == out["requests"] == 10
    assert out["engine"] == "resident"
    assert out["host_kv_bytes"] > 0          # finished slots spilled KV
    assert out["stats"]["prefills"] == 10
    assert out["stats"]["decode_steps"] < out["tokens_out"]
    assert out["tokens_out"] == sum(8 + (i % 5) for i in range(10))
    assert all(0 <= t < 1024 for o in out["outs"].values() for t in o)

    # the JAX example's engine from the same spec, on the same requests:
    # the same plan, the same scheduling counts and host KV bytes (exact)
    from repro.configs import get_config as jax_get_config
    from repro.configs import scaled_down as jax_scaled_down
    from repro.serving import EngineSpec, Request, create_engine
    cfg = jax_scaled_down(jax_get_config("tinyllama-1.1b"), d_model=128,
                          num_heads=8, num_kv_heads=4, vocab_size=1024)
    plan = EngineSpec(arch="tinyllama-1.1b", cfg=cfg, b_max=4,
                      max_len=128).resolve()
    assert out["plan"].to_json() == plan.to_json()
    eng = create_engine(plan)
    for i, (prompt, max_new) in enumerate(out["reqs"]):
        eng.submit(Request(rid=i, prompt=prompt.copy(), max_new=max_new))
    done = eng.run()
    assert len(done) == 10
    assert out["stats"] == dict(eng.stats)
    assert out["host_kv_bytes"] == eng.host.bytes_used
    assert out["tokens_out"] == sum(len(r.out) for r in done)


def test_train_100m_runs_on_the_cpu(tmp_path):
    steps = 8
    out = _example("train_100m_torch").main(
        ["--device", "cpu", "--d-model", "64", "--layers", "2", "--seq",
         "32", "--batch", "4", "--steps", str(steps), "--ckpt",
         str(tmp_path / "ckpt")])
    assert out["final_step"] == steps and len(out["losses"]) == steps
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", []), ("serve_offload_torch", []),
    ("train_100m_torch", ["--steps", "1", "--d-model", "64", "--layers",
                          "1"])])
def test_examples_need_a_card_unless_asked(name, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        _example(name).main(argv + (["--ckpt", str(tmp_path)]
                                    if name.startswith("train") else []))
