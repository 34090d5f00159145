"""The port's training loss against the JAX package's, dense families.

On the same weights (the JAX ``init`` carried over leaf for leaf) and
the same seeded batch, ``train_loss`` agrees within 1e-5 relative and
every gradient leaf within 1e-4 x that leaf's max |g|, at ``scaled_down``
(b 2, s 32): tinyllama, granite, gemma3 (sliding window), qwen3
(``qk_norm``) and qwen2-vl (``embeds``, M-RoPE).  Also tinyllama at s
1024 (two 512-row query chunks) and s 1040 (one block: 1040 is no
multiple of 512) and at bf16 (loss within 2e-2 relative), remat on
against off bit for bit, ``param_struct``/``param_axes`` against the
reference's, the kernel ops' guard against autograd, and the train CLI.
The MoE, MLA, SSM and encoder-decoder families are in
``tests/test_torch_train_families.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from train_cases import (assert_grads_close, batch, configs, jax_loss_grads,
                         jax_params, port_loss_grads, port_params)

DENSE = ["tinyllama-1.1b", "granite-8b", "gemma3-4b", "qwen3-8b",
         "qwen2-vl-72b"]


def _check(arch, s=32, **overrides):
    jc, pc = configs(arch, **overrides)
    params = jax_params(jc)
    b = batch(jc, s=s)
    jl, jg = jax_loss_grads(jc, params, b)
    pl, pg = port_loss_grads(pc, port_params(params), b)
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert_grads_close(jg, pg)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    _check(arch)


@pytest.mark.parametrize("s", [1024, 1040])
def test_long_sequence_across_query_chunks(s):
    _check("tinyllama-1.1b", s=s)


def test_bf16_loss_matches_reference():
    """bf16 parameters and activations in both packages: the loss within
    2e-2 relative."""
    jc, pc = configs("tinyllama-1.1b")
    params = jax_params(jc, jnp.bfloat16)
    b = batch(jc)
    jl, _ = jax_loss_grads(jc, params, b, jnp.bfloat16)
    pp = port_params(params)
    assert pp["embed"]["emb"].dtype == torch.bfloat16
    pl, pg = port_loss_grads(pc, pp, b, dtype=torch.bfloat16)
    assert np.isfinite(pl)
    assert abs(pl - jl) <= 2e-2 * abs(jl), (pl, jl)
    assert all(np.isfinite(g).all() for _, g in pg)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
def test_remat_is_bit_exact(arch):
    jc, pc = configs(arch)
    pp = port_params(jax_params(jc))
    b = batch(jc)
    on = port_loss_grads(pc, pp, b, remat=True)
    off = port_loss_grads(pc, pp, b, remat=False)
    assert on[0] == off[0]
    for (p1, g1), (p2, g2) in zip(on[1], off[1]):
        assert p1 == p2 and np.array_equal(g1, g2), p1


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "mamba2-1.3b", "whisper-base"])
def test_param_struct_and_axes_match_reference(arch):
    from repro.models import transformer as JT
    from repro_torch import tree as PT
    from repro_torch.models import transformer as T
    jc, pc = configs(arch)
    want = jax.tree_util.tree_flatten_with_path(
        JT.param_struct(jc, jnp.bfloat16))[0]
    got = PT.flatten_with_path(T.param_struct(pc, torch.bfloat16))
    assert len(want) == len(got)
    for (jp, js), (pp, pt) in zip(want, got):
        assert "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in jp) == pp
        assert tuple(js.shape) == tuple(pt.shape), pp
        assert str(js.dtype) == str(pt.dtype).split(".")[1], pp
        assert pt.device.type == "meta"
    assert T.param_axes(pc) == JT.param_axes(jc)


# ---------------------------------------------------------------------------
# the kernel ops refuse to differentiate; serving is unaffected
# ---------------------------------------------------------------------------

def test_kernel_ops_raise_on_grad():
    from repro_torch.kernels import ops
    from repro_torch.quant.int4 import quantize_int4
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((1, 8, 4, 16)),
                            dtype=torch.float32) for _ in range(3))
    q.requires_grad_(True)
    calls = [
        lambda: ops.flash_attention_op(q, k, v),
        lambda: ops.decode_attention_op(q[:, 0], k, v, 3),
        lambda: ops.int4_matmul_op(q.reshape(8, 64), *quantize_int4(
            torch.ones(64, 32), 32), group=32),
    ]
    kc = torch.zeros(1, 8, 64)
    packed, scale = torch.zeros(1, 8, 32, dtype=torch.uint8), kc[..., :2]
    calls.append(lambda: ops.decode_attention_int4_op(
        q[:, 0], packed, scale, packed, scale, 3, hkv=4, group=32))
    for call in calls:
        with pytest.raises(ops.NoGradError, match="no backward"):
            call()
        with torch.no_grad():            # no grad mode: the op runs
            assert torch.isfinite(call()).all()
    for call in calls:                   # the inputs were not detached
        assert q.requires_grad and q.grad is None


def test_serving_paths_unaffected_by_guard():
    """Prefill and decode (flash and decode attention on the CPU's plain
    versions) run with grad mode on, as the engines do: no parameter or
    cache requires grad."""
    from repro_torch.models.model import build_model
    jc, pc = configs("tinyllama-1.1b")
    model = build_model(pc)
    params = port_params(jax_params(jc))
    assert torch.is_grad_enabled()
    toks = torch.tensor(batch(jc, s=8)["tokens"])
    nxt, caches = model.prefill(params, {"tokens": toks}, 16)
    tok, _ = model.decode_step(params, {"token": nxt[:, None], "pos": 8},
                               caches)
    assert tok.shape == (2,)


@pytest.mark.parametrize("engine", ["resident", "offloaded", "batch"])
def test_engines_serve_with_grad_off(engine, monkeypatch):
    """The serving engines' step and the batch engine's ``generate`` run
    with grad mode off: every kernel op they call sees it off, so the
    guard returns at once and autograd keeps no records."""
    from repro_torch.kernels import ops
    from repro_torch.serving.base import Request
    from repro_torch.serving.spec import EngineSpec, build_lm, create_engine
    seen = []
    guard = ops._no_grad

    def spy(op, *tensors):
        seen.append(torch.is_grad_enabled())
        return guard(op, *tensors)
    monkeypatch.setattr(ops, "_no_grad", spy)
    spec = EngineSpec(arch="tinyllama-1.1b", scaled=True, b_max=2,
                      max_len=32, offload=engine != "resident",
                      quant="int4" if engine != "resident" else None)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (2, 6)).astype(np.int32)
    assert torch.is_grad_enabled()
    if engine == "batch":
        toks, _ = build_lm(spec, device="cpu").generate(prompts, 3)
        assert toks.shape == (2, 3)
    else:
        eng = create_engine(spec, device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=3))
        done = eng.run()
        eng.shutdown()
        assert [len(r.out) for r in done] == [3, 3]
    assert torch.is_grad_enabled()
    assert seen and not any(seen)


def test_train_cli_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", "tinyllama-1.1b", "--scaled", "--device",
                      "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
                      "--ckpt", str(tmp_path)])
    text = capsys.readouterr().out
    assert "done: step=2 last_loss=" in text
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["params"]["embed"]["emb"].dtype == torch.bfloat16
    assert (tmp_path / "step_2" / "manifest.json").exists()


@pytest.mark.parametrize("flag", [["--multi-pod"], ["--coordinator"],
                                  ["--fake-devices", "8"]])
def test_train_cli_mesh_flags_raise(flag, tmp_path):
    """The mesh flags raised ``NotImplementedError`` until the sharding
    slice was ported; now each trains one step on its path:
    ``--multi-pod`` below 512 ranks on one device, ``--coordinator`` as
    the one rank of a group on a free localhost port, ``--fake-devices
    8`` on eight gloo CPU ranks and a (2, 4) mesh."""
    import socket
    from repro_torch.launch import train
    if flag == ["--coordinator"]:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        flag = ["--coordinator", f"localhost:{port}", "--num-hosts", "1",
                "--host-id", "0"]
    out = train.main(["--arch", "tinyllama-1.1b", "--scaled", "--device",
                      "cpu", "--steps", "1", "--seq", "32", "--batch", "8",
                      "--ckpt", str(tmp_path)] + flag)
    assert out["final_step"] == 1 and np.isfinite(out["losses"]).all()


def test_train_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "tinyllama-1.1b", "--scaled", "--steps", "1",
                    "--ckpt", str(tmp_path)])


def test_prefill_and_decode_steps():
    """``make_prefill_step``/``make_decode_step`` are the model's prefill
    and decode under ``torch.no_grad``."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import build_model
    jc, pc = configs("tinyllama-1.1b")
    model = build_model(pc)
    params = port_params(jax_params(jc))
    toks = torch.tensor(batch(jc, s=8)["tokens"])
    nxt, caches = make_prefill_step(model, 16)(params, {"tokens": toks})
    want, _ = model.prefill(params, {"tokens": toks}, 16)
    assert torch.equal(nxt, want)
    tok, _ = make_decode_step(model)(params, {"token": nxt[:, None],
                                              "pos": 8}, caches)
    assert tok.shape == (2,) and tok.dtype == torch.int32
