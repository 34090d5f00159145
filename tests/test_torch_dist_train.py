"""The launcher's mesh paths and elastic checkpoints on gloo CPU ranks.

  * ``launch.train.main`` with ``--fake-devices 8 --device cpu`` trains
    scaled granite-8b on a (2, 4) mesh (bf16 parameters under
    ``param_pspecs``, AdamW moments under ``zero_pspecs``): its losses
    equal the one-device run's within 2e-4 (relative), and a run resumed
    across the two (8 ranks -> 1 device, 1 device -> 8 ranks) continues
    the uninterrupted one's losses within 2e-4; ``--coordinator`` joins
    a one-rank group (a free localhost port) and trains as one device
    does, ``--fake-devices 4`` (no mesh below 8, as in the reference)
    trains in one process as one device does and writes each checkpoint
    once, and ``--fake-devices`` with ``--device cuda`` raises;
  * a checkpoint saved sharded at world 4 restores bit for bit at world
    1 (unplaced), in the JAX package, and at world 8 under its (2, 4)
    mesh's specs; one the JAX package saved restores onto a (2, 2) mesh
    bit for bit.
Each rank runs with one intra-op thread; the ranks' side is in
``tests/dist_cases.py``."""
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_cases as DC
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import ASSIGNED
from repro.configs import scaled_down as jax_scaled_down
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch import ranks
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.tree import flatten_with_path

ARCH = "granite-8b"
TOL = 2e-4


def argv(ckpt, steps, *extra):
    return ["--arch", ARCH, "--scaled", "--device", "cpu", "--steps",
            str(steps), "--seq", "32", "--batch", "8", "--ckpt", str(ckpt),
            *extra]


def rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    out = {"whole": train.main(argv(root / "whole", 3)),
           "mesh8": train.main(argv(root / "a", 2, "--fake-devices", "8"))}
    out["resume1"] = train.main(argv(root / "a", 3))
    out["one2"] = train.main(argv(root / "d", 2))
    out["resume8"] = train.main(argv(root / "d", 3, "--fake-devices", "8"))
    out["fake4"] = train.main(argv(root / "f4", 3, "--fake-devices", "4"))
    out["fake4_dir"] = root / "f4"
    return out


def test_fake_devices_8_matches_one_device(runs):
    assert runs["mesh8"]["final_step"] == 2
    assert rel(runs["mesh8"]["losses"], runs["whole"]["losses"][:2]) <= TOL


@pytest.mark.parametrize("name", ("resume1", "resume8"))
def test_resume_across_world_sizes(runs, name):
    got = runs[name]
    assert got["final_step"] == 3 and got["restore_s"] is not None
    assert len(got["losses"]) == 1
    assert rel(got["losses"], runs["whole"]["losses"][2:]) <= TOL


def test_fake_devices_below_8_train_as_one_device(runs):
    got, want = runs["fake4"], runs["whole"]
    assert got["final_step"] == 3 and got["losses"] == want["losses"]
    assert [t["step"] for t in got["ckpt_s"]] == [3]
    d = runs["fake4_dir"]
    assert sorted(p.name for p in d.iterdir()) == ["step_3"]
    back, manifest = restore_checkpoint(
        str(d), 3, {"params": got["params"], "opt": got["opt_state"]})
    assert manifest["step"] == 3
    for (path, a), (_, b) in zip(
            flatten_with_path(back),
            flatten_with_path({"params": got["params"],
                               "opt": got["opt_state"]})):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)


def test_fake_devices_4_print_no_mesh(tmp_path, capfd):
    train.main(argv(tmp_path, 1, "--fake-devices", "4"))
    out = capfd.readouterr().out
    assert out.count("devices=4 (cpu) mesh=None") == 1
    assert out.count("done: step=1") == 1


def test_mesh_line_printed_once(tmp_path, capfd):
    train.main(argv(tmp_path, 1, "--fake-devices", "8"))
    out = capfd.readouterr().out
    assert out.count("devices=8 (cpu) mesh={'data': 2, 'model': 4}") == 1
    assert out.count("done: step=1") == 1


def test_coordinator_matches_one_device(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    got = train.main(argv(tmp_path / "c", 1, "--coordinator",
                          f"localhost:{port}", "--num-hosts", "1",
                          "--host-id", "0"))
    want = train.main(argv(tmp_path / "w", 1))
    assert got["losses"] == want["losses"]


def test_fake_devices_need_the_cpu(tmp_path):
    with pytest.raises(ValueError, match="--device cpu"):
        train.main(["--arch", ARCH, "--scaled", "--fake-devices", "2",
                    "--ckpt", str(tmp_path)])


# ---------------------------------------------------------------------------
# checkpoints across world sizes and packages
# ---------------------------------------------------------------------------

def _bits(t):
    return DC._bits(t) if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    cfg = jax_scaled_down(ASSIGNED[ARCH], **DC.SCALE)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(3), jnp.bfloat16)
    jstate = {"params": params, "opt": JaxAdamW().init(params)}
    jstate["opt"]["m"] = jax.tree.map(lambda x: x + 0.5, jstate["opt"]["m"])
    jax_save(os.path.join(root, "ckptj"), 1, jstate)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (DC.B, DC.S))
             .astype(np.int32) for k in ("labels", "tokens")}
    np.savez(os.path.join(root, f"batch_{ARCH}.npz"), **batch)
    ranks.spawn(DC.ckpt_world4, 4, (root, ARCH), store_dir=root)
    ranks.spawn(DC.ckpt_world8, 8, (root, ARCH), store_dir=root)
    return root, jstate


def _world1(root):
    cfg = DC.config(ARCH)
    ps = T.param_struct(cfg)
    target = {"params": ps, "opt": {"m": ps, "v": ps,
                                    "step": torch.zeros((), dtype=torch.int32)}}
    return restore_checkpoint(os.path.join(root, "ckpt4"), 1, target)[0]


def test_world4_checkpoint_restores_at_world1_and_in_jax(ckpts):
    root, _ = ckpts
    one = _world1(root)
    flat = flatten_with_path(one)
    assert int(one["opt"]["step"]) == 1
    jtarget = jax.tree.map(lambda x: x, _jax_like(one))
    back, _ = jax_restore(os.path.join(root, "ckpt4"), 1, jtarget)
    jflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert len(jflat) == len(flat)
    for (path, t), (_, j) in zip(flat, jflat):
        want = _bits(t)
        got = np.asarray(j)
        got = got.view(np.int16) if got.dtype.name == "bfloat16" else got
        np.testing.assert_array_equal(got, want, err_msg=path)


def _jax_like(tree):
    """A JAX target of the port tree's shapes and dtypes."""
    def one(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 else (
            jnp.int32 if t.dtype == torch.int32 else jnp.float32)
        return jnp.zeros(tuple(t.shape), dt)
    from repro_torch.tree import tree_map
    return tree_map(one, tree)


def test_world4_checkpoint_restores_at_world8(ckpts):
    root, _ = ckpts
    want = {p: _bits(t) for p, t in flatten_with_path(_world1(root))}
    got = np.load(os.path.join(root, "w8.npz"))
    local = np.load(os.path.join(root, "w8_local.npz"))
    assert sorted(got.files) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    # the (2, 4) mesh splits the model axis four ways: wq's heads_ff dim
    n, d, hd = want["params/pat/0/wq"].shape
    assert tuple(local["params/pat/0/wq"]) == (n, d, hd // 4)


def test_jax_checkpoint_restores_onto_2x2_mesh(ckpts):
    root, jstate = ckpts
    got = np.load(os.path.join(root, "from_jax_w4.npz"))
    assert bool(got["placed"])
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    for path, leaf in jflat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        want = np.asarray(leaf)
        want = want.view(np.int16) if want.dtype.name == "bfloat16" else want
        np.testing.assert_array_equal(got[key], want, err_msg=key)
