"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``src/repro/launch/dryrun.py``), on the CPU with no card:

  * the registry's cell helpers (``get_shape``, ``list_archs``,
    ``all_cells``: 40 cells, the same runnable ones and skip reasons);
  * ``--serving --all`` and ``--replay`` on each of the five golden
    fixtures: the port's output equals the reference's line for line (the
    reference runs in a subprocess, ``python -m repro.launch.dryrun``:
    its first lines set ``XLA_FLAGS`` to 512 host devices for the whole
    process);
  * every runnable cell's per-device argument bytes (parameters,
    optimizer state, batch, caches) on both production meshes in both
    variants, exactly, against the same sum over the reference's own
    spec trees and structs (arithmetic, no compile);
  * traced cells on the abstract meshes: an ``ok`` row with the
    reference's keys (the H100's link keys), a ``w4`` decode whose packed
    projections are priced by ``int4_matmul``'s cost, a ``w4`` train cell
    that errors with the reference's reason, and ``main`` exiting
    non-zero on it.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ASSIGNED as JAX_ASSIGNED  # noqa: E402
from repro.configs import all_cells as jax_all_cells  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_shape as jax_shape  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro_torch.configs import (ASSIGNED, SHAPES, all_cells,  # noqa: E402
                                 get_shape, list_archs, shape_applicable)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.roofline.analysis import block_bytes  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = sorted((ROOT / "tests" / "fixtures").glob("trace_*.json"))
RUNNABLE = [(a, s) for a, s, ok, _ in all_cells() if ok]


def test_cell_helpers_match_reference():
    assert list_archs() == jax_list_archs()
    assert all_cells() == jax_all_cells()
    assert len(all_cells()) == 40 and len(RUNNABLE) == 33
    for name in SHAPES:
        a, b = get_shape(name), jax_shape(name)
        assert (a.name, a.kind, a.seq_len, a.global_batch) == \
            (b.name, b.kind, b.seq_len, b.global_batch)
    with pytest.raises(KeyError):
        get_shape("train_1m")


def _reference(*argv) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", *argv],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.splitlines()


def _port(capsys, *argv) -> list:
    capsys.readouterr()
    D.main(list(argv))
    return capsys.readouterr().out.splitlines()


def test_serving_all_matches_reference(capsys):
    want = _reference("--serving", "--all")
    got = _port(capsys, "--serving", "--all")
    assert len(got) > len(ASSIGNED)
    assert got == want


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_replay_matches_reference(fixture, capsys):
    rel = str(fixture.relative_to(ROOT))
    want = _reference("--replay", rel)
    got = _port(capsys, "--replay", rel)
    assert got[0].startswith("[TRACE]") and len(got) == 14
    assert got == want


# ---------------------------------------------------------------------------
# per-device argument bytes, against the reference's spec-tree arithmetic
# ---------------------------------------------------------------------------

def _local_bytes(struct, spec, sizes) -> int:
    n = 1
    spec = tuple(spec) + (None,) * (len(struct.shape) - len(tuple(spec)))
    for dim, ax in zip(struct.shape, spec):
        axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * struct.dtype.itemsize


def _tree_bytes(structs, specs, sizes) -> int:
    sl = jax.tree_util.tree_leaves(structs)
    pl = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    assert len(sl) == len(pl)
    return sum(_local_bytes(s, p.spec, sizes) for s, p in zip(sl, pl))


def reference_arg_bytes(arch, shape_name, multi_pod, variant) -> int:
    """The reference dry run's arguments (``lower_cell``) at one device:
    each leaf's block under its spec, summed."""
    from repro.launch import sharding as JS
    from repro.models import transformer as JT
    from repro.models.model import build_model
    from repro.optim.adafactor import Adafactor
    cfg = jax_config(arch)
    if variant == "w4":
        cfg = dataclasses.replace(cfg, quant_weights=True)
    shape = jax_shape(shape_name)
    shp, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    mesh = jax.sharding.AbstractMesh(shp, axes)
    sizes = dict(zip(axes, shp))
    dist = JS.make_dist(mesh, shape)
    model = build_model(cfg)
    m = sizes["model"]
    enc_pad = ((cfg.encoder_seq_len + m - 1) // m) * m if cfg.enc_dec else 0
    total = _tree_bytes(JT.param_struct(cfg), JS.param_pspecs(cfg, dist),
                        sizes)
    total += _tree_bytes(model.input_struct(shape, enc_pad),
                         JS.batch_pspecs(cfg, shape, dist, enc_pad), sizes)
    if shape.kind == "train":
        if cfg.param_count() > 60e9:
            opt = Adafactor()
            total += _tree_bytes(JS.adafactor_struct(cfg, opt),
                                 JS.adafactor_pspecs(cfg, dist, opt), sizes)
        else:
            total += _tree_bytes(JS.opt_struct(cfg),
                                 JS.zero_pspecs(cfg, dist), sizes)
    elif shape.kind == "decode":
        cs, _ = model.cache_struct(shape.global_batch, shape.seq_len,
                                   enc_pad or None)
        total += _tree_bytes(cs, JS.cache_pspecs(
            cfg, dist, shape.global_batch, shape.seq_len, enc_pad or None),
            sizes)
    return total


@pytest.mark.parametrize("variant", ["base", "w4"])
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_argument_bytes_match_reference(arch, multi_pod, variant):
    for a, s in RUNNABLE:
        if a != arch:
            continue
        _, _, _, args = D.cell_args(a, s, multi_pod, variant)
        got = sum(block_bytes(list(args)).values())
        assert got == reference_arg_bytes(a, s, multi_pod, variant), (a, s)


# ---------------------------------------------------------------------------
# traced cells
# ---------------------------------------------------------------------------

def test_traced_cell_row(tmp_path):
    """whisper-base's decode on the single pod: an ``ok`` row with the
    reference's terms; ``bytes_per_device`` is temp + arguments +
    outputs - aliases (the caches, updated in place)."""
    row = D.run_cell("whisper-base", "decode_32k", False, tmp_path)
    assert row["status"] == "ok", row.get("trace")
    for k in ("bytes_per_device", "temp_bytes", "arg_bytes", "out_bytes",
              "alias_bytes", "t_compute_s", "t_memory_s", "t_collective_s",
              "bottleneck", "t_bound_s", "hbm_bytes", "nvlink_bytes",
              "ib_bytes", "coll_count", "model_flops_total",
              "flops_useful_ratio", "roofline_fraction", "coll_breakdown"):
        assert k in row, k
    assert row["bytes_per_device"] == (row["temp_bytes"] + row["arg_bytes"]
                                       + row["out_bytes"]
                                       - row["alias_bytes"])
    assert row["alias_bytes"] > 0 and row["coll_count"] > 0
    # the model axis (16 ranks) spans two 8-card nodes: its collectives
    # go over the NICs
    assert row["ib_bytes"] > 0
    assert row["arg_bytes"] == reference_arg_bytes("whisper-base",
                                                   "decode_32k", False,
                                                   "base")
    assert (tmp_path / "whisper-base_decode_32k_pod16x16_base.json").exists()


def test_w4_decode_prices_int4_matmul(tmp_path):
    """tinyllama's w4 decode: every packed projection (``wq``, ``wk``,
    ``wv``, ``wo``: 4 a layer, the feed-forward skipped as in the
    reference) is one ``int4_matmul`` priced at its packed bytes."""
    row = D.run_cell("tinyllama-1.1b", "decode_32k", False, tmp_path, "w4")
    assert row["status"] == "ok", row.get("trace")
    k = row["kernels"]["int4_matmul"]
    assert k["count"] == 4 * 22
    base = D.run_cell("tinyllama-1.1b", "decode_32k", False, tmp_path)
    assert "int4_matmul" not in base["kernels"]
    assert row["arg_bytes"] < base["arg_bytes"]


def test_w4_train_errors_with_the_reference_reason(tmp_path, capsys):
    row = D.run_cell("whisper-base", "train_4k", False, tmp_path, "w4")
    assert row["status"] == "error"
    assert row["error"].startswith(
        "TypeError: grad requires real- or complex-valued inputs")
    assert "uint8" in row["error"]
    with pytest.raises(SystemExit, match="1 cells failed"):
        D.main(["--arch", "whisper-base", "--shape", "train_4k",
                "--variant", "w4", "--out", str(tmp_path)])
    assert "[ERR ] whisper-base" in capsys.readouterr().out


def test_skip_follows_shape_applicable(tmp_path):
    row = D.run_cell("granite-8b", "long_500k", True, tmp_path)
    ok, why = shape_applicable(ASSIGNED["granite-8b"], SHAPES["long_500k"])
    assert not ok and row == {"arch": "granite-8b", "shape": "long_500k",
                              "mesh": "pod2x16x16", "variant": "base",
                              "status": "skip", "reason": why}
    assert JAX_ASSIGNED["granite-8b"].name == "granite-8b"
