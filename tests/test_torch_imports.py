"""The port stands alone: in a fresh interpreter where ``jax`` cannot be
imported (``sys.modules["jax"] = None``), every module of
``repro_torch`` — ``models/moe.py`` among them —, ``chip_smoke.py`` and
the port's examples (``examples/*_torch.py``) import, and none of them
loads a ``jax*`` module or anything of the JAX package (``repro``,
``repro.*``).  One subprocess imports them all and
reports, per module, its error and the modules of either kind it
brought in."""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_PROBE = r"""
import importlib, importlib.util, json, sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
names = json.loads(sys.argv[2])
files = json.loads(sys.argv[3])
banned = lambda m: (m == "jax" or m.startswith(("jax.", "jaxlib"))
                    or m == "repro" or m.startswith("repro."))
out = {}
for name in names:
    before = set(sys.modules)
    try:
        if name in files:
            spec = importlib.util.spec_from_file_location(name, files[name])
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        else:
            importlib.import_module(name)
        err = None
    except BaseException as e:
        err = f"{type(e).__name__}: {e}"
    loaded = sorted(m for m in set(sys.modules) - before
                    if banned(m) and sys.modules[m] is not None)
    out[name] = {"error": err, "banned": loaded}
print(json.dumps(out))
"""


# modules loaded from their files: the script and the examples
FILES = {"chip_smoke": str(ROOT / "chip_smoke.py"),
         **{f"examples.{p.stem}": str(p)
            for p in sorted((ROOT / "examples").glob("*_torch.py"))}}


def _modules():
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(SRC / "repro_torch")],
                                              prefix="repro_torch.")]
    return sorted(names) + list(FILES)


MODULES = _modules()


@pytest.fixture(scope="module")
def probe():
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, str(SRC), json.dumps(MODULES),
         json.dumps(FILES)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_every_module_is_probed():
    assert "repro_torch.models.moe" in MODULES
    assert "repro_torch.serving.offload_engine" in MODULES
    for name in ("optim.adamw", "optim.adafactor", "data.pipeline",
                 "checkpoint.ckpt", "runtime.compression",
                 "runtime.fault_tolerance", "launch.steps", "launch.train",
                 "launch.mesh", "launch.sharding", "launch.ranks",
                 "models.common", "tree"):
        assert f"repro_torch.{name}" in MODULES
    assert len(MODULES) > 50
    for name in ("quickstart_torch", "serve_offload_torch",
                 "train_100m_torch"):
        assert f"examples.{name}" in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_imports_without_jax(probe, name):
    res = probe[name]
    assert res["error"] is None, res["error"]
    assert res["banned"] == [], res["banned"]
