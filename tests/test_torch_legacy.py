"""The engines' legacy keyword construction in the port against the JAX
package's shim, on the CPU.

``OffloadedServingEngine(cfg, **kwargs)`` and ``PipelinedLM(cfg,
**kwargs)`` overlay the keywords on the pre-spec defaults, resolve the
``EngineSpec`` they make and warn once per process
(``serving.spec.warn_deprecated_once``).  Over the JAX tests' keyword
sets and INT4 / disk sets, the port's legacy plan equals its spec-path
plan, and its JSON equals the JAX shim's for the same keywords; the
warning fires once and again after ``reset_deprecation_warnings``; an
unknown keyword, a plan with keywords or any other first argument
raises ``TypeError``; whisper warns, then raises
``UnsupportedModelError("enc_dec")``.  ``device``, ``weights`` and
``draws`` stay the port's own parameters.  Tolerance: exact equality
throughout."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import scaled_down as jax_scaled_down  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core.engine import PipelinedLM as JaxPipelinedLM  # noqa: E402
from repro.serving import EngineSpec as JaxEngineSpec  # noqa: E402
from repro.serving import OffloadedServingEngine as JaxOffloaded  # noqa: E402
from repro.serving import offload_engine as jax_offload_engine  # noqa: E402
from repro_torch.configs import get_config, scaled_down  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.engine import PipelinedLM  # noqa: E402
from repro_torch.core.engine import _LEGACY_DEFAULTS as _LM_DEFAULTS  # noqa: E402
from repro_torch.serving import spec as PS  # noqa: E402
from repro_torch.serving.base import Request  # noqa: E402
from repro_torch.serving.offload_engine import (  # noqa: E402
    DrawCache, OffloadedServingEngine)
from repro_torch.serving.offload_engine import (  # noqa: E402
    _LEGACY_DEFAULTS as _SERVING_DEFAULTS)

ARCH = "tinyllama-1.1b"

# the JAX tests' keyword sets (tests/test_spec.py, test_serving_offload.py,
# test_engine.py), then INT4 weights and KV, and the disk tier
SERVING_KW = {
    "int4_depth2": dict(b_max=2, max_len=64, placement="host",
                        quant="int4", depth=2),
    "b1": dict(b_max=1, max_len=32, placement="host"),
    "cold": dict(b_max=2, max_len=64, placement="host",
                 pipeline="performance", warm=False),
    "b4": dict(b_max=4, max_len=64, placement="host",
               pipeline="performance"),
    "int4_kv_disk": dict(b_max=2, max_len=48, placement="disk",
                         quant="int4", kv_mode="int4", disk=True),
    "sequential_sim": dict(b_max=2, max_len=48, pipeline="sequential",
                           sim_bw=1e12, spill_cap=8, seed=3),
}
LM_KW = {
    "host": dict(batch=2, max_len=32, placement="host"),
    "kv_int4": dict(batch=2, max_len=48, placement="host",
                    pipeline="performance", kv_mode="int4", disk=True),
    "int4_disk_seq": dict(batch=2, max_len=48, placement="disk",
                          pipeline="sequential", quant="int4", disk=True),
    "device_cache": dict(batch=2, max_len=32, placement="device",
                         cache_on="device", depth=2, seed=5),
}


@pytest.fixture(autouse=True)
def _fresh_port_warnings():
    """The port's dedup set, reset per test (the JAX package's is reset
    by ``tests/conftest.py``)."""
    PS.reset_deprecation_warnings()
    yield
    PS.reset_deprecation_warnings()


def _cfgs():
    return (scaled_down(get_config(ARCH)),
            jax_scaled_down(jax_get_config(ARCH)))


def _kw(kw, tmp_path):
    """The keyword set with a ``disk_root`` under the test's directory
    (the JAX engines build their disk store whatever the placement, so
    the default root is held by ``test_legacy_defaults_match_jax``
    alone); ``disk=True`` only marks the sets that place on disk."""
    kw = dict(kw)
    kw.pop("disk", None)
    kw["disk_root"] = str(tmp_path / "disk")
    return kw


def _jax_legacy(cls, cfg, kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return cls(cfg, **kw)


@pytest.mark.parametrize("name", sorted(SERVING_KW))
def test_offloaded_legacy_plan_equals_spec_and_jax(name, tmp_path):
    pcfg, jcfg = _cfgs()
    kw = _kw(SERVING_KW[name], tmp_path)
    with pytest.warns(DeprecationWarning):
        leg = OffloadedServingEngine(pcfg, device="cpu", **kw)
    plan = PS.EngineSpec(arch=pcfg.name, cfg=pcfg, offload=True,
                         **{**_SERVING_DEFAULTS, **kw}).resolve()
    assert leg.plan == plan
    assert leg.dev.type == "cpu"
    jleg = _jax_legacy(JaxOffloaded, jcfg, kw)
    assert leg.plan.to_json() == jleg.plan.to_json()
    leg.shutdown()
    jleg.shutdown()


@pytest.mark.parametrize("name", sorted(LM_KW))
def test_pipelined_lm_legacy_plan_equals_spec_and_jax(name, tmp_path):
    pcfg, jcfg = _cfgs()
    kw = _kw(LM_KW[name], tmp_path)
    with pytest.warns(DeprecationWarning):
        leg = PipelinedLM(pcfg, device="cpu", **kw)
    lm = PS.build_lm(_lm_spec(PS.EngineSpec, pcfg, kw), device="cpu")
    assert leg.plan == lm.plan
    assert leg.plan.to_json() == lm.plan.to_json()
    assert leg.dev.type == "cpu"
    jleg = _jax_legacy(JaxPipelinedLM, jcfg, kw)
    assert leg.plan.to_json() == jleg.plan.to_json()


def _lm_spec(spec_cls, cfg, kw):
    """The ``EngineSpec`` a legacy ``PipelinedLM(cfg, **kw)`` stands for:
    the keywords over the pre-spec defaults, ``batch`` as ``b_max``."""
    full = {**_LM_DEFAULTS, **kw}
    full["b_max"] = full.pop("batch")
    return spec_cls(arch=cfg.name, cfg=cfg, offload=True, **full)


def test_pipelined_lm_legacy_defaults_match_jax():
    """No keyword at all: depth 1 (not auto) and the JAX package's
    ``disk_root``, as its pre-spec constructor had them.  The defaults
    are the JAX modules' own, and the plan is the JAX spec's resolved
    (no JAX engine built: it would make its disk root)."""
    assert _LM_DEFAULTS == jax_engine._LEGACY_DEFAULTS
    assert _SERVING_DEFAULTS == jax_offload_engine._LEGACY_DEFAULTS
    pcfg, jcfg = _cfgs()
    with pytest.warns(DeprecationWarning):
        leg = PipelinedLM(pcfg, device="cpu")
    jplan = _lm_spec(JaxEngineSpec, jcfg, {}).resolve()
    assert leg.plan.to_json() == jplan.to_json()
    assert leg.plan.depth == 1 and leg.plan.disk_root == "/tmp/pipo_disk"


@pytest.mark.parametrize("which", ["offloaded", "lm"])
def test_legacy_warns_once_per_process(which):
    pcfg, _ = _cfgs()
    if which == "offloaded":
        build = lambda: OffloadedServingEngine(  # noqa: E731
            pcfg, device="cpu", b_max=1, max_len=32,
            placement="host").shutdown()
    else:
        build = lambda: PipelinedLM(  # noqa: E731
            pcfg, device="cpu", batch=1, max_len=32, placement="host")
    with pytest.warns(DeprecationWarning, match="is deprecated"):
        build()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        build()
    PS.reset_deprecation_warnings()
    with pytest.warns(DeprecationWarning):
        build()


def test_warn_deprecated_once_keys_apart():
    """One warning per key: the two engines' keys do not share it."""
    with pytest.warns(DeprecationWarning) as rec:
        PS.warn_deprecated_once("a", "first a")
        PS.warn_deprecated_once("a", "second a")
        PS.warn_deprecated_once("b", "first b")
    assert [str(w.message) for w in rec] == ["first a", "first b"]
    assert {"warn_deprecated_once",
            "reset_deprecation_warnings"} <= set(PS.__all__)


@pytest.mark.parametrize("cls", [OffloadedServingEngine, PipelinedLM])
def test_legacy_unknown_key_raises(cls):
    pcfg, _ = _cfgs()
    with pytest.warns(DeprecationWarning):
        with pytest.raises(TypeError, match="unknown kwargs"):
            cls(pcfg, device="cpu", max_len=32, bogus=1)


@pytest.mark.parametrize("cls,kw", [(OffloadedServingEngine, {"b_max": 4}),
                                    (PipelinedLM, {"batch": 4})])
def test_plan_with_legacy_kwargs_raises(cls, kw):
    plan = PS.EngineSpec(arch=ARCH, scaled=True, offload=True, b_max=1,
                         max_len=32).resolve()
    with pytest.raises(TypeError, match="takes no kwargs"):
        cls(plan, device="cpu", **kw)


@pytest.mark.parametrize("cls", [OffloadedServingEngine, PipelinedLM])
def test_other_first_argument_raises(cls):
    with pytest.raises(TypeError, match="ResolvedPlan or a ModelConfig"):
        cls(ARCH, device="cpu")


def test_whisper_warns_then_unsupported():
    whisper = scaled_down(get_config("whisper-base"))
    with pytest.warns(DeprecationWarning):
        with pytest.raises(PS.UnsupportedModelError) as ei:
            OffloadedServingEngine(whisper, device="cpu", b_max=1,
                                   max_len=32)
    assert ei.value.capability == "enc_dec"


def _serve(eng, prompts, max_new=5):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.copy(), max_new=max_new))
    done = eng.run()
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


def test_legacy_keeps_draws_and_device():
    """``draws`` is the port's own parameter: a legacy engine built from
    a ``DrawCache`` after a spec-path engine takes its tables and serves
    its tokens."""
    pcfg, _ = _cfgs()
    kw = dict(b_max=2, max_len=48, placement="host", quant="int4")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pcfg.vocab_size, (6 + i,)).astype(np.int32)
               for i in range(3)]
    plan = PS.EngineSpec(arch=pcfg.name, cfg=pcfg, offload=True,
                         **{**_SERVING_DEFAULTS, **kw}).resolve()
    with DrawCache() as draws:
        ref = _serve(PS.create_engine(plan, device="cpu", draws=draws),
                     prompts)
        kept = dict(draws._kept)
        with pytest.warns(DeprecationWarning):
            leg = OffloadedServingEngine(pcfg, device="cpu", draws=draws,
                                         **kw)
        assert draws._kept.keys() == kept.keys()
        assert all(draws._kept[k] is v for k, v in kept.items())
        assert _serve(leg, prompts) == ref


def test_legacy_keeps_weights():
    """``weights`` is the port's own parameter: a legacy ``PipelinedLM``
    loading a spec-path engine's weights generates its tokens."""
    pcfg, _ = _cfgs()
    spec = PS.EngineSpec(arch=pcfg.name, cfg=pcfg, offload=True,
                         placement="host", b_max=2, max_len=32, depth=1,
                         seed=7, disk_root="/tmp/pipo_disk")
    lm = PS.build_lm(spec, device="cpu")
    prompt = np.random.default_rng(1).integers(
        0, pcfg.vocab_size, (2, 8)).astype(np.int32)
    ref, _ = lm.generate(prompt, 6)
    with pytest.warns(DeprecationWarning):
        leg = PipelinedLM(pcfg, device="cpu",
                          weights=convert.lm_weights(lm), batch=2,
                          max_len=32, placement="host")
    assert dataclasses.replace(leg.plan, seed=7) == lm.plan
    toks, _ = leg.generate(prompt, 6)
    np.testing.assert_array_equal(toks, ref)
