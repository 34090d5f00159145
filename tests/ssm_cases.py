"""Shared set-up of the SSM serving tests (``test_torch_ssm_serving.py``:
mamba2; ``test_torch_ssm_jamba.py``: jamba): the JAX engines' runs on a
virtual pool, memoized per configuration, their weights as numpy arrays,
and the port's engines built on those weights.

A case is one scaled config in both packages with its slots, cache
length and requests.  Scaled mamba2 is ``scaled_down`` as it is (2 layers
of (SSM, DENSE): d 64, d_inner 128, 16 heads of 8, d_state 16, chunk 32,
d_ff 128).  Scaled jamba is cut to the first 5 layers of its period
(SSM+dense, SSM+MoE, SSM+dense, SSM+MoE, attention+dense), the cut run
(v) of ``chip_smoke.py`` makes at full width: every layer kind, a third
of the 16-layer stack's compile time.  The resident engines take the same
5 layers as one period (``JAMBA_PERIOD``, two of the prompts): neither
package's resident engine runs a stack of no period (the JAX
``lax.scan`` over zero periods raises)."""
import dataclasses

import numpy as np

from repro.configs import get_config, scaled_down
from repro.core.pipeline import VirtualPool as JaxVirtualPool
from repro.core.transfer import split_views
from repro.serving import EngineSpec
from repro.serving import Request as JaxRequest
from repro.serving import create_engine as jax_create_engine
from repro_torch.configs import base as PB
from repro_torch.configs import get_config as port_config
from repro_torch.core.convert import from_reference_serving
from repro_torch.serving import spec as PS

untimed = lambda tr: [{k: v for k, v in e.items()
                       if k not in ("t_start", "t_end")}
                      for e in tr["events"]]


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    jc: object
    pc: object
    b_max: int = 2
    max_len: int = 48
    # 37 is prime and above the chunk of 32: one chunk a token
    prompt_lens: tuple = (9, 37, 20)
    max_new: tuple = (5, 4, 6)


def _cut(cfg, n):
    return dataclasses.replace(cfg, num_layers=n, num_periods=0,
                               remainder=tuple(cfg.pattern[:n]))


def _period(cfg, n):
    """The same first ``n`` layers as one period of ``n`` (the resident
    engines scan the periods; neither package's runs a stack of no
    period)."""
    return dataclasses.replace(cfg, num_layers=n, num_periods=1,
                               pattern=tuple(cfg.pattern[:n]), remainder=())


MAMBA2 = Case("mamba2-1.3b", scaled_down(get_config("mamba2-1.3b")),
              PB.scaled_down(port_config("mamba2-1.3b")))
JAMBA = Case("jamba-1.5-large-398b",
             _cut(scaled_down(get_config("jamba-1.5-large-398b")), 5),
             _cut(PB.scaled_down(port_config("jamba-1.5-large-398b")), 5))
JAMBA_PERIOD = Case(
    "jamba-1.5-large-398b",
    _period(scaled_down(get_config("jamba-1.5-large-398b")), 5),
    _period(PB.scaled_down(port_config("jamba-1.5-large-398b")), 5),
    prompt_lens=(9, 37), max_new=(5, 4))


def prompts(case):
    rng = np.random.default_rng(0)
    return [rng.integers(0, case.jc.vocab_size, (n,)).astype(np.int32)
            for n in case.prompt_lens]


def serve(case, eng, req_cls, preempt_after=None):
    """Every request at once; with ``preempt_after`` slot 0 is preempted
    after that many steps and resumes from its spilled rows."""
    for i, (p, n) in enumerate(zip(prompts(case), case.max_new)):
        eng.submit(req_cls(rid=i, prompt=p.copy(), max_new=n))
    if preempt_after is None:
        done = eng.run()
    else:
        done = []
        for _ in range(preempt_after):
            eng.step(done)
        eng.preempt_slot(0)
        while not eng.idle():
            eng.step(done)
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


def plans(case, offload=True, **kw):
    base = dict(arch=case.arch, cfg=case.jc, scaled=True, b_max=case.b_max,
                max_len=case.max_len, seed=0)
    if offload:
        base.update(offload=True, placement="host", pipeline="performance")
    jplan = EngineSpec(**base, **kw).resolve()
    pplan = dataclasses.replace(PS.ResolvedPlan.from_json(jplan.to_json()),
                                cfg=case.pc)
    return jplan, pplan


def virtualize(eng, pool_cls):
    n = eng.sched.pool.n_workers
    eng.sched.pool.shutdown()
    eng.sched.pool = eng._kv_pool = pool_cls(n, trace=eng.trace)


def engine_weights(jeng):
    """The JAX offloaded engine's weights as numpy arrays: resident
    tables, every unit and expert buffer, and the routers."""
    res = {part: {n: np.asarray(a) for n, a in jeng.resident[part].items()}
           for part in ("embed", "final_norm")}
    units = {k: {n: np.array(a) for n, a in split_views(
        jeng.host.get(k), jeng.weights.manifests[k]).items()}
        for u in jeng.units for k in [u.key, *u.expert_keys]}
    routers = {u.key: np.asarray(u.router) for u in jeng.units if u.moe}
    return res, units, routers


_RUNS = {}


def reference(case, kv_mode, quant, depth=1):
    """The JAX offloaded engine's run on a virtual pool (tokens, untimed
    trace, stats, KV kinds) and its weights, once per configuration."""
    key = (case.arch, kv_mode, quant, depth)
    if key not in _RUNS:
        jplan, pplan = plans(case, kv_mode=kv_mode, quant=quant, depth=depth)
        jeng = jax_create_engine(jplan)
        weights = engine_weights(jeng)
        virtualize(jeng, JaxVirtualPool)
        _RUNS[key] = dict(pplan=pplan, weights=weights,
                          kinds=[dict(k) for k in jeng.kv_kinds],
                          toks=serve(case, jeng, JaxRequest),
                          trace=jeng.trace.to_json(), stats=dict(jeng.stats))
    return _RUNS[key]


def port_engine(ref, **plan_kw):
    eng = PS.create_engine(dataclasses.replace(ref["pplan"], **plan_kw),
                           device="cpu")
    res, units, routers = ref["weights"]
    from_reference_serving(res, units, eng, routers)
    return eng


GRID = [("fp32", None), ("int4", None), ("fp32", "int4"), ("int4", "int4")]
