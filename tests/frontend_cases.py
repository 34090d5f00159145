"""Shared set-up of the frontend tests (``tests/test_torch_encdec_serving.py``
for whisper's encoder-decoder, ``tests/test_torch_mrope.py`` for qwen2-vl's
M-RoPE): seeded requests, the serving loop, the JAX resident engines run
once per process on the scaled configs, and a CLI run that keeps its
engine's tokens."""
import numpy as np

import jax

from repro.serving import EngineSpec as JaxSpec
from repro.serving import Request as JaxRequest
from repro.serving import create_engine as jax_create_engine
from repro.serving.engine import KVRoundtripServingEngine as JaxKV
from repro_torch.serving.spec import ResolvedPlan

B_MAX, MAX_LEN = 2, 32
PROMPT_LENS = (5, 9, 5, 9, 5)          # few lengths: few JAX prefill compiles
MAX_NEW = (6, 3, 8, 4, 5)


def spec(arch, **kw):
    return dict(arch=arch, scaled=True, b_max=B_MAX, max_len=MAX_LEN,
                seed=0, **kw)


def requests(cfg, req_cls):
    """Five requests, more than the slots; an encoder-decoder's carry
    seeded frames (``encoder_seq_len``, ``d_model``) but the first, which
    takes the engine's zero-frame stub."""
    rng = np.random.default_rng(0)
    out = []
    for i, (n, m) in enumerate(zip(PROMPT_LENS, MAX_NEW)):
        enc = None
        if cfg.enc_dec and i:
            enc = rng.standard_normal(
                (cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(req_cls(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, (n,)).astype(np.int32), max_new=m,
            enc_embeds=enc))
    return out


def serve(eng, req_cls, preempt_after=None):
    """Submit every request and drive ``step`` to idle; with
    ``preempt_after``, the first occupied slot is preempted after that
    many steps and resumes from its spilled rows."""
    for r in requests(eng.cfg, req_cls):
        eng.submit(r)
    done, steps = [], 0
    while not eng.idle():
        eng.step(done)
        steps += 1
        if steps == preempt_after:
            eng.preempt_slot(next(i for i, r in enumerate(eng.slots)
                                  if r is not None))
    eng.shutdown()
    return {r.rid: list(r.out) for r in done}


_RUNS = {}


def reference(arch):
    """The JAX resident and KV-roundtrip engines' tokens, stats and the
    resident parameter tree as numpy arrays, once per architecture."""
    if arch not in _RUNS:
        jplan = JaxSpec(**spec(arch)).resolve()
        jeng = jax_create_engine(jplan)
        params = jax.tree.map(np.asarray, jeng.params)
        toks = serve(jeng, JaxRequest)
        stats = dict(jeng.stats)
        kv_toks = serve(JaxKV(jplan), JaxRequest)
        _RUNS[arch] = dict(pplan=ResolvedPlan.from_json(jplan.to_json()),
                           params=params, toks=toks, kv_toks=kv_toks,
                           stats=stats)
    return _RUNS[arch]


def cli(serve_mod, spec_mod, argv, monkeypatch, after=None):
    """``serve_mod.main(argv)`` with ``spec_mod.create_engine`` wrapped:
    ``after(engine)`` runs on the built engine, and the engine and its
    requests' tokens are kept.  Returns {"eng", "out"}."""
    seen = {}
    make = spec_mod.create_engine

    def wrapped(plan, **kw):
        eng = make(plan, **kw)
        if after is not None:
            after(eng)
        run = eng.run

        def run_and_keep(*a, **k):
            done = run(*a, **k)
            seen["out"] = {r.rid: list(r.out) for r in done}
            return done
        eng.run = run_and_keep
        seen["eng"] = eng
        return eng
    monkeypatch.setattr(spec_mod, "create_engine", wrapped)
    serve_mod.main(argv)
    return seen
