"""The ranks' side of ``tests/test_torch_distributed.py`` and
``tests/test_torch_dist_train.py``: functions that run on gloo CPU ranks
(``repro_torch.launch.ranks.spawn``) and write their results as numpy
files for the parent, which holds them against the JAX package.  This
module imports nothing of JAX: the ranks never load it."""
import json
import os

import numpy as np
import torch

ARCHS = ("granite-8b", "gemma3-4b", "deepseek-v3-671b",
         "jamba-1.5-large-398b", "mamba2-1.3b")
SCALE = dict(d_model=64, num_heads=4, num_kv_heads=4, vocab_size=256)
B, S = 4, 32
MOE_ARCHS = ("deepseek-v3-671b", "jamba-1.5-large-398b")
# the optimizer cases' archs (a dense and an SSM stack; the MoE expert
# stacks' ZeRO spec maps ``data`` twice, which both packages refuse)
OPTIM_ARCHS = ("granite-8b", "mamba2-1.3b")
# the collectives' cases: (name, axis)
AXES = {"model": "model", "data": "data", "flat": ("data", "model")}
OPS = ("psum", "pmean", "pmax", "all_gather", "all_gather_stacked",
       "psum_scatter", "all_to_all", "ppermute", "pvary")


def config(arch):
    from repro_torch.configs import get_config, scaled_down
    return scaled_down(get_config(arch), **SCALE)


def _save(path, **arrays):
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def _flat(tree):
    from repro_torch.tree import flatten_with_path
    return {p: t.detach().float().numpy() for p, t in flatten_with_path(tree)}


def _params(root, arch):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models import transformer as T
    tree, _ = restore_checkpoint(os.path.join(root, "params", arch), 0,
                                 T.param_struct(config(arch)))
    return tree


def _batch(root, arch):
    z = np.load(os.path.join(root, f"batch_{arch}.npz"))
    return {k: torch.from_numpy(z[k]) for k in z.files}


def model_cases(rank, world, root):
    """The five archs on a (2, 2) mesh: loss and gradients (and, for the
    MoE archs, gradients with the load-balance term off), prefill and
    one decode step with the KV over ``model``, and a batch-1 prefill
    with two decode steps with the KV over ``("data", "model")``."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.core.convert import (from_reference_resident,
                                          from_reference_train_state)
    from repro_torch.models.model import build_model
    from repro_torch.tree import leaves, tree_map
    mesh = make_test_mesh(model=2, data=2, device="cpu")
    dist = SH.make_dist(mesh)
    dkv = Dist(mesh=mesh, data_axes=("data",), model_axis="model",
               kv_axes=("model",))
    dlong = Dist(mesh=mesh, data_axes=("data",), model_axis="model",
                 kv_axes=("data", "model"))
    for arch in ARCHS:
        cfg = config(arch)
        m = build_model(cfg)
        ref = tree_map(lambda t: t.numpy(), _params(root, arch))
        pspecs = SH.param_pspecs(cfg, dist)
        params, _ = from_reference_train_state(ref, mesh=mesh,
                                               specs=(pspecs, None))
        same = from_reference_resident(ref, mesh=mesh, specs=pspecs)
        assert all(torch.equal(a.to_local(), b.to_local()) and
                   a.placements == b.placements
                   for a, b in zip(leaves(params), leaves(same)))
        batch = _batch(root, arch)
        out = {}
        loss, grads = value_and_grad(m, params, batch, dist=dist)
        g = _flat(SH.unplace(grads))
        out["loss"] = float(loss)
        if arch in MOE_ARCHS:
            aux, T.AUX_WEIGHT = T.AUX_WEIGHT, 0.0
            try:
                loss0, grads0 = value_and_grad(m, params, batch, dist=dist)
            finally:
                T.AUX_WEIGHT = aux
            out["loss_noaux"] = float(loss0)
            g0 = _flat(SH.unplace(grads0))
        with torch.no_grad():
            pre = {"tokens": batch["tokens"]}
            nt, caches = m.prefill(params, pre, dkv, S + 4)
            nt = nt.full_tensor()
            dt, _ = m.decode_step(params, {"token": nt[:, None], "pos": S},
                                  caches, dkv)
            out["prefill"], out["decode"] = nt.numpy(), dt.full_tensor().numpy()
            one = {"tokens": batch["tokens"][:1]}
            t1, c1 = m.prefill(params, one, dlong, S + 4)
            toks = [t1.full_tensor()]
            for k in range(2):
                t1, c1 = m.decode_step(
                    params, {"token": toks[-1][:, None], "pos": S + k}, c1,
                    dlong)
                toks.append(t1.full_tensor())
            out["long"] = torch.stack(toks, 1).numpy()
        if rank == 0:
            _save(os.path.join(root, f"out_{arch}.npz"), **out)
            _save(os.path.join(root, f"grads_{arch}.npz"), **g)
            if arch in MOE_ARCHS:
                _save(os.path.join(root, f"grads0_{arch}.npz"), **g0)


def unit_cases(rank, world, root):
    """The MoE branches, ``ssd_sharded`` and every collective on a (2,
    2) mesh, each result saved per rank."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import common as C
    from repro_torch.models import moe as M
    from repro_torch.models import ssm as SM
    mesh = make_test_mesh(model=2, data=2, device="cpu")
    dist = SH.make_dist(mesh)
    z = np.load(os.path.join(root, "units.npz"))
    t = {k: torch.from_numpy(z[k]) for k in z.files}
    cfg = MoEConfig(**json.loads(open(os.path.join(root, "moe.json")).read()))
    out = {}
    with C.in_mesh(dist):
        mi, di = dist.index("model"), dist.index("data")
        flat = dist.index(("data", "model"))
        E_loc = cfg.num_experts // 2
        ex = lambda w: w[mi * E_loc:(mi + 1) * E_loc]
        wts = {"wg": t["wg"], "w_gate": ex(t["w_gate"]),
               "w_up": ex(t["w_up"]), "w_down": ex(t["w_down"])}
        T_ = t["x"].shape[0]
        x_loc = t["x"][flat * T_ // 4:(flat + 1) * T_ // 4]
        o, _ = M.moe_ffn(x_loc, wts, cfg, axis="model")
        out["moe_ffn"] = C.all_gather(o, ("data", "model"), 0).numpy()
        o, _ = M.moe_ffn_replicated(t["x"], wts, cfg, axis="model")
        out["moe_ffn_replicated"] = o.numpy()
        f = t["w_gate"].shape[-1] // 2
        fw = dict(wts, w_gate=wts["w_gate"][..., di * f:(di + 1) * f],
                  w_up=wts["w_up"][..., di * f:(di + 1) * f],
                  w_down=wts["w_down"][:, di * f:(di + 1) * f])
        o, _ = M.moe_ffn_decode(t["x"], fw, cfg, ep_axis="model",
                                ff_axis="data", combine_axes=("data",
                                                              "model"))
        out["moe_ffn_decode"] = o.numpy()
        l = t["xh"].shape[1] // 4
        rows = slice(flat * l, (flat + 1) * l)
        y, h = SM.ssd_sharded(t["xh"][:, rows], t["dt"][:, rows], t["A"],
                              t["B"][:, rows], t["C"][:, rows], 8,
                              ("data", "model"))
        out["ssd_y"] = C.all_gather(y, ("data", "model"), 1).numpy()
        out["ssd_h"] = h.numpy()
        rng = np.random.default_rng(100 + rank)
        x0 = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
        ct0 = rng.standard_normal((16, 6)).astype(np.float32)
        for name, axis in AXES.items():
            for op in OPS:
                x = x0.clone().requires_grad_(op != "pmax")
                y = _collective(C, op, x, axis)
                out[f"{op}_{name}_y"] = y.detach().numpy()
                if op != "pmax":
                    ct = torch.from_numpy(ct0.reshape(-1)[:y.numel()].reshape(y.shape))
                    (gx,) = torch.autograd.grad((y * ct).sum(), x)
                    out[f"{op}_{name}_g"] = gx.numpy()
    _save(os.path.join(root, f"units_{rank}.npz"), **out)


def _collective(C, op, x, axis):
    n = C.axis_size(axis)
    if op == "psum":
        return C.psum(x, axis)
    if op == "pmean":
        return C.pmean(x, axis)
    if op == "pmax":
        return C.pmax(x, axis)
    if op == "all_gather":
        return C.all_gather(x, axis, 0)
    if op == "all_gather_stacked":
        return C.all_gather(x, axis, tiled=False)
    if op == "psum_scatter":
        return C.psum_scatter(x, axis, 0)
    if op == "all_to_all":
        return C.all_to_all(x, axis)
    if op == "ppermute":
        return C.ppermute(x, axis, [(s, (s + 1) % n) for s in range(n)])
    return C.pvary(x, axis)


def optim_cases(rank, world, root):
    """Two AdamW and two Adafactor steps of placed f32 parameters on a
    (2, 2) mesh (AdamW's moments under ``zero_pspecs``, Adafactor's
    state under ``adafactor_pspecs``), each from the parent's gradients
    placed like the parameters; rank 0 writes the whole parameters and
    state, and each step's global norm."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import (AdamW, Adafactor, apply_updates,
                                   cosine_schedule)
    mesh = make_test_mesh(model=2, data=2, device="cpu")
    dist = SH.make_dist(mesh)
    for arch in OPTIM_ARCHS:
        cfg = config(arch)
        pspecs = SH.param_pspecs(cfg, dist)
        grads = [SH.place(restore_checkpoint(
            os.path.join(root, "grads", arch), i, T.param_struct(cfg))[0],
            pspecs, mesh) for i in (1, 2)]
        for name, opt in optim_pair(AdamW, Adafactor, cosine_schedule):
            params = SH.place(_params(root, arch), pspecs, mesh)
            state = opt.init(params)
            if name == "adamw":
                z = SH.zero_pspecs(cfg, dist)
                for k in ("m", "v"):
                    state[k] = SH.redistribute(state[k], z[k], mesh)
            else:
                state["s"] = SH.redistribute(
                    state["s"], SH.adafactor_pspecs(cfg, dist, opt)["s"],
                    mesh)
            norms = []
            for g in grads:
                upd, state, gn = opt.update(g, state, params)
                params = apply_updates(params, upd)
                norms.append(float(gn))
            out = {"params": _flat(SH.unplace(params)),
                   "state": _flat(SH.unplace(state))}
            if rank == 0:
                for k, tree in out.items():
                    _save(os.path.join(root, f"{name}_{k}_{arch}.npz"),
                          **tree)
                _save(os.path.join(root, f"{name}_norms_{arch}.npz"),
                      norms=np.array(norms))


def optim_pair(adamw, adafactor, cosine_schedule):
    """The two optimizers of ``optim_cases``, as the parent builds them
    from the JAX package's classes.  Adafactor runs without its bf16
    momentum: a sum in another order can round a momentum element to
    the next bf16 value, which the second step then carries into the
    parameters at ``lr * b1 * 2**-8`` of it (the momentum is elementwise
    at the parameter's placements, so the mesh adds nothing to it)."""
    return (("adamw", adamw(lr=cosine_schedule(1e-2, 2, 10))),
            ("adafactor", adafactor(lr=cosine_schedule(1e-2, 2, 10),
                                    b1=0.0, weight_decay=0.01)))


def all_cases(rank, world, root):
    unit_cases(rank, world, root)
    optim_cases(rank, world, root)
    model_cases(rank, world, root)


def _bits(t):
    """A tensor's bytes as numpy (bf16 viewed as uint16)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _state_specs(cfg, dist):
    from repro_torch.launch import sharding as SH
    z = SH.zero_pspecs(cfg, dist)
    opt = {"m": z["m"], "v": z["v"], "step": None}
    return {"params": SH.param_pspecs(cfg, dist), "opt": opt}


def _shardings(mesh, specs):
    from repro_torch.launch.sharding import NamedSharding
    from repro_torch.tree import tree_map
    out = {"params": tree_map(lambda sp: NamedSharding(mesh, sp),
                              specs["params"]),
           "opt": {k: tree_map(lambda sp: NamedSharding(mesh, sp),
                               specs["opt"][k]) for k in ("m", "v")}}
    out["opt"]["step"] = None
    return out


def ckpt_world4(rank, world, root, arch):
    """On a (2, 2) mesh: one AdamW step of placed bf16 parameters, the
    state saved sharded (``ckpt4``); then the JAX package's checkpoint
    (``ckptj``) restored under the mesh and written whole by rank 0."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW
    from repro_torch.tree import flatten_with_path
    cfg = config(arch)
    mesh = make_test_mesh(model=2, data=2, device="cpu")
    dist = SH.make_dist(mesh)
    model, opt = build_model(cfg), AdamW()
    specs = _state_specs(cfg, dist)
    params = SH.place(model.init(0), specs["params"], mesh,
                      dtype=torch.bfloat16)
    state = opt.init(params)
    for k in ("m", "v"):
        state[k] = SH.redistribute(state[k], specs["opt"][k], mesh)
    batch = _batch(root, arch)
    params, state, _ = make_train_step(model, dist, opt)(params, state,
                                                         batch)
    save_checkpoint(os.path.join(root, "ckpt4"), 1,
                    {"params": params, "opt": state})
    target = {"params": params, "opt": state}
    back, _ = restore_checkpoint(os.path.join(root, "ckptj"), 1, target,
                                 shardings=_shardings(mesh, specs))
    placed = all(hasattr(t, "placements") for p, t in flatten_with_path(
        back) if not p.endswith("step"))
    whole = {p: _bits(t) for p, t in flatten_with_path(SH.unplace(back))}
    if rank == 0:
        _save(os.path.join(root, "from_jax_w4.npz"), placed=placed, **whole)


def ckpt_world8(rank, world, root, arch):
    """On a (2, 4) mesh: ``ckpt4`` restored under this mesh's specs,
    written whole by rank 0, with each leaf's local shape."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten_with_path
    cfg = config(arch)
    mesh = make_test_mesh(model=4, data=2, device="cpu")
    dist = SH.make_dist(mesh)
    specs = _state_specs(cfg, dist)
    ps = T.param_struct(cfg)
    f32 = lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta")
    from repro_torch.tree import tree_map
    target = {"params": ps, "opt": {"m": tree_map(f32, ps),
                                    "v": tree_map(f32, ps),
                                    "step": torch.zeros((), dtype=torch.int32)}}
    back, _ = restore_checkpoint(os.path.join(root, "ckpt4"), 1, target,
                                 shardings=_shardings(mesh, specs))
    local = {p: np.array(t.to_local().shape) for p, t in
             flatten_with_path(back) if hasattr(t, "to_local")}
    whole = {p: _bits(t) for p, t in flatten_with_path(SH.unplace(back))}
    if rank == 0:
        _save(os.path.join(root, "w8.npz"), **whole)
        _save(os.path.join(root, "w8_local.npz"), **local)
