"""The port's spec trees (``repro_torch.launch.sharding``) against the
JAX package's, leaf for leaf and path for path, with no ranks: both are
built on abstract meshes of shape (2, 4), (16, 16) and (2, 16, 16) for
every registry arch, and with resident INT4 tables (``quant_weights``:
the ``#q``/``#s`` leaves of the dry run's ``w4`` variant).  A JAX
``NamedSharding``'s ``.spec`` and the port's ``PartitionSpec`` are
compared as tuples.  Each (arch, mesh, tree) is a
case of its own; ``cache``, ``batch`` and ``kv_axes`` run every
``SHAPES`` entry that ``shape_applicable`` admits for the arch."""
import dataclasses
import functools

import jax
import pytest
from jax._src.named_sharding import DuplicateSpecError

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import sharding as JS
from repro.optim.adafactor import Adafactor as JaxAdafactor
from repro_torch.configs import REGISTRY, SHAPES, shape_applicable
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.optim import Adafactor
from repro_torch.tree import flatten_with_path

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TREES = ("param", "zero", "adafactor", "cache", "batch", "kv_axes")


@functools.lru_cache(maxsize=None)
def meshes(name):
    shape, axes = MESHES[name]
    return jax.sharding.AbstractMesh(shape, axes), AbstractMesh(shape, axes)


def jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), tuple(leaf.spec)) for path, leaf in flat]


def port_flat(tree):
    return [(path, tuple(spec)) for path, spec in flatten_with_path(tree)]


def shapes_for(arch):
    cfg = REGISTRY[arch]
    return [name for name, sh in SHAPES.items()
            if shape_applicable(cfg, sh)[0]]


def trees(arch, mesh_name, kind, quant=False):
    """[(label, JAX flat specs, port flat specs)] of one case (with
    ``quant``, of the arch's ``quant_weights`` config)."""
    jmesh, pmesh = meshes(mesh_name)
    jc, pc = JAX_REGISTRY[arch], REGISTRY[arch]
    if quant:
        jc = dataclasses.replace(jc, quant_weights=True)
        pc = dataclasses.replace(pc, quant_weights=True)
    jd, pd = JS.make_dist(jmesh), S.make_dist(pmesh)
    if kind == "param":
        return [("param", jax_flat(JS.param_pspecs(jc, jd)),
                 port_flat(S.param_pspecs(pc, pd)))]
    if kind == "zero":
        return [("zero", jax_flat(JS.zero_pspecs(jc, jd)),
                 port_flat(S.zero_pspecs(pc, pd)))]
    if kind == "adafactor":
        return [("adafactor",
                 jax_flat(JS.adafactor_pspecs(jc, jd, JaxAdafactor())),
                 port_flat(S.adafactor_pspecs(pc, pd, Adafactor())))]
    out = []
    for name in shapes_for(arch):
        jsh, psh = JAX_SHAPES[name], SHAPES[name]
        jd, pd = JS.make_dist(jmesh, jsh), S.make_dist(pmesh, psh)
        if kind == "kv_axes":
            out.append((name, [("kv_axes", tuple(jd.kv_axes)),
                               ("kv_shard_axes", tuple(jd.kv_shard_axes)),
                               ("data_axes", tuple(jd.data_axes))],
                        [("kv_axes", tuple(pd.kv_axes)),
                         ("kv_shard_axes", tuple(pd.kv_shard_axes)),
                         ("data_axes", tuple(pd.data_axes))]))
        elif kind == "cache":
            out.append((name,
                        jax_flat(JS.cache_pspecs(jc, jd, jsh.global_batch,
                                                 jsh.seq_len)),
                        port_flat(S.cache_pspecs(pc, pd, psh.global_batch,
                                                 psh.seq_len))))
        else:
            out.append((name, jax_flat(JS.batch_pspecs(jc, jsh, jd)),
                        port_flat(S.batch_pspecs(pc, psh, pd))))
    return out


@pytest.mark.parametrize("kind", TREES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_spec_trees_match_jax(arch, mesh_name, kind):
    _check_trees(arch, mesh_name, kind, quant=False)


@pytest.mark.parametrize("kind", ("param", "zero", "adafactor"))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_spec_trees_match_jax_w4(arch, mesh_name, kind):
    """The parameter and optimizer-state trees of the ``w4`` variant
    (``quant_weights``): each packed ``#q`` and ``#s`` leaf laid out as
    the reference lays it."""
    _check_trees(arch, mesh_name, kind, quant=True)


def _check_trees(arch, mesh_name, kind, quant):
    try:
        trees_jax_ok = True
        cases = trees(arch, mesh_name, kind, quant)
    except DuplicateSpecError:
        trees_jax_ok = False
    if not trees_jax_ok:
        # the reference's rule maps an axis twice (ZeRO's extra `data`
        # beside an expert stack's `expert_ff` on `data`) and its
        # NamedSharding refuses the spec: the port's refuses it too
        with pytest.raises(ValueError, match="more than one dim"):
            port_only(arch, mesh_name, kind, quant)
        return
    assert cases
    for label, want, got in cases:
        assert [p for p, _ in got] == [p for p, _ in want], (label,)
        bad = [(p, w, g) for (p, w), (_, g) in zip(want, got) if w != g]
        assert not bad, (label, bad[:5], len(bad))


def port_only(arch, mesh_name, kind, quant=False):
    _, pmesh = meshes(mesh_name)
    pc, pd = REGISTRY[arch], S.make_dist(meshes(mesh_name)[1])
    if quant:
        pc = dataclasses.replace(pc, quant_weights=True)
    fn = {"param": S.param_pspecs, "zero": S.zero_pspecs,
          "adafactor": lambda c, d: S.adafactor_pspecs(c, d, Adafactor())}
    return fn[kind](pc, pd)


def test_registries_and_shapes_agree():
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    assert {k: (s.kind, s.seq_len, s.global_batch) for k, s in SHAPES.items()} \
        == {k: (s.kind, s.seq_len, s.global_batch)
            for k, s in JAX_SHAPES.items()}
    from repro.configs import shape_applicable as jax_applicable
    for arch in REGISTRY:
        for name in SHAPES:
            assert shape_applicable(REGISTRY[arch], SHAPES[name]) == \
                jax_applicable(JAX_REGISTRY[arch], JAX_SHAPES[name])


def _jax_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in flat]


def _port_shapes(tree):
    return [(path, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in flatten_with_path(tree)]


@pytest.mark.parametrize("kind", ("adamw", "adafactor"))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_optimizer_structs_match_jax(arch, kind):
    """``opt_struct`` / ``adafactor_struct``: the same paths, shapes and
    dtypes as the JAX package's (the state the ZeRO and Adafactor specs
    lay out)."""
    _check_structs(JAX_REGISTRY[arch], REGISTRY[arch], kind)


@pytest.mark.parametrize("kind", ("adamw", "adafactor"))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_optimizer_structs_match_jax_w4(arch, kind):
    """The same over the ``w4`` variant's tree (f32 moments of the uint8
    ``#q`` leaves, as the reference's)."""
    _check_structs(
        dataclasses.replace(JAX_REGISTRY[arch], quant_weights=True),
        dataclasses.replace(REGISTRY[arch], quant_weights=True), kind)


def _check_structs(jc, pc, kind):
    if kind == "adamw":
        want, got = JS.opt_struct(jc), S.opt_struct(pc)
    else:
        want = JS.adafactor_struct(jc, JaxAdafactor())
        got = S.adafactor_struct(pc, Adafactor())
    assert _port_shapes(got) == _jax_shapes(want)
