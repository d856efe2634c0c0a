"""The port's placement layer against the JAX package's own functions, in
one process (multi-rank runs: test_torch_multiproc.py).

``resolve_spec`` reads only a mesh's axis sizes, in both packages, so a
stand-in whose ``shape`` is a dict of sizes gives each package's layout for
any mesh without devices.  Held to JAX exactly: the spec of every leaf of
``logical(cfg)`` / ``abstract(cfg)`` and of the cache's logical tree, for
all ten registered architectures at full size (``meta`` tensors), under
the five rule tables on five meshes; the logical trees themselves and the
abstract shapes and dtypes (also of the train state); ``plan_mesh``; the
plan cache's placement strings and its split by mesh.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sharding as jsharding
from repro import train as jtrain
from repro.ft import elastic as jelastic
from repro.models import get_model as jget_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import plan as jplan
from repro_torch import configs as pconfigs
from repro_torch import sharding as psharding
from repro_torch import train as ptrain
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.ft import elastic as pelastic
from repro_torch.launch.shardctx import NullCtx, ShardCtx
from repro_torch.models import get_model as pget_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import plan as pplan

ARCHS = sorted(jconfigs.ARCH_NAMES)
RULES = ["TRAIN_RULES", "INFER_RULES", "SP_TRAIN_RULES", "TRAIN_RULES_V2",
         "INFER_RULES_V2"]
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 2}, {"data": 8, "model": 1},
          {"data": 1, "model": 1}]


class _Sizes:
    """A mesh stand-in: axis sizes only, which is all either package's
    ``resolve_spec`` reads."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def _is_axes(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _jax_flat(tree):
    """{JAX key string: leaf} with axis tuples as leaves (a 0-dim leaf's
    axes, (), are an empty subtree to jax.tree and drop out)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: _is_axes(x) and x != ())
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _port_flat(tree, path=""):
    """{JAX key string: leaf} of a port tree (dict keys sorted, axis
    tuples and tensors as leaves, None an empty subtree)."""
    if _is_axes(tree):
        return {path: tree}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_flat(tree[k], f"{path}[{k!r}]"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, f"{path}[{i}]"))
        return out
    return {} if tree is None else {path: tree}


def _dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_trees_and_abstract_params_equal_jax(arch):
    jc, pc = jconfigs.get(arch), pconfigs.get(arch)
    jm, pm = jget_model(jc), pget_model(pc)
    jl, pl = _jax_flat(jm.logical(jc)), _port_flat(pm.logical(pc))
    assert pl == jl
    ja, pa = _jax_flat(jm.abstract(jc)), _port_flat(pm.abstract(pc))
    assert sorted(pa) == sorted(ja)
    for k, a in pa.items():
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(ja[k].shape), k
        assert _dtype_name(a) == str(ja[k].dtype), k
    assert pc.infer_fsdp == jc.infer_fsdp


def _cache_trees(arch, cfg, model, jmodel):
    if cfg.enc_dec:
        return ((jmodel.abstract_cache(jconfigs.get(arch), 2, 64, 96),
                 jmodel.cache_logical(jconfigs.get(arch))),
                (model.abstract_cache(cfg, 2, 64, 96),
                 model.cache_logical(cfg)))
    return ((jmodel.abstract_cache(jconfigs.get(arch), 2, 64),
             jmodel.cache_logical(jconfigs.get(arch))),
            (model.abstract_cache(cfg, 2, 64), model.cache_logical(cfg)))


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_equals_jax(arch):
    """Every parameter and cache leaf, five rule tables, five meshes."""
    jc, pc = jconfigs.get(arch), pconfigs.get(arch)
    jm, pm = jget_model(jc), pget_model(pc)
    (jac, jlc), (pac, plc) = _cache_trees(arch, pc, pm, jm)
    jcl, pcl = _jax_flat(jlc), _port_flat(plc)
    assert pcl == jcl
    jcs, pcs = _jax_flat(jac), _port_flat(pac)
    assert {k: tuple(v.shape) for k, v in pcs.items()} == \
        {k: tuple(v.shape) for k, v in jcs.items()}
    leaves = [(tuple(a.shape), pl_) for a, pl_ in zip(
        _port_flat(pm.abstract(pc)).values(),
        _port_flat(pm.logical(pc)).values())]
    leaves += [(tuple(pcs[k].shape), pcl[k]) for k in pcs]
    n = 0
    for rules in RULES:
        jr, pr = getattr(jsharding, rules), getattr(psharding, rules)
        for sizes in MESHES:
            for shape, logical in leaves:
                want = tuple(jsharding.resolve_spec(shape, logical, jr,
                                                    _Sizes(sizes)))
                got = psharding.resolve_spec(shape, logical, pr,
                                             _Sizes(sizes))
                assert got == want, (rules, sizes, shape, logical)
                n += 1
    assert n >= 25 * 10


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b",
                                  "whisper-medium"])
def test_train_state_abstract_and_logical_equal_jax(arch, quantized):
    jc, pc = jconfigs.get(arch), pconfigs.get(arch)
    ja = _jax_flat(jtrain.abstract_state(jc, JAdamWConfig(
        quantized=quantized), use_ef=True))
    pa = _port_flat(ptrain.abstract_state(pc, AdamWConfig(
        quantized=quantized), use_ef=True))
    assert sorted(pa) == sorted(ja)
    for k, a in pa.items():
        assert (tuple(a.shape), _dtype_name(a)) == \
            (tuple(ja[k].shape), str(ja[k].dtype)), k
    jl = jtrain.state_logical(jc, JAdamWConfig(quantized=quantized),
                              use_ef=True)
    pl = ptrain.state_logical(pc, AdamWConfig(quantized=quantized),
                              use_ef=True)
    want = _jax_flat(jl)
    got = _port_flat(pl)
    # () (a 0-dim leaf's axes) is an empty subtree to jax.tree
    assert {k: v for k, v in got.items() if v != ()} == want
    assert got["['step']"] == () and got["['opt']['count']"] == ()


def test_to_placements_and_shardctx():
    """Specs to DTensor placements on a mesh's axis names (a dimension
    split over several axes is Shard of it on each), and ``ShardCtx``'s
    tree of ``MeshSharding`` over a train state."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 16, "model": 16}

    pl = psharding.to_placements((("pod", "data"), "model", None), Mesh3)
    assert pl == (Shard(0), Shard(0), Shard(1))
    assert psharding.to_placements((None, None), Mesh3) == (Replicate(),) * 3
    cfg = pconfigs.get("olmo-1b")
    opt = AdamWConfig()
    tree = ShardCtx(Mesh3, psharding.TRAIN_RULES).tree(
        ptrain.abstract_state(cfg, opt), ptrain.state_logical(cfg, opt))
    table = tree["params"]["embed"]["table"]
    assert table.spec == ("model", "data")
    assert table.placements == (Replicate(), Shard(1), Shard(0))
    assert tree["opt"]["mu"]["embed"]["table"]["m"].spec == table.spec
    assert tree["step"].placements == (Replicate(),) * 3
    x = torch.ones(2, 3)
    assert NullCtx()(x, ("batch", None)) is x
    assert ShardCtx(None, psharding.TRAIN_RULES)(x, ("batch", None)) is x
    assert psharding.constrain(x, ("batch", None),
                               psharding.TRAIN_RULES) is x


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


def test_plan_mesh_equals_jax():
    """Over a grid of survivor counts, model degrees and pod sizes,
    JAX's two ValueErrors included."""
    n = 0
    for devices in list(range(-1, 41)) + [63, 64, 255, 256, 257, 511, 512]:
        for model in (-1, 0, 1, 2, 3, 4, 8, 16):
            for pod in (None, 0, 4, 8, 16, 256):
                assert _outcome(pelastic.plan_mesh, devices, model, pod) == \
                    _outcome(jelastic.plan_mesh, devices, model, pod), \
                    (devices, model, pod)
                n += 1
    assert n > 2000


class _JMesh:
    """JAX's ``_placement`` reads ``axis_names`` and ``devices.shape``."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


class _PMesh:
    """A ``DeviceMesh`` stand-in: ``mesh_dim_names`` and ``mesh.shape``."""

    def __init__(self, names, shape):
        self.mesh_dim_names = names
        self.mesh = np.zeros(shape)


@pytest.mark.parametrize("names,shape,axis", [
    (("data",), (4,), "data"), (("data", "model"), (4, 2), "data"),
    (("pod", "data", "model"), (2, 16, 16), "data"),
    (("data", "model"), (1, 1), "model")])
def test_placement_strings_equal_jax(names, shape, axis):
    assert pplan._placement(_PMesh(names, shape), axis) == \
        jplan._placement(_JMesh(names, shape), axis)
    assert pplan._placement(None, axis) is None


def test_plan_cache_splits_by_mesh():
    """Distinct meshes never share a plan; the placement joins the key
    and its string, before the device; a sharded plan needs a batch."""
    spec, _ = pzoo.make("global_linear")
    pplan.clear_plan_cache()
    a, b = _PMesh(("data", "model"), (4, 2)), _PMesh(("data",), (4,))
    shapes = ((64,), (64,))
    plain = pplan.get_plan(spec, "reference", *shapes, batch_size=8,
                           device="cpu")
    pa = pplan.get_plan(spec, "reference", *shapes, batch_size=8,
                        device="cpu", mesh=a)
    pb = pplan.get_plan(spec, "reference", *shapes, batch_size=8,
                        device="cpu", mesh=b)
    assert len({id(plain), id(pa), id(pb)}) == 3
    assert pplan.get_plan(spec, "reference", *shapes, batch_size=8,
                          device="cpu", mesh=a) is pa
    assert plain.key.placement is None
    assert pa.key.placement == "data@data=4xmodel=2"
    assert pb.key.placement == "data@data=4"
    assert pplan.plan_key_str(pa.key).endswith("/data@data=4xmodel=2/cpu")
    assert "@" not in pplan.plan_key_str(plain.key)
    keys = pplan.plan_cache_info()["keys"]
    assert sorted(k.placement or "" for k in keys) == \
        ["", "data@data=4", "data@data=4xmodel=2"]
    with pytest.raises(ValueError, match="sharded plans require batch_size"):
        pplan.get_plan(spec, "reference", *shapes, device="cpu", mesh=a)
    pplan.clear_plan_cache()
