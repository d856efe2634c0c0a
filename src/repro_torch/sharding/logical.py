"""Logical-axis sharding on DTensor (port of ``repro/sharding/logical.py``).

Every parameter and activation dimension carries a *logical* axis name;
rule tables map logical names to (prioritized) mesh axes.  Resolution
checks divisibility and falls back down the priority list, so one model
definition serves every mesh (one card, a host of eight, a 256-card pod)
and every mode (FSDP training, TP inference) without edits.

``resolve_spec`` gives JAX's ``PartitionSpec`` as a plain tuple, one entry
per tensor dimension: ``None`` (replicated), a mesh-axis name, or a tuple
of names sharded jointly.  It reads only the mesh's axis sizes, so a
stand-in whose ``shape`` is a dict of sizes resolves a layout for any
mesh without devices.  ``to_placements`` turns a spec into the DTensor
placements of a ``DeviceMesh`` (``Shard(d)`` on each mesh dimension that
splits tensor dimension d, ``Replicate()`` elsewhere).

Logical axes used across the framework:
  batch        global batch            -> DP over ('pod','data')
  seq          sequence                -> None (SP variants map it to 'model')
  embed        d_model / residual      -> FSDP over ('data',) for params
  heads        attention q heads       -> TP
  kv_heads     attention kv heads      -> TP when divisible
  head_dim     per-head dim            -> None
  mlp          FFN hidden              -> TP
  vocab        vocabulary              -> TP
  expert       MoE experts             -> EP over 'model'
  expert_mlp   per-expert FFN hidden   -> None (EP already covers 'model')
  cache_seq    KV-cache sequence       -> 'model' fallback for small-kv decode
  layers       scanned layer stack     -> None
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis -> tuple of candidate mesh-axis assignments.

    Each candidate is a tuple of mesh axes (sharded jointly) or () meaning
    'replicate'.  The first candidate whose mesh axes all exist and divide
    the dimension is used.
    """
    rules: dict

    def candidates(self, logical: Optional[str]):
        if logical is None:
            return ((),)
        return self.rules.get(logical, ((),)) + ((),)


TRAIN_RULES = AxisRules({
    "batch":      ((("pod", "data")), ("data",),),
    "seq":        ((),),
    "embed":      (("data",),),         # FSDP / ZeRO-3 within a pod
    "heads":      (("model",),),
    "heads_flat": (("model",),),
    "kv_heads":   (("model",),),
    "head_dim":   ((),),
    "mlp":        (("model",),),
    "vocab":      (("model",),),
    "expert":     (("model",),),
    "expert_mlp": ((),),
    "q_lora":     ((),),
    "cache_seq":  ((),),
    "layers":     ((),),
    "lru":        (("model",),),
    "conv":       ((),),
})

# Inference: params sharded TP + FSDP-style over data for memory; batch DP.
INFER_RULES = AxisRules({
    "batch":      ((("pod", "data")), ("data",),),
    "seq":        ((),),
    "embed":      (("data",),),
    "heads":      (("model",),),
    "heads_flat": (("model",),),
    "kv_heads":   (("model",),),
    "head_dim":   ((),),
    "mlp":        (("model",),),
    "vocab":      (("model",),),
    "expert":     (("model",),),
    "expert_mlp": ((),),
    "q_lora":     ((),),
    "cache_seq":  (("model",),),        # flash-decode style seq sharding
    "layers":     ((),),
    "lru":        (("model",),),
    "conv":       ((),),
})

# Sequence-parallel variant: activations' seq axis on 'model'.
SP_TRAIN_RULES = AxisRules(dict(TRAIN_RULES.rules, **{"seq": (("model",),)}))

# v2 rule sets.  Experts stay 1-D over 'model' in training.
TRAIN_RULES_V2 = AxisRules(dict(TRAIN_RULES.rules))

# Inference v2: params TP-only (replicated over 'data').  Configs whose
# TP-sharded params would not fit opt out through ``cfg.infer_fsdp``.
INFER_RULES_V2 = AxisRules(dict(INFER_RULES.rules, **{
    "embed": ((),),
}))


def _normalize(cand):
    if isinstance(cand, str):
        return (cand,)
    return tuple(cand)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``shape`` is already such a dict (a stand-in mesh)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def resolve_spec(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
                 rules: AxisRules, mesh) -> tuple:
    """The partition spec of ``shape`` given its logical axis names: one
    entry per dimension, ``None``, a mesh-axis name or a tuple of them."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    sizes = mesh_sizes(mesh)
    used = set()
    out = []
    for dim, logical in zip(shape, logical_axes):
        chosen = None
        for cand in rules.candidates(logical):
            cand = _normalize(cand)
            if not cand:
                chosen = None
                break
            if any(a not in sizes or a in used for a in cand):
                continue
            total = 1
            for a in cand:
                total *= sizes[a]
            if dim % total == 0:
                chosen = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        out.append(chosen)
    return tuple(out)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` if tensor dimension d is split over it, else
    ``Replicate()``.  A dimension split over several mesh axes is split in
    their mesh order, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else _normalize(entry)):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshSharding:
    """A mesh and a partition spec: JAX's ``NamedSharding``.  A leaf of a
    sharding tree (``ShardCtx.tree``, ``checkpoint.restore(shardings=)``);
    ``placements`` are its DTensor placements."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def logical_sharding(shape, logical_axes, rules, mesh) -> MeshSharding:
    """The sharding of a tensor of ``shape`` on ``mesh``."""
    return MeshSharding(mesh, resolve_spec(shape, logical_axes, rules, mesh))


SUM = "sum"


def shard_dims(x, dim: int) -> list:
    """The mesh dimensions on which DTensor ``x`` is split along ``dim``."""
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(x.placements) if p == Shard(dim)]


def split_dims(mesh, exclude, size: int) -> list:
    """The mesh dimensions not in ``exclude`` if together they divide
    ``size``, else none (the work stays whole on every rank)."""
    dims = [i for i in range(mesh.ndim) if i not in exclude]
    return dims if size % math.prod(mesh.size(i) for i in dims) == 0 else []


def on_shards(fn, mesh, bdims, wdims, ins, outs):
    """``fn`` on each rank's local blocks of DTensors, through
    ``local_map``: the one placement policy of the models' local ops (K3,
    K4, the head projections, the embedding, the MoE, the cross-entropy).

    ``bdims`` are the mesh dimensions that split the batch and ``wdims``
    those that split the op's own work (its heads, experts or vocabulary);
    every other mesh dimension holds each tensor whole.  Each entry of
    ``ins`` and ``outs`` is a pair (batch dim, work dim): the tensor
    dimension split over ``bdims`` and over ``wdims``, ``None`` where the
    tensor is whole there, or, for an output, ``SUM`` where it is a
    partial sum.  An input whole over mesh dimensions that split the work
    gets its gradient back as a partial sum over them, since each rank
    saw a part of the work.  Returns the wrapped function."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def one(d):
        return (Partial() if d == SUM else Replicate() if d is None
                else Shard(d))

    def pl(b, w):
        return tuple(one(b) if i in bdims else one(w) if i in wdims
                     else Replicate() for i in range(mesh.ndim))

    return local_map(
        fn, out_placements=tuple(pl(b, w) for b, w in outs),
        in_placements=tuple(pl(b, w) for b, w in ins),
        in_grad_placements=tuple(pl(SUM if b is None else b,
                                    SUM if w is None else w)
                                 for b, w in ins),
        device_mesh=mesh, redistribute_inputs=True)


def flat_rank(mesh, dims) -> int:
    """This rank's index, row-major, over the mesh dimensions ``dims``
    (the block a tensor split over them jointly gives it)."""
    r = 0
    for i in dims:
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    return r


def local_slice(x, mesh, placements):
    """This rank's block of the whole tensor ``x`` under ``placements``:
    each ``Shard(d)`` splits dimension d evenly, mesh dimensions in order
    (the first the major split), as DTensor lays out shards."""
    for i, p in enumerate(placements):
        if p.is_shard():
            x = x.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return x


def place(x, sharding, device=None):
    """``device_put``: the whole tensor ``x`` (the same on every rank) as a
    DTensor of ``sharding`` (a ``MeshSharding``), built from this rank's
    own block (copied onto ``device``, default the mesh's device type)
    with no collective.  Dimensions a spec splits must divide evenly, as
    ``resolve_spec`` guarantees."""
    from torch.distributed.tensor import DTensor
    mesh, pl = sharding.mesh, sharding.placements
    for i, p in enumerate(pl):
        if p.is_shard() and x.shape[p.dim] % mesh.size(i):
            raise ValueError(f"dimension {p.dim} of {tuple(x.shape)} does "
                             f"not split over {mesh.size(i)}")
    local = local_slice(x, mesh, pl)
    if local.numel() < x.numel():      # hold the block, not the whole
        local = local.clone(memory_format=torch.contiguous_format)
    local = local.to(device or mesh.device_type).contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False)


def constrain(x, logical_axes, rules, mesh=None):
    """Redistribute a DTensor to the placements its logical axes resolve
    to; a no-op off a mesh, on a mesh of one device, and for a plain
    tensor."""
    from torch.distributed.tensor import DTensor
    mesh = mesh if mesh is not None else getattr(x, "device_mesh", None)
    if mesh is None or mesh.size() == 1 or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, logical_sharding(x.shape, logical_axes,
                                                 rules, mesh).placements)
