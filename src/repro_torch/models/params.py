"""Parameter declarations (port of ``repro/models/params.py``).

Each model module declares its parameters once as a tree of ``ParamDef``
leaves: nested dicts, with ``groups`` a tuple of layer-stacked dicts, the
same keys and shapes as the JAX package's tree.  From that one declaration
come real tensors (``init_params``), weights carried across from the JAX
package (``from_jax``) and the parameter count (``count_params``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: Any = None                    # None -> config param_dtype
    lead: int = 0                        # leading layer-stack axes


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/tuples (``None`` stays
    ``None``); ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def unflatten(tree, flat):
    """A tree of ``tree``'s structure holding ``flat``'s items in
    ``leaves`` order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def stack_defs(defs, n: int):
    """Prepend a layer-stack axis of size ``n`` to every leaf."""
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, lead=d.lead + 1), defs)


def to_dtype(x) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ('float32', ...)."""
    return x if isinstance(x, torch.dtype) else getattr(torch, str(x))


def _init_one(d: ParamDef, dtype, generator, device):
    dt = to_dtype(d.dtype or dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    if d.init == "fan_in":
        # one layer's input width.  (JAX's _init_one takes shape[0] of the
        # stacked declaration, i.e. the layer count: ROADMAP queue 3.)
        fan = d.shape[d.lead] if len(d.shape) > d.lead else 1
        return (x / math.sqrt(max(fan, 1))).to(dt)
    return (x * d.scale).to(dt)


def _defs(cfg):
    from . import lm
    return lm.param_defs(cfg)


def init_params(cfg, generator: torch.Generator, device):
    """Real tensors for ``cfg`` on ``device``, drawn from ``generator`` (a
    ``torch.Generator`` on that device).  The numbers differ from
    ``jax.random``'s for the same seed; carry weights with ``from_jax``
    where two packages must agree."""
    return tree_map(lambda d: _init_one(d, cfg.param_dtype, generator,
                                        device), _defs(cfg))


def _to_tensor(a, want: torch.dtype, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: carry the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_jax(cfg, tree, device):
    """Carry a JAX parameter tree, given as numpy arrays with the JAX
    package's keys (``groups`` a tuple), onto ``device``.  Every leaf's
    shape and dtype must equal the port's own declaration."""
    def carry(d, a):
        want = to_dtype(d.dtype or cfg.param_dtype)
        arr = np.asarray(a)
        if tuple(arr.shape) != tuple(d.shape):
            raise ValueError(f"shape {arr.shape} where {d.shape} is "
                             f"declared")
        if arr.dtype.name != str(want).removeprefix("torch."):
            raise ValueError(f"dtype {arr.dtype} where {want} is declared")
        return _to_tensor(arr, want, device)

    defs = _defs(cfg)
    _check_keys(defs, tree, "params")
    return tree_map(carry, defs, tree)


def _check_keys(defs, tree, path):
    if isinstance(defs, dict):
        if not isinstance(tree, dict) or set(defs) != set(tree):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path}: keys {got} where {sorted(defs)} are "
                             f"declared")
        for k in defs:
            _check_keys(defs[k], tree[k], f"{path}.{k}")
    elif isinstance(defs, tuple):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(defs):
            raise ValueError(f"{path}: {len(defs)} groups are declared")
        for i, (d, t) in enumerate(zip(defs, tree)):
            _check_keys(d, t, f"{path}[{i}]")


def count_params(cfg) -> int:
    """Parameter count from the declared shapes alone (no allocation)."""
    return sum(math.prod(d.shape) for d in leaves(_defs(cfg)))
