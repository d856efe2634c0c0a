"""Cost of a program as it runs (counterpart of ``repro/launch/hlo_cost.py``,
whose name it keeps so that a reader finds it).

The JAX package parses the compiled HLO text.  The port has no HLO: it
counts the eager program that actually runs, op by op, with a
``TorchDispatchMode`` (``Counter``).  Eager code runs every layer and
every remat recompute, so there are no loop trip counts to recover.
Reported per device, as JAX reports the partitioned program:

  * flops_by_dtype — matmul-class ops (``torch.utils.flop_counter``'s
                 formula registry) by the peak class they run at: bf16,
                 f16, tf32 (f32 products while the step allows TF32) or f32;
                 plus each kernel's own work (below).  ``flops`` is the sum
  * ewise_flops — one op per output element of every op tagged
                 ``torch.Tag.pointwise``
  * bytes      — inputs plus outputs of every op that materialises
                 (views, allocations and metadata move nothing,
                 ``_SKIP_BYTES``); a kernel's bytes are its formula's
  * collectives — ``(op, payload_bytes, group_size, trips, nodes)`` of the
                 ``_c10d_functional`` ops, with JAX's op names; ``nodes``
                 is how many 8-card nodes the group's ranks span, which
                 picks the roofline's link
  * kernels    — per kernel operator: calls, work and bytes

**Kernels are counted by their work, not by what implements them.**  K1-K4
and the two backward kernels dispatch operators of the ``repro_torch``
library, each registered with a work formula that reads only shapes and
static arguments (``repro_torch.kernels.WORK``).  The counter books the
formula and does not look inside: the CUDA launch, the plain version on
the CPU and the fake implementation under ``FakeTensorMode`` all count
the same.

Over DTensors the counter must see each rank's local ops, not the global
op DTensor is asked for: it returns ``NotImplemented`` for an op on
DTensors, which lets DTensor run its redistributions (the collectives)
and the local op, and counts those.  On the first call of each op
DTensor's sharding propagation also runs the global op on fake tensors
under the same modes, which the counter cannot tell apart; once cached it
does not run again.  So a DTensor program is counted on its second run
(``count(..., warm=True)``), as the dry run does.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_flatten

import repro_torch.kernels as _kernels
# every kernel's operator and work formula is registered on import
from repro_torch.kernels.flash_attn import kernel as _k3  # noqa: F401
from repro_torch.kernels.myers import kernel as _k2  # noqa: F401
from repro_torch.kernels.wavefront import kernel as _k1  # noqa: F401
from repro_torch.kernels.wkv6 import kernel as _k4  # noqa: F401

_C10D = ("_c10d_functional", "_dtensor")
COLLECTIVES = {
    "shard_dim_alltoall": "all-to-all",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
NODE_CARDS = 8            # ranks 8n .. 8n + 7 share a node (DGX H100)

# ops that move no bytes: allocations, metadata, waits and autograd
# bookkeeping (views are told by their schema)
_SKIP_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "lift_fresh", "device", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
    "set_", "resize_", "record_stream",
}
_FLOAT_KEYS = {torch.bfloat16: "bf16", torch.float16: "f16"}


def _tf32() -> bool:
    """Whether f32 products run as TF32 (the step's setting)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return bool(torch.backends.cuda.matmul.allow_tf32)


@dataclasses.dataclass
class Cost:
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    bytes: float = 0.0
    collectives: List[Tuple[str, float, int, float, int]] = \
        dataclasses.field(default_factory=list)
    ewise_flops: float = 0.0
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # device-to-host reads: .item()-style scalars and copies off the device
    host_transfers: List[Tuple[str, str]] = dataclasses.field(
        default_factory=list)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def collective_bytes(self) -> float:
        return sum(c[1] * c[3] for c in self.collectives)

    def kernel_calls(self, name: str) -> int:
        return self.kernels.get(name, {}).get("calls", 0)

    def as_dict(self) -> dict:
        """The record ``launch/dryrun.py`` writes under ``hlo_cost``."""
        return {"flops_per_device": self.flops,
                "flops_by_dtype": dict(self.flops_by_dtype),
                "ewise_flops_per_device": self.ewise_flops,
                "bytes_per_device": self.bytes,
                "collectives": [
                    {"op": o, "payload_bytes": b, "group": g, "trips": t,
                     "nodes": n} for (o, b, g, t, n) in self.collectives],
                "kernels": self.kernels,
                "host_transfers": len(self.host_transfers)}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group(args) -> Tuple[int, int]:
    """(size, nodes spanned) of a functional collective's group, named by
    its last string argument."""
    import torch.distributed as dist
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    try:
        pg = dist.distributed_c10d._resolve_process_group(name)
        ranks = dist.get_process_group_ranks(pg)
    except Exception:              # no group of that name in this process
        size = next((a for a in args if isinstance(a, int)), 1)
        return size, 1
    return len(ranks), len({r // NODE_CARDS for r in ranks})


class Counter(TorchDispatchMode):
    """Counts every op dispatched while it is entered into ``self.cost``;
    with ``where`` (a callable giving a label) also ``self.by_label``."""

    def __init__(self, where=None):
        super().__init__()
        self.cost = Cost()
        self.tf32 = _tf32()
        self.where = where
        self.by_label: Dict[str, Cost] = defaultdict(Cost)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs the local ops
        out = func(*args, **kwargs)
        costs = [self.cost]
        if self.where is not None:
            costs.append(self.by_label[self.where()])
        for c in costs:
            self._book(c, func, args, kwargs, out)
        return out

    def _book(self, c: Cost, func, args, kwargs, out):
        formula = _kernels.WORK.get(func)
        if formula is not None:
            work = formula(*args, **kwargs)
            for k, n in work.ops.items():
                c.flops_by_dtype[k] += n
            c.bytes += work.bytes
            rec = c.kernels.setdefault(func._schema.name.split("::")[-1],
                                       {"calls": 0, "ops": {}, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += work.bytes
            for k, n in work.ops.items():
                rec["ops"][k] = rec["ops"].get(k, 0) + n
            return
        name = func._schema.name
        ns, _, base = name.partition("::")
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if ns in _C10D and base in COLLECTIVES:
            size, nodes = _group(args)
            c.collectives.append((COLLECTIVES[base],
                                  max(_nbytes(ins), _nbytes(outs)), size,
                                  1.0, nodes))
            c.bytes += _nbytes(ins) + _nbytes(outs)
            return
        if base == "_local_scalar_dense" or (
                base in ("_to_copy", "copy_") and outs and ins
                and outs[0].device.type == "cpu"
                and ins[-1].device.type != "cpu"):
            c.host_transfers.append((base, str(tuple(ins[-1].shape))))
        fl = flop_registry.get(func._overloadpacket)
        if fl is not None:
            n = fl(*args, **kwargs, out_val=out)
            dt = ins[0].dtype if ins else torch.float32
            key = _FLOAT_KEYS.get(dt) or ("tf32" if self.tf32
                                          and dt == torch.float32 else "f32")
            c.flops_by_dtype[key] += n
        elif torch.Tag.pointwise in func.tags:
            c.ewise_flops += sum(t.numel() for t in outs)
        if base.split(".")[0] in _SKIP_BYTES or func.is_view:
            return
        c.bytes += _nbytes(ins) + _nbytes(outs)


def count(fn, *args, warm: bool = False, **kwargs) -> Cost:
    """The cost of ``fn(*args, **kwargs)``.  ``warm``: run it once
    uncounted first (a DTensor program, whose first run also propagates
    shardings; see the module note)."""
    if warm:
        fn(*args, **kwargs)
    with Counter() as c:
        fn(*args, **kwargs)
    return c.cost


_PKG = os.sep + "repro_torch" + os.sep
_SELF = os.path.abspath(__file__)


def _caller() -> str:
    """The innermost function of the port (outside this module) on the
    stack: 'models/layers.py:mlp_apply'; autograd's backward runs outside
    any ('(autograd backward)')."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if _PKG in path and os.path.abspath(path) != _SELF and \
                not path.endswith(os.sep + "kernels" + os.sep
                                  + "__init__.py"):
            return (path.split(_PKG, 1)[1].replace(os.sep, "/") + ":"
                    + f.f_code.co_name)
        f = f.f_back
    return "(autograd backward)"


def breakdown(fn, *args, top: int = 12, warm: bool = False, **kwargs):
    """Cost by the port's function that issued each op, the counterpart of
    JAX's breakdown by top-level loop.  The port's models are functions
    over parameter trees, not ``nn.Module``s, so ``module_tracker`` sees
    nothing there; each op is booked to the innermost frame of
    ``repro_torch`` on its stack (a kernel to its wrapper).  Returns
    [(label, flops, bytes, collective bytes)], the ``top`` largest by
    bytes."""
    if warm:
        fn(*args, **kwargs)
    with Counter(where=_caller) as c:
        fn(*args, **kwargs)
    rows = [(label, cost.flops, cost.bytes, cost.collective_bytes)
            for label, cost in c.by_label.items()]
    rows.sort(key=lambda r: -r[2])
    return rows[:top]


def analyze_plan(spec, params, engine_name: str,
                 q_shape: tuple, r_shape: tuple, *,
                 batch_size: Optional[int] = None,
                 with_traceback: bool = True, mode: str = "align",
                 n_devices: int = 1, **options) -> Cost:
    """Cost of exactly the program a plan for these arguments runs (fill
    plus traceback), counted on a zero batch of those shapes with every
    pair at its full bucket length, on the CPU: the plain versions run and
    K1 and K2 count by their formulas, as on the card.  ``options`` are
    engine schedule knobs (``strip=``, ``tb_pack=``, ...); ``n_devices``
    is JAX's argument (a plan runs on one device)."""
    from repro_torch.runtime import plan as plan_mod
    opts = plan_mod.resolve_engine_options(spec, engine_name, options, "cpu")
    wtb = bool(with_traceback and spec.traceback is not None)
    key = plan_mod.PlanKey(
        kernel=spec.name, engine=engine_name,
        bucket_shape=(tuple(q_shape), tuple(r_shape)),
        batch_size=batch_size, with_traceback=wtb, mode=mode, device="cpu",
        semiring=spec.semiring.name, **opts)
    plan = plan_mod.CompiledPlan(key, spec, engine_name)
    n = batch_size or 1
    q = torch.zeros((n,) + tuple(q_shape), dtype=spec.char_dtype)
    r = torch.zeros((n,) + tuple(r_shape), dtype=spec.char_dtype)
    ql, rl = int(q_shape[0]), int(r_shape[0])
    if batch_size is None:
        q, r = q[0], r[0]
    else:
        ql = torch.full((n,), ql, dtype=torch.int32)
        rl = torch.full((n,), rl, dtype=torch.int32)
    with Counter() as c:
        plan._dispatch(params, q, r, ql, rl)
    return c.cost
