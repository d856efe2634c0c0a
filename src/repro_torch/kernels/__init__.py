"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Nothing here builds or loads a kernel at import time.

Each kernel's wrapper dispatches one operator of the ``repro_torch``
library (``torch.library.custom_op``): its CUDA implementation launches
the kernel, its CPU implementation is the plain version, and its fake
implementation gives outputs of the right shapes and launches nothing.
Each operator is registered in ``WORK`` with a work formula that reads only
shapes, dtypes and static arguments, never tensor values, so a kernel
counts the same on the card, on the CPU and under fake tensors
(``launch/hlo_cost.py`` reads it).  The operator's own dispatch costs a
few tens of microseconds of host time a call (``PERF.md``), and it is
needed only to count a call or to run it on fake tensors, so ``call``
goes straight to the device's implementation when no dispatch mode is
active and every tensor is a plain one."""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode


def aligned16(t):
    """``t`` made contiguous, copied once more if its data does not start
    on a 16-byte boundary (the K3 and K4 kernels load 16-byte chunks)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call needs: ``ops`` by the peak class it runs at
    (``bf16`` and ``f16`` tensor cores, ``f32`` CUDA cores, ``int32``
    INT32 lanes; a multiply-add counts 2) and the ``bytes`` it must move
    (each input read once, each output written once)."""
    ops: dict
    bytes: int


# {operator overload: formula(*args) -> Work}, args as the operator gets them
WORK: dict = {}


def call(op, impls, tensors, *args):
    """``op(*args)``, or ``impls[device type](*args)`` (the operator's own
    CUDA or CPU implementation) when no dispatch mode is active and each
    of ``tensors`` is a plain tensor: the same result, without the
    operator's dispatch."""
    if _get_current_dispatch_mode() is None and \
            all(type(t) is torch.Tensor for t in tensors):
        return impls[tensors[0].device.type](*args)
    return op(*args)


def register_work(op, formula):
    """Register ``formula`` as the work of custom operator ``op`` (a
    ``CustomOpDef`` or an ``OpOverload``), for ``launch/hlo_cost.py`` and,
    as its operations summed, for ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import register_flop_formula
    overload = getattr(op, "_opoverload", op)
    WORK[overload] = formula

    def flops(*args, out_val=None, **kwargs):
        return sum(formula(*args, **kwargs).ops.values())
    register_flop_formula(overload.overloadpacket, get_raw=True)(flops)
    return op


def float_key(dtype) -> str:
    """The peak class of a kernel's float work in ``dtype``: bf16 and fp16
    run on the tensor cores, anything else on the CUDA cores as f32."""
    return {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype, "f32")


def nbytes(*ts) -> int:
    """Bytes of the tensors, each once."""
    return sum(t.numel() * t.element_size() for t in ts)
