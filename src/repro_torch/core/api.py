"""Public alignment API of the port (counterpart of ``repro.core.api``):
spec + params + sequences -> Alignment.

Calls pad to a power-of-two length bucket and run the shared plan from
``repro_torch.runtime.plan``, so repeated mixed-length calls reuse one plan
per ``(kernel, engine, bucket, device)``.  ``device`` defaults to
``"cuda"``; without a CUDA device the call raises unless the caller passes
``device="cpu"``.  Results are tensors on that device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime import bucketing
from repro_torch.runtime import plan as plan_mod

from . import types as T


def as_codes(x, dtype, dev):
    """Sequence codes (array or tensor) as a tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def _fit_to_bucket(arr, bucket: int):
    """Slice or zero-pad ``arr`` along axis 0 to exactly ``bucket``."""
    n = arr.shape[0]
    if n >= bucket:
        return arr[:bucket]
    pad = torch.zeros((bucket - n,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    return torch.cat([arr, pad], dim=0)


def _dispatch(spec, params, query, ref, q_len, r_len, engine_name,
              with_traceback, mode, device, **options):
    dev = plan_mod.resolve_device(device)
    query = as_codes(query, spec.char_dtype, dev)
    ref = as_codes(ref, spec.char_dtype, dev)
    q_len = int(query.shape[0] if q_len is None else q_len)
    r_len = int(ref.shape[0] if r_len is None else r_len)
    bq = bucketing.bucket_length(q_len)
    br = bucketing.bucket_length(r_len)
    # effective lengths bound the live cells, so shapes may shrink to the
    # bucket as well as grow; the plan key depends only on the bucket
    query = _fit_to_bucket(query, bq)
    ref = _fit_to_bucket(ref, br)
    plan = plan_mod.get_plan(spec, engine_name, tuple(query.shape),
                             tuple(ref.shape), with_traceback=with_traceback,
                             mode=mode, device=dev, **options)
    return plan(params, query, ref, q_len, r_len)


def align(spec: T.DPKernelSpec, params, query, ref, q_len=None, r_len=None,
          engine_name: str = "wavefront", with_traceback: bool = True,
          device="cuda", **options) -> T.Alignment:
    """Matrix fill + (optional) traceback for one sequence pair.
    ``options`` are engine options (``xdrop=``, ``strip=``, ...) passed to
    ``get_plan``."""
    return _dispatch(spec, params, query, ref, q_len, r_len, engine_name,
                     with_traceback, "align", device, **options)


def score_only(spec, params, query, ref, q_len=None, r_len=None,
               engine_name: str = "wavefront", device="cuda"):
    return align(spec, params, query, ref, q_len, r_len, engine_name,
                 with_traceback=False, device=device).score


def fill(spec, params, query, ref, q_len=None, r_len=None,
         engine_name: str = "wavefront", device="cuda") -> T.DPResult:
    return _dispatch(spec, params, query, ref, q_len, r_len, engine_name,
                     False, "fill", device)
