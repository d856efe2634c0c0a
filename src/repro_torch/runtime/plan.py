"""Plan cache of the port (counterpart of ``repro.runtime.plan``).

A plan is the fill (+ traceback) for one ``(kernel, engine, bucket shape,
batch size, traceback, mode, device, options)``: a Python callable with its
engine options resolved, memoized so that api, batch and dispatch share one
cache.  PyTorch runs eagerly, so nothing is traced or compiled here; the
CUDA kernel itself is built once per process at its first launch.  Defaults
that JAX keys on ``jax.default_backend()`` key on the plan's explicit device
instead, and ``PlanKey.device`` splits the cache.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import numpy as np
import torch

import repro_torch.core.traceback as tb_mod
import repro_torch.core.types as T
from repro_torch.core.spec_utils import resolve_tb_pack

from . import registry

# lane-strip height of the wavefront kernel's ('chunk', n_pe) store
N_PE = 32


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA request without a CUDA
    device raises; it never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch version on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Human-readable identity of a plan (for ``plan_cache_info``)."""
    kernel: str
    engine: str
    bucket_shape: tuple              # ((Lq, *char), (Lr, *char))
    batch_size: Optional[int]        # None = single pair
    with_traceback: bool
    mode: str = "align"              # 'align' | 'fill'
    device: str = "cuda"
    tb_pack: int = 1                 # traceback pointers packed per byte
    semiring: str = "maxplus"


def plan_key_str(key: PlanKey) -> str:
    """``kernel/engine/QxR/bN/tb/mode/pP/semiring/device``."""
    q, r = key.bucket_shape
    return "/".join([
        key.kernel, key.engine, f"{q[0]}x{r[0]}",
        "b1" if key.batch_size is None else f"b{key.batch_size}",
        "tb" if key.with_traceback else "notb", key.mode,
        f"p{key.tb_pack}", key.semiring, key.device])


def _host_lens(x, n: int) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x).to("cpu", torch.int32).reshape(-1)
    return t.expand(n).contiguous() if t.numel() == 1 else t.reshape(n)


class CompiledPlan:
    """Fill (+ traceback) for one bucket shape on one device.

    Call as ``plan(params, query, ref, q_len, r_len)`` with sequences
    already padded to ``bucket_shape`` and on the plan's device; lengths are
    scalars in single mode and ``(B,)`` in batch mode, on the host or the
    device.  ``calls`` counts dispatches, ``hits`` cache hits.
    """

    def __init__(self, key: PlanKey, spec: T.DPKernelSpec, engine_name: str):
        self.key = key
        self.spec = spec
        self.calls = 0
        self.hits = 0
        self._engine = registry.get_engine(engine_name)
        self._opts = ({"tb_pack": key.tb_pack}
                      if "tb_pack" in registry.engine_options(engine_name)
                      else {})

    def _run(self, params, queries, refs, q_lens, r_lens):
        n = queries.shape[0]
        ql_host = _host_lens(q_lens, n)
        rl_host = _host_lens(r_lens, n)
        dev = queries.device
        ql = ql_host.to(dev, non_blocking=True)
        rl = rl_host.to(dev, non_blocking=True)
        key = self.key
        res = self._engine(self.spec, params, queries, refs, ql, rl,
                           with_tb=key.mode == "fill" or key.with_traceback,
                           **self._opts)
        if key.mode == "fill":
            return res
        if key.with_traceback:
            (q, *_), (r, *_) = key.bucket_shape
            bound = int((ql_host + rl_host).max()) + 1 if n else 0
            return tb_mod.run_batched(self.spec, res, max_len=q + r + 1,
                                      step_bound=bound)
        return T.Alignment(score=res.score, end_i=res.end_i,
                           end_j=res.end_j)

    def __call__(self, params, query, ref, q_len=None, r_len=None):
        (q, *_), (r, *_) = self.key.bucket_shape
        self.calls += 1
        if self.key.batch_size is not None:
            return self._run(params, query, ref,
                             q if q_len is None else q_len,
                             r if r_len is None else r_len)
        out = self._run(params, query[None], ref[None],
                        q if q_len is None else q_len,
                        r if r_len is None else r_len)
        return _unbatch(out)

    def __repr__(self):
        return f"CompiledPlan({self.key}, calls={self.calls})"


def _unbatch(out):
    """Row 0 of a batch-of-one result (the single-pair plan's output)."""
    kw = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}
    kw = {k: (v[0] if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    return type(out)(**kw)


# ---------------------------------------------------------------------------
# The shared cache.
# ---------------------------------------------------------------------------
_CACHE: dict[tuple, CompiledPlan] = {}
_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0}


def validate_int_option(name: str, value, *,
                        minimum: Optional[int] = None) -> int:
    """An integer option value (bools and non-integral floats rejected)."""
    if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
        raise ValueError(
            f"option {name!r} must be an integer, got {value!r} "
            f"({type(value).__name__})")
    value = int(value)
    if minimum is not None and value < minimum:
        raise ValueError(
            f"option {name!r} must be >= {minimum}, got {value}")
    return value


def validate_pow2_option(name: str, value) -> int:
    """An integer option that must also be a power of two (block-shaped
    knobs such as the mapper's ``screen_block``)."""
    v = validate_int_option(name, value, minimum=1)
    if v & (v - 1):
        raise ValueError(
            f"option {name!r} must be a power of two, got {v}")
    return v


def resolve_engine_options(spec: T.DPKernelSpec, engine_name: str,
                           requested: Optional[dict] = None) -> dict:
    """Resolve every option an engine declares against a request (``None``
    values mean the default).  Names the engine does not declare raise,
    listing the valid ones; ``tb_pack`` falls back to ``spec.tb_pack`` and
    is 1 for kernels without traceback."""
    sup = registry.engine_options(engine_name)
    req = {k: v for k, v in dict(requested or {}).items() if v is not None}
    unknown = sorted(set(req) - set(sup))
    if unknown:
        valid = sorted(sup)
        raise ValueError(
            f"engine {engine_name!r} does not accept option(s) {unknown}; "
            f"valid options: {valid if valid else '(none)'}")
    out = {"tb_pack": 1}
    if "tb_pack" in sup and spec.traceback is not None:
        tb_pack = req.get("tb_pack", sup["tb_pack"])
        if tb_pack is not None:
            tb_pack = validate_int_option("tb_pack", tb_pack)
        out["tb_pack"] = resolve_tb_pack(spec, tb_pack)
    return out


def traceback_bytes(spec: T.DPKernelSpec, q_bucket: int, r_bucket: int, *,
                    engine_name: str = "wavefront",
                    tb_pack: Optional[int] = None) -> int:
    """Pointer-store bytes one alignment occupies at a bucket shape: the
    ('chunk', 32, pack) store is ceil(Q/32) strips of (32/pack) x (32+R-1)
    bytes."""
    if spec.traceback is None:
        return 0
    pack = resolve_engine_options(spec, engine_name,
                                  {"tb_pack": tb_pack})["tb_pack"]
    n_chunks = -(-q_bucket // N_PE)
    return n_chunks * (N_PE // pack) * (N_PE + r_bucket - 1)


def get_plan(spec: T.DPKernelSpec, engine_name: str,
             q_shape: tuple, r_shape: tuple, *,
             batch_size: Optional[int] = None,
             with_traceback: bool = True, mode: str = "align",
             device="cuda", tb_pack: Optional[int] = None) -> CompiledPlan:
    """Fetch (or build) the shared plan for one bucketed input shape.

    ``q_shape``/``r_shape`` are per-pair shapes including char dims;
    ``batch_size=None`` is the single-pair variant.  The spec object itself
    keys the cache, as in the JAX package."""
    dev = resolve_device(device)
    reason = registry.engine_supports(engine_name, spec)
    if reason is not None:
        raise ValueError(f"engine {engine_name!r} cannot run kernel "
                         f"{spec.name}: {reason}")
    wtb = bool(with_traceback and spec.traceback is not None)
    pack = resolve_engine_options(spec, engine_name,
                                  {"tb_pack": tb_pack})["tb_pack"]
    cache_key = (spec, engine_name, tuple(q_shape), tuple(r_shape),
                 batch_size, wtb, mode, str(dev), pack)
    with _LOCK:
        plan = _CACHE.get(cache_key)
        if plan is not None:
            _STATS["hits"] += 1
            plan.hits += 1
            return plan
        _STATS["misses"] += 1
        key = PlanKey(kernel=spec.name, engine=engine_name,
                      bucket_shape=(tuple(q_shape), tuple(r_shape)),
                      batch_size=batch_size, with_traceback=wtb, mode=mode,
                      device=str(dev), tb_pack=pack,
                      semiring=spec.semiring.name)
        plan = CompiledPlan(key, spec, engine_name)
        _CACHE[cache_key] = plan
        return plan


def plan_cache_info() -> dict[str, Any]:
    """Cache-wide hit/miss counts plus each plan's key, hits and calls."""
    plans = [{"key": p.key, "hits": p.hits, "calls": p.calls}
             for p in _CACHE.values()]
    return {"size": len(_CACHE), "hits": _STATS["hits"],
            "misses": _STATS["misses"],
            "keys": [p.key for p in _CACHE.values()], "plans": plans}


def clear_plan_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _STATS["hits"] = _STATS["misses"] = 0
