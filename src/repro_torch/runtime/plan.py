"""Plan cache of the port (counterpart of ``repro.runtime.plan``).

A plan is the fill (+ traceback) for one ``(kernel, engine, bucket shape,
batch size, traceback, mode, device, options)``: a Python callable with its
engine options resolved, memoized so that api, batch, dispatch, tiling and
the services share one cache.  PyTorch runs eagerly, so nothing is traced or
compiled here; the CUDA kernel itself is built once per process at its
first launch.  ``CompiledPlan.compile_s`` is the wall time of a plan's first
dispatch: on the card the kernel library's build or load and the first
launch (an align plan's traceback walk waits for the fill), the cold cost
that a service's ``warm_start=`` moves to boot.  It is recorded under a
``plan.compile`` span and in the compile ledger
(``repro_torch.obs.metrics``), which outlives
``clear_plan_cache(keep_stats=True)``; the ledger's ``library_s`` is the
part of it spent building or loading kernel libraries
(``kernels/build.py::load``).  Every call runs under ``plan.get`` (the
lookup) and ``plan.run`` (the call, its host lengths under ``plan.lens``)
spans (``repro_torch.obs.trace``).  Defaults that JAX keys on
``jax.default_backend()`` key on the plan's explicit device instead, and
``PlanKey.device`` splits the cache.  When a caller passes no schedule
option, ``get_plan`` consults the port's tuning table
(``repro_torch.tune.table``) first, as JAX's does; explicit options win.
A batched plan passes ``live_bound = max(q_lens + r_lens)`` to an engine
that declares it ``"dynamic"``.  JAX's ``donate=`` has no counterpart:
eager torch holds no compiled executable whose input buffers it could
reuse, so ``get_plan`` takes no such argument and the port's services do
not pass one.  ``get_plan(..., mesh=, mesh_axis=)`` gives a sharded plan:
each rank of the axis runs its contiguous rows of the batch (K1 on the
card) and an all-gather over the axis's group gives every rank the whole
batch's results; the mesh joins the cache key and its placement string
(``data@data=4xmodel=2``) the ``PlanKey``, so distinct meshes never share
a plan.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

import repro_torch.core.traceback as tb_mod
import repro_torch.core.types as T
from repro_torch.core.spec_utils import resolve_tb_pack
from repro_torch.kernels import build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

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
    xdrop: Optional[int] = None      # X-drop early termination; None = off
    strip: int = 1                   # anti-diagonals per loop test
    strip_warps: Optional[int] = None  # K1 warps per pair; None = heuristic
    placement: Optional[str] = None  # e.g. 'data@data=8' for sharded plans


def plan_key_str(key: PlanKey) -> str:
    """``kernel/engine/QxR/bN/tb/mode/pP[sS][wW]/semiring[/xN]
    [/placement]/device`` (the compile-ledger key); ``s`` and ``w`` appear
    only where the plan sets them away from their neutral values."""
    q, r = key.bucket_shape
    sched = f"p{key.tb_pack}"
    if key.strip != _NEUTRAL_OPTS["strip"]:
        sched += f"s{key.strip}"
    if key.strip_warps is not None:
        sched += f"w{key.strip_warps}"
    parts = [key.kernel, key.engine, f"{q[0]}x{r[0]}",
             "b1" if key.batch_size is None else f"b{key.batch_size}",
             "tb" if key.with_traceback else "notb", key.mode, sched,
             key.semiring]
    if key.xdrop is not None:
        parts.append(f"x{key.xdrop}")
    if key.placement:
        parts.append(key.placement)
    parts.append(key.device)
    return "/".join(parts)


def _host_lens(x, n: int) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x).to("cpu", torch.int32).reshape(-1)
    return t.expand(n).contiguous() if t.numel() == 1 else t.reshape(n)


class CompiledPlan:
    """Fill (+ traceback) for one bucket shape on one device.

    Call as ``plan(params, query, ref, q_len, r_len)`` with sequences
    already padded to ``bucket_shape`` and on the plan's device; lengths are
    scalars in single mode and ``(B,)`` in batch mode, on the host or the
    device.  ``calls`` counts dispatches, ``hits`` cache hits and
    ``compile_s`` is the wall time of the first dispatch (None before it).
    Plans are shared across threads: the first dispatch is timed once,
    under the plan's own lock, and ``calls`` counts under another.  With
    ``mesh`` (a batched plan only) every rank of ``mesh_axis`` passes the
    whole batch, runs its own contiguous rows and receives every row's
    results.
    """

    def __init__(self, key: PlanKey, spec: T.DPKernelSpec, engine_name: str,
                 mesh=None, mesh_axis: str = "data"):
        if mesh is not None and key.batch_size is None:
            raise ValueError("sharded plans require batch_size")
        self.key = key
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.spec = spec
        self.calls = 0
        self.hits = 0
        self.compile_s = None
        self._first = threading.Lock()
        self._count = threading.Lock()
        self._engine = registry.get_engine(engine_name)
        declared = registry.engine_options(engine_name)
        # the plan's resolved schedule knobs, forwarded by name; a
        # 'dynamic' option is a runtime argument, not a cache knob
        self._opts = {name: getattr(key, name)
                      for name, v in declared.items() if v != "dynamic"}
        self._bound = declared.get("live_bound") == "dynamic"
        self.fill = registry.engine_fill(engine_name, self._opts)

    def _run(self, params, queries, refs, q_lens, r_lens):
        with obs_trace.span("plan.run", cat="plan"):
            n = queries.shape[0]
            key = self.key
            bounded = self._bound or key.with_traceback
            with obs_trace.span("plan.lens", cat="plan"):
                ql_host = _host_lens(q_lens, n)
                rl_host = _host_lens(r_lens, n)
                dev = queries.device
                ql = ql_host.to(dev, non_blocking=True)
                rl = rl_host.to(dev, non_blocking=True)
                # one shared fill bound, known on the host (for a single
                # pair it is the pair's own q_len + r_len, the engine's
                # default)
                live = int((ql_host + rl_host).max()) if bounded and n else 0
            kw = dict(self._opts)
            if self._bound:
                kw["live_bound"] = live
            res = self._engine(self.spec, params, queries, refs, ql, rl,
                               with_tb=key.mode == "fill"
                               or key.with_traceback, **kw)
            if key.mode == "fill":
                return res
            if key.with_traceback:
                (q, *_), (r, *_) = key.bucket_shape
                return tb_mod.run_batched(self.spec, res, max_len=q + r + 1,
                                          step_bound=live + 1 if n else 0)
            return T.Alignment(score=res.score, end_i=res.end_i,
                               end_j=res.end_j)

    def __call__(self, params, query, ref, q_len=None, r_len=None):
        if self.compile_s is None:
            with self._first:
                if self.compile_s is None:
                    return self._first_call(params, query, ref, q_len, r_len)
        return self._dispatch(params, query, ref, q_len, r_len)

    def _first_call(self, params, query, ref, q_len, r_len):
        kstr = plan_key_str(self.key)
        with obs_trace.span("plan.compile", cat="plan", key=kstr):
            lib0 = build.thread_load_seconds()
            t0 = time.perf_counter()
            out = self._dispatch(params, query, ref, q_len, r_len)
            compile_s = time.perf_counter() - t0
        obs_metrics.record_compile(
            kstr, compile_s, library_s=build.thread_load_seconds() - lib0)
        obs_metrics.REGISTRY.counter("plan_compiles_total").inc()
        obs_metrics.REGISTRY.histogram("plan_compile_s").observe(compile_s)
        self.compile_s = compile_s
        return out

    def _dispatch(self, params, query, ref, q_len, r_len):
        (q, *_), (r, *_) = self.key.bucket_shape
        with self._count:
            self.calls += 1
        if self.mesh is not None:
            return self._run_sharded(params, query, ref,
                                     q if q_len is None else q_len,
                                     r if r_len is None else r_len)
        if self.key.batch_size is not None:
            return self._run(params, query, ref,
                             q if q_len is None else q_len,
                             r if r_len is None else r_len)
        out = self._run(params, query[None], ref[None],
                        q if q_len is None else q_len,
                        r if r_len is None else r_len)
        return _unbatch(out)

    def _run_sharded(self, params, queries, refs, q_lens, r_lens):
        """This rank's rows of the batch, then an all-gather over the
        axis of every per-row field of the result."""
        import torch.distributed as dist
        n = queries.shape[0]
        group = self.mesh.get_group(self.mesh_axis)
        size = dist.get_world_size(group)
        if n % size:
            raise ValueError(f"batch {n} does not divide the "
                             f"{self.mesh_axis!r} axis of size {size}")
        rows = slice(dist.get_rank(group) * (n // size),
                     (dist.get_rank(group) + 1) * (n // size))
        out = self._run(params, queries[rows].contiguous(),
                        refs[rows].contiguous(),
                        _host_lens(q_lens, n)[rows],
                        _host_lens(r_lens, n)[rows])
        return _gather_rows(out, n // size, group, size)

    def __repr__(self):
        return f"CompiledPlan({self.key}, calls={self.calls})"


def _gather_rows(out, n_local: int, group, size: int):
    """``out`` (an Alignment or DPResult of ``n_local`` rows) with each
    per-row tensor field all-gathered over ``group`` in rank order."""
    import torch.distributed as dist

    def gather(v):
        if not isinstance(v, torch.Tensor) or v.dim() == 0 \
                or v.shape[0] != n_local:
            return v
        t = v.contiguous()
        wire = t.view(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(wire) for _ in range(size)]
        dist.all_gather(parts, wire, group=group)
        full = torch.cat(parts)
        return full.view(torch.bool) if t.dtype == torch.bool else full
    kw = {f.name: gather(getattr(out, f.name))
          for f in dataclasses.fields(out)}
    return type(out)(**kw)


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


# neutral pins of knobs an engine does not declare or its fill ignores:
# the cache never splits on them
_NEUTRAL_OPTS = {"strip": 1, "tb_pack": 1, "xdrop": None,
                 "strip_warps": None}


def resolve_engine_options(spec: T.DPKernelSpec, engine_name: str,
                           requested: Optional[dict] = None,
                           device="cuda") -> dict:
    """Resolve every schedule knob an engine declares against a request
    (``None`` values mean the default) and return all of
    ``_NEUTRAL_OPTS``'s keys.

    Names the engine does not declare raise, listing the valid ones.  A
    per-device default (``strip``'s ``{'cpu': ..., 'default': ...}``)
    resolves against ``device``'s type; ``tb_pack`` falls back to
    ``spec.tb_pack`` and is 1 for kernels without traceback; ``xdrop`` is
    None (off) unless asked for; ``strip_warps`` None means K1's
    heuristic.  A knob the plan's fill ignores keeps its neutral value
    (``strip`` on a K1 plan, ``strip_warps`` on an eager-engine plan), so
    the cache does not split on it."""
    sup = registry.engine_options(engine_name)
    req = {k: v for k, v in dict(requested or {}).items() if v is not None}
    plan_knobs = {k for k, v in sup.items() if v != "dynamic"}
    unknown = sorted(set(req) - plan_knobs)
    if unknown:
        valid = sorted(plan_knobs)
        raise ValueError(
            f"engine {engine_name!r} does not accept option(s) {unknown}; "
            f"valid options: {valid if valid else '(none)'}")
    out = dict(_NEUTRAL_OPTS)
    for name in plan_knobs:
        default = sup[name]
        if name == "strip":
            strip = req.get("strip", default)
            if isinstance(strip, dict):
                strip = strip.get(torch.device(device).type,
                                  strip["default"])
            out["strip"] = validate_int_option("strip", strip, minimum=1)
        elif name == "tb_pack":
            if spec.traceback is None:
                continue
            tb_pack = req.get("tb_pack", default)
            if tb_pack is not None:
                tb_pack = validate_int_option("tb_pack", tb_pack)
            out["tb_pack"] = resolve_tb_pack(spec, tb_pack)
        elif name in ("xdrop", "strip_warps"):
            value = req.get(name, default)
            if value is not None:
                value = validate_int_option(
                    name, value, minimum=0 if name == "xdrop" else 1)
            out[name] = value
        else:
            out[name] = req.get(name, default)
    fill = registry.engine_fill(engine_name, out)
    if fill == registry.K1_FILL:
        out["strip"] = _NEUTRAL_OPTS["strip"]
    elif fill == registry.ENGINE_FILL:
        out["strip_warps"] = _NEUTRAL_OPTS["strip_warps"]
    return out


def _tuned_defaults(kernel: str, engine_name: str, bucket: tuple,
                    batch_size: Optional[int], device) -> Optional[dict]:
    """Winning schedule options from the port's tuning table, consulted
    only when the caller passed no explicit option.  Any problem with the
    table (missing, corrupt, stale schema) means no table: a bad table
    never breaks dispatch.  Only options the engine declares are
    forwarded."""
    try:
        from repro_torch.tune import table as tune_table
        with obs_trace.span("plan.tune_lookup", cat="plan", kernel=kernel,
                            engine=engine_name):
            tuned = tune_table.lookup(kernel, engine_name, bucket,
                                      batch_size, device=device)
    except Exception:
        obs_metrics.REGISTRY.counter("plan_tune_lookups_total",
                                     outcome="error").inc()
        return None
    obs_metrics.REGISTRY.counter(
        "plan_tune_lookups_total",
        outcome="hit" if tuned else "miss").inc()
    if not tuned:
        return None
    sup = registry.engine_options(engine_name)
    return {k: v for k, v in tuned.items()
            if v is not None and sup.get(k, "dynamic") != "dynamic"}


def traceback_bytes(spec: T.DPKernelSpec, q_bucket: int, r_bucket: int, *,
                    engine_name: str = "wavefront",
                    tb_pack: Optional[int] = None,
                    strip: Optional[int] = None,
                    xdrop: Optional[int] = None, device="cuda") -> int:
    """Pointer-store bytes one alignment occupies at a bucket shape.  K1's
    ('chunk', 32, pack) store is ceil(Q/32) strips of (32/pack) x
    (32+R-1) bytes; the eager engine's ('diag', pack) store (X-drop plans)
    is ceil((Q+R)/strip) * strip rows of ceil((Q+1)/pack) bytes."""
    if spec.traceback is None:
        return 0
    opts = resolve_engine_options(
        spec, engine_name, {"tb_pack": tb_pack, "strip": strip,
                            "xdrop": xdrop}, device)
    pack = opts["tb_pack"]
    if registry.engine_fill(engine_name, opts) == registry.ENGINE_FILL:
        strip_r = opts["strip"]
        rows = -(-(q_bucket + r_bucket) // strip_r) * strip_r
        return rows * -(-(q_bucket + 1) // pack)
    n_chunks = -(-q_bucket // N_PE)
    return n_chunks * (N_PE // pack) * (N_PE + r_bucket - 1)


def get_plan(spec: T.DPKernelSpec, engine_name: str,
             q_shape: tuple, r_shape: tuple, *,
             batch_size: Optional[int] = None,
             with_traceback: bool = True, mode: str = "align",
             device="cuda", strip: Optional[int] = None,
             tb_pack: Optional[int] = None, xdrop: Optional[int] = None,
             strip_warps: Optional[int] = None, mesh=None,
             mesh_axis: str = "data") -> CompiledPlan:
    """Fetch (or build) the shared plan for one bucketed input shape.

    ``q_shape``/``r_shape`` are per-pair shapes including char dims;
    ``batch_size=None`` is the single-pair variant.  The spec object itself
    keys the cache, as in the JAX package.  ``strip``, ``tb_pack``,
    ``xdrop`` and ``strip_warps`` are engine options (an engine that does
    not declare one raises when it is given); a path from a score-only
    engine raises.  With no option passed, the port's tuning table
    (``repro_torch.tune.table``, env ``REPRO_TORCH_TUNE_TABLE``) is
    consulted first; explicit options win, and
    ``REPRO_TORCH_TUNE_TABLE=off`` restores the hand-picked defaults.
    With ``mesh`` (a ``DeviceMesh``) the plan shards the batch over
    ``mesh_axis``; the mesh joins the cache key, so distinct meshes never
    share a plan."""
    with obs_trace.span("plan.get", cat="plan") as sp:
        dev = resolve_device(device)
        if mesh is None:
            mesh_axis = "data"   # meaningless unsharded; do not split on it
        reason = registry.engine_supports(engine_name, spec)
        if reason is not None:
            raise ValueError(f"engine {engine_name!r} cannot run kernel "
                             f"{spec.name}: {reason}")
        wtb = bool(with_traceback and spec.traceback is not None)
        if wtb and mode == "align" and \
                not registry.engine_traceback(engine_name):
            raise ValueError(f"engine {engine_name!r} is score-only; pass "
                             f"with_traceback=False for kernel {spec.name}")
        requested = {"strip": strip, "tb_pack": tb_pack, "xdrop": xdrop,
                     "strip_warps": strip_warps}
        if all(v is None for v in requested.values()):
            tuned = _tuned_defaults(spec.name, engine_name,
                                    (q_shape[0], r_shape[0]), batch_size, dev)
            if tuned:
                requested.update(tuned)
        opts = resolve_engine_options(spec, engine_name, requested, dev)
        cache_key = (spec, engine_name, tuple(q_shape), tuple(r_shape),
                     batch_size, wtb, mode, str(dev), mesh, mesh_axis,
                     *(opts[k] for k in sorted(_NEUTRAL_OPTS)))
        with _LOCK:
            plan = _CACHE.get(cache_key)
            if plan is not None:
                _STATS["hits"] += 1
                plan.hits += 1
                sp.set(cache="hit")
                obs_metrics.REGISTRY.counter("plan_cache_hits_total").inc()
                return plan
            _STATS["misses"] += 1
            sp.set(cache="miss")
            obs_metrics.REGISTRY.counter("plan_cache_misses_total").inc()
            key = PlanKey(kernel=spec.name, engine=engine_name,
                          bucket_shape=(tuple(q_shape), tuple(r_shape)),
                          batch_size=batch_size, with_traceback=wtb,
                          mode=mode, device=str(dev),
                          semiring=spec.semiring.name,
                          placement=_placement(mesh, mesh_axis), **opts)
            plan = CompiledPlan(key, spec, engine_name, mesh=mesh,
                                mesh_axis=mesh_axis)
            _CACHE[cache_key] = plan
            return plan


def _placement(mesh, mesh_axis: str) -> Optional[str]:
    """``axis@name=size[xname=size...]`` of a sharded plan, JAX's string;
    None unsharded."""
    if mesh is None:
        return None
    dims = "x".join(f"{n}={s}" for n, s in
                    zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return f"{mesh_axis}@{dims}"


# the history of plans retired by clear_plan_cache(keep_stats=True), so a
# session keeps its compile-time and call accounting across clears
_RETIRED = {"plans": 0, "calls": 0, "hits": 0, "compiled": 0,
            "compile_s": 0.0}


def _totals() -> dict[str, Any]:
    t = dict(_RETIRED)
    t["plans"] += len(_CACHE)
    for p in _CACHE.values():
        t["calls"] += p.calls
        t["hits"] += p.hits
        if p.compile_s is not None:
            t["compiled"] += 1
            t["compile_s"] += p.compile_s
    return t


def plan_cache_info() -> dict[str, Any]:
    """Cache-wide hit/miss counts plus each plan's key, the fill it runs
    (``registry.engine_fill``: ``'K1'`` or the eager engine for a
    ``wavefront`` plan), hits, calls and first-dispatch ``compile_s``;
    ``totals`` rolls calls, hits, compiles and
    compile seconds up across live plans and plans retired by
    ``clear_plan_cache(keep_stats=True)``, and ``compile_ledger`` holds the
    per-key record."""
    with _LOCK:
        plans = [{"key": p.key, "fill": p.fill, "hits": p.hits,
                  "calls": p.calls, "compile_s": p.compile_s}
                 for p in _CACHE.values()]
        return {"size": len(_CACHE), "hits": _STATS["hits"],
                "misses": _STATS["misses"],
                "keys": [p.key for p in _CACHE.values()], "plans": plans,
                "totals": _totals(),
                "compile_ledger": obs_metrics.compile_ledger_snapshot()}


def clear_plan_cache(keep_stats: bool = False) -> None:
    """Drop every plan.  ``keep_stats=True`` folds the retired plans' calls,
    hits and compile seconds into ``plan_cache_info()['totals']`` and their
    calls and hits into their ledger entries, and keeps the hit/miss counts;
    otherwise every count and the ledger start again."""
    with _LOCK:
        if keep_stats:
            for p in _CACHE.values():
                _RETIRED["plans"] += 1
                _RETIRED["calls"] += p.calls
                _RETIRED["hits"] += p.hits
                if p.compile_s is not None:
                    _RETIRED["compiled"] += 1
                    _RETIRED["compile_s"] += p.compile_s
                obs_metrics.COMPILE_LEDGER.update_usage(
                    plan_key_str(p.key), p.calls, p.hits)
        else:
            _STATS["hits"] = _STATS["misses"] = 0
            _RETIRED.update(plans=0, calls=0, hits=0, compiled=0,
                            compile_s=0.0)
            obs_metrics.COMPILE_LEDGER.clear()
        _CACHE.clear()
