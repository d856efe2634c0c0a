"""Point-scope lint rules (counterpart of ``repro.analyze.rules``):
recurrence legality, cache-key and dtype hazards, and K1's launch budgets,
all without a card.

Rule IDs keep JAX's families:

  * R1xx recurrence legality — the declarative spec really is the
    recurrence the engines schedule (the PE called on CPU tensors);
  * R2xx cache-key and dtype hazards — one logical point maps to one cache
    entry, and the fill keeps the declared dtypes;
  * R3xx transfers — where the program waits for the device: host reads in
    the PE, tensors the PE captures, host reads in the point's program
    (``launch.hlo_cost.HostReads`` in place of JAX's jaxpr and HLO);
  * R4xx budgets — K1's shared memory and grid, and the traceback store.

Each rule is
``fn(ctx, cfg) -> iterable[Finding]`` over a
:class:`~repro_torch.analyze.context.PointContext`; ``scope='kernel'``
rules are engine-independent and run once per kernel.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import types
from typing import Callable, Iterator, List

import numpy as np
import torch

from repro_torch.core import types as T
from repro_torch.launch import hlo_cost
from repro_torch.runtime import plan as plan_mod
from repro_torch.runtime import registry

from .findings import ERROR, INFO, WARNING, Finding


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    severity: str                 # default severity of its findings
    scope: str                    # 'point' | 'kernel' | 'global'
    fn: Callable
    doc: str = ""


_N_CELLS = 4


# ---------------------------------------------------------------------------
# R1xx — recurrence legality
# ---------------------------------------------------------------------------
def _pe_args(spec, params):
    """The PE's arguments on ``_N_CELLS`` cells of zero-coded characters
    and zero neighbours, CPU tensors of the declared shapes and dtypes."""
    n, L = _N_CELLS, spec.n_layers
    char = tuple(spec.char_shape)
    q = torch.zeros((n,) + char, dtype=spec.char_dtype)
    zeros = torch.zeros((n, L), dtype=spec.score_dtype)
    idx = torch.ones((n,), dtype=torch.int32)
    return params, q, q.clone(), zeros, zeros, zeros, idx, idx


def rule_pe_contract(ctx, cfg) -> Iterator[Finding]:
    """R101: the PE and init declarations satisfy the engines' cell
    contract.  Every engine calls ``spec.pe(params, q, r, diag, up, left,
    i, j)`` on (N,) characters and (N, n_layers) neighbours and trusts it
    to return (N, n_layers) scores of ``score_dtype`` and (N,) integer
    pointers; the boundary initializers must give n x n_layers scores
    without a lossy cast.  A violation mis-fills on every engine, so this
    runs once per kernel."""
    spec = ctx.spec
    where = spec.name
    try:
        scores, ptr = spec.pe(*_pe_args(spec, ctx.params))
    except Exception as e:
        yield Finding("R101", ERROR,
                      f"PE failed on CPU tensors of the cell contract "
                      f"(params, q_char, r_char, diag[N, L], up[N, L], "
                      f"left[N, L], i, j): {type(e).__name__}: {e}", where)
        return
    want_shape = (_N_CELLS, spec.n_layers)
    if tuple(scores.shape) != want_shape:
        yield Finding("R101", ERROR,
                      f"PE returns scores of shape {tuple(scores.shape)} "
                      f"for {_N_CELLS} cells; n_layers={spec.n_layers} "
                      f"requires {want_shape}", where)
    if scores.dtype != spec.score_dtype:
        yield Finding("R101", ERROR,
                      f"PE returns {scores.dtype} scores but the spec "
                      f"declares score_dtype={spec.score_dtype} — the "
                      f"engines' cast would silently truncate or promote "
                      f"every cell", where)
    if spec.traceback is not None:
        if tuple(ptr.shape) != (_N_CELLS,):
            yield Finding("R101", ERROR,
                          f"PE traceback pointers must be one per cell, got "
                          f"shape {tuple(ptr.shape)}", where)
        if ptr.dtype.is_floating_point or ptr.dtype == torch.bool:
            yield Finding("R101", ERROR,
                          f"PE traceback pointer must be an integer, got "
                          f"{ptr.dtype}", where)
    n = 8
    idx = torch.arange(n, dtype=torch.int32)
    try:
        row = spec.init_row(ctx.params, idx)
        col = spec.init_col(ctx.params, idx)
    except Exception as e:
        yield Finding("R101", ERROR,
                      f"boundary initializer failed: "
                      f"{type(e).__name__}: {e}", where)
        return
    for name, out in (("init_row", row), ("init_col", col)):
        out = torch.as_tensor(out)
        if out.numel() != n * spec.n_layers:
            yield Finding("R101", ERROR,
                          f"{name} returns {out.numel()} scores for {n} "
                          f"indices; engines reshape to (n, n_layers="
                          f"{spec.n_layers})", where)
        if out.dtype.is_floating_point and \
                not spec.score_dtype.is_floating_point:
            yield Finding("R101", ERROR,
                          f"{name} returns {out.dtype} for integer "
                          f"score_dtype={spec.score_dtype} — the engines' "
                          f"cast truncates boundary scores", where)


def rule_band_reach(ctx, cfg) -> Iterator[Finding]:
    """R102: a banded kernel can reach its objective region at the linted
    bucket.  With |i - j| <= W, a corner objective at (Q, R) lies outside
    the band whenever |Q - R| > W, and every plan at the bucket returns the
    sentinel."""
    spec = ctx.spec
    if spec.band is None:
        return
    W = int(spec.band)
    Q, R = ctx.point.bucket
    where = f"{spec.name} {Q}x{R}"
    if W < 1:
        yield Finding("R102", ERROR,
                      f"band width {W} prunes the whole matrix", where)
        return
    gap = None
    if spec.region == T.REGION_CORNER:
        gap = abs(Q - R)
    elif spec.region == T.REGION_LAST_ROW:
        gap = Q - R                     # nearest last-row cell is (Q, R)
    if gap is not None and gap > W:
        yield Finding("R102", ERROR,
                      f"objective region {spec.region!r} unreachable: "
                      f"bucket {Q}x{R} needs |i-j| = {gap} > band {W} — "
                      f"every plan at this bucket returns the sentinel",
                      where)


def rule_unit_cost(ctx, cfg) -> Iterator[Finding]:
    """R103: the myers engine's unit-cost precondition holds.  K2 never
    calls ``spec.pe`` — the bit-vector recurrence is Levenshtein — so a
    kernel whose PE or boundary is not unit-cost silently gets the wrong
    distance.  Probe the PE on concrete cells against ``min(diag + [q !=
    r], up + 1, left + 1)``."""
    if not ctx.point.engine.startswith("myers"):
        return
    spec, params = ctx.spec, ctx.params
    where = f"{spec.name}×{ctx.point.engine}"
    probes = [(0, 0, 3, 5, 7), (0, 1, 2, 2, 2), (1, 3, 0, 9, 1),
              (2, 2, 4, 0, 5)]
    try:
        for q, r, d, u, lft in probes:
            char = lambda v: torch.tensor([v], dtype=spec.char_dtype)
            cell = lambda v: torch.tensor([[v]], dtype=spec.score_dtype)
            one = torch.ones((1,), dtype=torch.int32)
            scores, _ = spec.pe(params, char(q), char(r), cell(d), cell(u),
                                cell(lft), one, one)
            got = int(scores.reshape(-1)[0])
            want = min(d + (0 if q == r else 1), u + 1, lft + 1)
            if got != want:
                yield Finding("R103", ERROR,
                              f"PE is not the unit-cost recurrence: at "
                              f"(q={q}, r={r}, diag={d}, up={u}, "
                              f"left={lft}) PE gives {got}, Levenshtein "
                              f"gives {want} — the bit-parallel engine "
                              f"would silently disagree", where)
                return
        idx = torch.arange(4, dtype=torch.int32)
        col = torch.as_tensor(spec.init_col(params, idx)).reshape(-1)[:4]
        if not np.array_equal(col.numpy(), np.arange(4)):
            yield Finding("R103", ERROR,
                          f"init_col must be D[i][0] = i for the unit-cost "
                          f"recurrence, got {col.tolist()}", where)
        row = torch.as_tensor(spec.init_row(params, idx)).reshape(-1)[:4]
        want_row = (np.arange(4) if spec.region == T.REGION_CORNER
                    else np.zeros(4))
        if not np.array_equal(row.numpy(), want_row):
            yield Finding("R103", ERROR,
                          f"init_row must be {want_row.astype(int).tolist()} "
                          f"for region {spec.region!r}, got {row.tolist()} — "
                          f"the myers engine's hin convention would diverge",
                          where)
    except Exception as e:
        yield Finding("R103", ERROR,
                      f"unit-cost probe failed: {type(e).__name__}: {e}",
                      where)


# ---------------------------------------------------------------------------
# R2xx — cache-key and dtype hazards
# ---------------------------------------------------------------------------
def rule_plan_key(ctx, cfg) -> Iterator[Finding]:
    """R201: one logical plan point = one cache entry.  The spec and every
    resolved option must be hashable (they form the cache key), and option
    resolution must be deterministic."""
    where = ctx.point.label
    try:
        hash(ctx.spec)
    except TypeError as e:
        yield Finding("R201", ERROR,
                      f"kernel spec is unhashable ({e}) — get_plan's cache "
                      f"key raises at every dispatch (check tuple-valued "
                      f"fields like char_shape)", where)
        return
    try:
        opts_a = dict(ctx.options)
        opts_b = plan_mod.resolve_engine_options(
            ctx.spec, ctx.point.engine, {}, ctx.device)
        opts_c = plan_mod.resolve_engine_options(
            ctx.spec, ctx.point.engine, {}, ctx.device)
    except Exception as e:
        yield Finding("R201", ERROR,
                      f"engine option resolution failed: "
                      f"{type(e).__name__}: {e}", where)
        return
    if opts_b != opts_c:
        yield Finding("R201", ERROR,
                      f"option resolution is nondeterministic: two empty "
                      f"requests resolved to {opts_b} and {opts_c} — every "
                      f"dispatch builds a plan under a fresh key", where)
    for name, value in sorted(opts_a.items()):
        try:
            hash(value)
        except TypeError:
            yield Finding("R201", ERROR,
                          f"resolved option {name}={value!r} is unhashable "
                          f"— PlanKey/cache-key construction raises", where)
    try:
        hash(ctx.key)
    except TypeError as e:
        yield Finding("R201", ERROR, f"PlanKey unhashable: {e}", where)


def rule_dtype_drift(ctx, cfg) -> Iterator[Finding]:
    """R202: the point's fill, run through the plain version of its kernel
    on the CPU, returns the declared score dtype and int32 end cells.  A
    spec declaring a dtype its kernel does not produce (a float64 score
    that K1 computes in f32) drifts silently."""
    where = ctx.point.label
    try:
        out = ctx.fill_out
    except Exception as e:
        yield Finding("R202", ERROR,
                      f"plan fails its plain fill: "
                      f"{type(e).__name__}: {e}", where)
        return
    got = torch.as_tensor(out.score).dtype
    if got != ctx.spec.score_dtype:
        yield Finding("R202", ERROR,
                      f"declared score_dtype={ctx.spec.score_dtype} but the "
                      f"plan's fill returns {got}", where)
    for name in ("end_i", "end_j"):
        dt = torch.as_tensor(getattr(out, name)).dtype
        if dt != torch.int32:
            yield Finding("R202", ERROR,
                          f"{name} comes back as {dt}, not int32", where)


def rule_wide_params(ctx, cfg) -> Iterator[Finding]:
    """R203: no float64 or int64 parameter leaves.  K1's wrapper hands its
    scalars to the kernel as int32 or f32 and its tables as int32 or f32,
    so a 64-bit leaf is narrowed silently on the card while the plain
    version computes in 64 bits.  Engine-independent: once per kernel."""
    spec = ctx.spec
    for name, leaf in sorted(dict(ctx.params).items()):
        if isinstance(leaf, torch.Tensor):
            dt = leaf.dtype
            wide = dt in (torch.float64, torch.int64)
        elif isinstance(leaf, np.ndarray) or isinstance(leaf, np.generic):
            dt = np.asarray(leaf).dtype
            wide = dt.kind in "fiu" and dt.itemsize == 8
        else:
            continue                       # Python numbers: cast at launch
        if wide:
            yield Finding("R203", WARNING,
                          f"param {name!r} is {dt} — K1 narrows it to 32 "
                          f"bits on the card while the plain version keeps "
                          f"64", spec.name)


# ---------------------------------------------------------------------------
# R3xx — transfers: where the program waits for the device
# ---------------------------------------------------------------------------
def rule_host_callback(ctx, cfg) -> Iterator[Finding]:
    """R301: no host read inside the PE or the boundary initializers.  The
    PE and the initializers run on the CPU cells of R101's probe, their
    tensors and the params marked as the device's, under
    ``launch.hlo_cost.HostReads``: any ``.item()``, ``int``/``bool``/
    ``float`` of a tensor, ``.tolist()``, ``.numpy()``, ``print`` or
    data-dependent shape there is an error.  The eager engines
    (``reference``, ``banded``, X-drop) call the PE once a diagonal, so on
    the card each such read stalls the device every step, the hazard JAX's
    R301 finds as a callback in the traced fill.  Engine-independent: once
    per kernel."""
    spec = ctx.spec
    where = spec.name
    det = hlo_cost.HostReads()
    try:
        args = det.marked(_pe_args(spec, ctx.params))
        idx = det.marked(torch.arange(8, dtype=torch.int32))
        with det:
            spec.pe(*args)
            spec.init_row(args[0], idx)
            spec.init_col(args[0], idx)
    except Exception as e:
        yield Finding("R301", ERROR,
                      f"PE or initializer failed under the host-read "
                      f"detector: {type(e).__name__}: {e}", where)
        return
    for site, reads in _by_site(det.reads):
        yield Finding("R301", ERROR,
                      f"host read in the PE or its initializers at {site}: "
                      f"{_describe(reads)} — on the eager engines every PE "
                      f"call waits for the device", where)


def _by_site(reads):
    sites = {}
    for r in reads:
        sites.setdefault(r.site, []).append(r)
    return sorted(sites.items())


def _describe(reads) -> str:
    ops = sorted({r.op for r in reads})
    shapes = sorted({r.shape for r in reads})
    return (f"{'/'.join(ops)} of a {'/'.join(str(list(s)) for s in shapes)} "
            f"tensor, {len(reads)} time{'s' if len(reads) > 1 else ''}")


def _captured(fn, depth=0, seen=None):
    """(name, value) of what ``fn`` closes over: closure cells, the globals
    it names, its defaults, a ``functools.partial``'s bound arguments, and
    the same of the plain functions among them (three levels deep)."""
    seen = set() if seen is None else seen
    if id(fn) in seen or depth > 3:
        return
    seen.add(id(fn))
    if isinstance(fn, functools.partial):
        for i, a in enumerate(fn.args):
            yield f"partial argument {i}", a
        for k, a in (fn.keywords or {}).items():
            yield f"partial argument {k}", a
        yield from _captured(fn.func, depth + 1, seen)
        return
    fn = getattr(fn, "__func__", fn)
    if not isinstance(fn, types.FunctionType):
        return
    cv = inspect.getclosurevars(fn)
    named = list(cv.nonlocals.items()) + list(cv.globals.items())
    named += [(f"default {i}", d) for i, d in
              enumerate(fn.__defaults__ or ())]
    named += [(f"default {k}", d) for k, d in
              (fn.__kwdefaults__ or {}).items()]
    for name, value in named:
        yield name, value
        if isinstance(value, (types.FunctionType, functools.partial)) and \
                not getattr(value, "__module__", "").startswith(
                    ("torch", "numpy")):
            yield from _captured(value, depth + 1, seen)


def _arrays(name, value):
    """The tensors and arrays in a captured value (itself, or one level
    into a list, tuple or dict)."""
    if isinstance(value, (torch.Tensor, np.ndarray)):
        yield name, value
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            if isinstance(v, (torch.Tensor, np.ndarray)):
                yield f"{name}[{i}]", v
    elif isinstance(value, dict):
        for k, v in value.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                yield f"{name}[{k!r}]", v


def rule_const_capture(ctx, cfg) -> Iterator[Finding]:
    """R302: no large tensor or array captured by the PE or the boundary
    initializers.  On the eager engines a captured CPU tensor is copied to
    the card at every PE call (once a diagonal), and the plan key, which
    sees the spec and params only, does not see it: change it and a cached
    plan keeps the old one's traffic.  The captures are read from each
    function's closure cells, the globals it names, its defaults and a
    ``functools.partial``'s arguments (``_captured``); the params are
    arguments, not captures, and a captured params leaf is not counted.
    What the closure cannot show: attributes of a captured object (a
    module, a class instance or a callable object), and tensors a function
    reaches through a container more than one level deep.
    Engine-independent: once per kernel."""
    spec = ctx.spec
    where = spec.name
    own = {id(v) for v in dict(ctx.params).values()} \
        if isinstance(ctx.params, dict) else set()
    found = {}
    for fname, fn in (("pe", spec.pe), ("init_row", spec.init_row),
                      ("init_col", spec.init_col)):
        for name, value in _captured(fn):
            for label, arr in _arrays(name, value):
                if id(arr) not in own and id(arr) not in found:
                    found[id(arr)] = (fname, label, arr)
    for fname, label, arr in found.values():
        if isinstance(arr, torch.Tensor):
            nbytes = arr.numel() * arr.element_size()
            kind, dt = "tensor", str(arr.dtype).replace("torch.", "")
        else:
            nbytes, kind, dt = arr.nbytes, "array", str(arr.dtype)
        what = f"{fname} captures {label}, a {dt}{list(arr.shape)} {kind}"
        if nbytes >= cfg.const_error_bytes:
            yield Finding("R302", ERROR,
                          f"{what} of {nbytes >> 20} MiB — copied to the "
                          f"card at every PE call of the eager engines and "
                          f"invisible to the plan key", where)
        elif nbytes >= cfg.const_warn_bytes:
            yield Finding("R302", WARNING,
                          f"{what} of {nbytes >> 10} KiB; prefer passing it "
                          f"as a param so the plan key sees it and it moves "
                          f"to the card once", where)


def rule_hlo_transfer(ctx, cfg) -> Iterator[Finding]:
    """R303: the point's whole program (fill plus traceback walk, as
    ``launch.hlo_cost.analyze_plan`` builds it) reads no device tensor on
    the host.  It runs once on the CPU under ``HostReads``, the engine
    handed marked copies of what the plan puts on the device, so each read
    the card would wait for is found at its frame; one finding per site,
    with the op, the shape and ``file:line:function``.  JAX runs fill and
    walk inside one jitted loop, which has none; the port's eager syncs
    (the walk's early exit every ``DONE_CHECK_EVERY`` steps, the eager
    engines' fill bound) are its own, not faults of its results.  Kernel
    launches are not looked inside (on the CPU their plain versions run).
    Off with ``LintConfig(hlo_rules=False)``; an INFO where the program
    cannot run on the CPU."""
    if not cfg.hlo_rules:
        return
    where = ctx.point.label
    try:
        reads = ctx.host_reads
    except Exception as e:
        yield Finding("R303", INFO,
                      f"program does not run on the CPU "
                      f"({type(e).__name__}: {e}); host-read scan skipped",
                      where)
        return
    for site, rs in _by_site(reads):
        yield Finding("R303", WARNING,
                      f"host read at {site}: {_describe(rs)} — the host "
                      f"waits for the device there", where)


# ---------------------------------------------------------------------------
# R4xx — K1's launch budgets and the traceback store
# ---------------------------------------------------------------------------
def _k1_geometry(ctx, cfg):
    """(padded query bucket, reference bucket, warps per pair, whether the
    warps were asked for) of a K1 point."""
    from repro_torch.kernels.wavefront import kernel as K1
    Q, R = ctx.point.bucket
    Qp = -(-Q // K1.N_PE) * K1.N_PE
    warps = ctx.options.get("strip_warps")
    if warps is not None:
        return Qp, R, int(warps), True
    sms = cfg.model(ctx.device).sms
    return Qp, R, K1.strip_warps(Qp, ctx.point.batch_size or 1, sms), False


def _ptxas_findings(source, label, where, include_dirs=()
                    ) -> Iterator[Finding]:
    from repro_torch.kernels import build
    log = build.kept_report(source, include_dirs)
    if log is None:
        yield Finding("R401", INFO,
                      f"no ptxas report kept for {label} "
                      f"({source.name} not built here); registers and "
                      f"spills unchecked", where)
        return
    rows = build.ptxas_entries(log)
    spilling = [(n, s) for n, _, s, _ in rows if s]
    regs = [r for _, r, _, _ in rows]
    yield Finding("R401", INFO,
                  f"{label}: {len(rows)} instantiations, "
                  f"{min(regs) if regs else '?'}-"
                  f"{max(regs) if regs else '?'} registers a thread, "
                  f"{len(spilling)} spilling", where)
    for name, spill in spilling:
        yield Finding("R401", WARNING,
                      f"{label} instantiation {name} spills {spill} bytes "
                      f"of registers", where)


def rule_k1_smem(ctx, cfg) -> Iterator[Finding]:
    """R401: K1's shared memory fits the card.  ``kernel.smem_bytes`` at
    the point's warps per pair (resolved ``strip_warps``, or the heuristic)
    against the device's per-block limit, or the stated H100's without a
    card: over it, the launch raises.  Where the build directory keeps the
    ptxas reports of K1 (the wavefront engine) or K2 (myers), their
    registers and spills are reported too; without one, an INFO says so."""
    eng = ctx.point.engine
    where = ctx.point.label
    if eng == "myers":
        from repro_torch.kernels.myers import kernel as K2
        yield from _ptxas_findings(K2.SOURCE, "K2", where)
        return
    if eng != "wavefront" or ctx.fill != registry.K1_FILL:
        return
    from repro_torch.kernels.wavefront import kernel as K1
    Qp, R, warps, _ = _k1_geometry(ctx, cfg)
    with_tb = ctx.point.with_traceback
    need = K1.smem_bytes(ctx.spec, Qp, R, warps, with_tb)
    limit = cfg.smem_limit(ctx.device)
    if need > limit:
        yield Finding("R401", ERROR,
                      f"K1 needs {need} bytes of shared memory a block at "
                      f"{warps} warps a pair; the card allows {limit} — the "
                      f"launch raises; shrink the reference bucket or the "
                      f"warps", where)
    elif need > limit // 2:
        yield Finding("R401", WARNING,
                      f"K1 needs {need} bytes of shared memory a block, over "
                      f"half the card's {limit}: one pair per SM", where)
    # a generated PE is no gap model: its report is its own translation
    # unit's, kept once it was built here
    src = K1.source_of(ctx.spec, ctx.params)
    if src is None:
        yield Finding("R401", INFO,
                      f"K1's functor for {ctx.spec.name} is generated from "
                      f"its PE and not lowered for these parameters; "
                      f"registers and spills unchecked", where)
        return
    include = (K1.CSRC,) if K1.is_generated(ctx.spec) else ()
    yield from _ptxas_findings(src, "K1", where, include)


def rule_k1_grid(ctx, cfg) -> Iterator[Finding]:
    """R402: K1's grid is legal.  ``tb_pack`` must divide the 32-lane strip
    (the wrapper refuses anything else), the warps per pair must lie in
    ``kernel.warps_range`` of the query bucket (the wrapper raises), and a
    query bucket off the strip height pads idle lanes (info)."""
    if ctx.point.engine != "wavefront" or ctx.fill != registry.K1_FILL:
        return
    from repro_torch.kernels.wavefront import kernel as K1
    where = ctx.point.label
    pack = ctx.options["tb_pack"]
    if pack not in (1, 2, 4, 8) or K1.N_PE % pack:
        yield Finding("R402", ERROR,
                      f"tb_pack={pack} does not divide the {K1.N_PE}-lane "
                      f"strip — K1 refuses to launch", where)
    Qp, _, warps, asked = _k1_geometry(ctx, cfg)
    lo, hi = K1.warps_range(Qp)
    if not lo <= warps <= hi:
        yield Finding("R402", ERROR,
                      f"{'strip_warps' if asked else 'heuristic'}={warps} "
                      f"warps a pair is outside [{lo}, {hi}] for a query "
                      f"bucket of {ctx.point.bucket[0]} — K1 refuses to "
                      f"launch", where)
    Q = ctx.point.bucket[0]
    if Q % K1.N_PE:
        yield Finding("R402", INFO,
                      f"query bucket {Q} pads to {Qp} lanes "
                      f"({100 * (Qp - Q) // Qp}% idle PEs); bucket to a "
                      f"multiple of {K1.N_PE}", where)


def rule_tb_budget(ctx, cfg) -> Iterator[Finding]:
    """R403: the block's traceback store fits the serving memory budget.
    ``traceback_bytes x batch`` is the per-block memory the services size
    their queues by."""
    p = ctx.point
    if not p.with_traceback or p.batch_size is None:
        return
    sup = registry.engine_options(p.engine)
    kw = {k: ctx.options[k] for k in ("strip", "tb_pack", "xdrop")
          if k in sup}
    per = plan_mod.traceback_bytes(ctx.spec, p.bucket[0], p.bucket[1],
                                   engine_name=p.engine, device=ctx.device,
                                   **kw)
    total = per * p.batch_size
    if total > cfg.tb_budget_bytes:
        yield Finding("R403", WARNING,
                      f"traceback store {total >> 20} MiB "
                      f"({per} B × batch {p.batch_size}) exceeds the "
                      f"{cfg.tb_budget_bytes >> 20} MiB block budget — "
                      f"split the block or raise tb_pack", p.label)


POINT_RULES: List[Rule] = [
    Rule("R101", "pe-contract", ERROR, "kernel", rule_pe_contract,
         "PE/init shapes and dtypes on CPU tensors match the declaration"),
    Rule("R102", "band-reach", ERROR, "kernel", rule_band_reach,
         "banded objective region reachable at the linted bucket"),
    Rule("R103", "unit-cost", ERROR, "point", rule_unit_cost,
         "myers engine's hard-coded recurrence matches the kernel PE"),
    Rule("R201", "plan-key", ERROR, "point", rule_plan_key,
         "hashable, deterministic plan cache keys"),
    Rule("R202", "dtype-drift", ERROR, "point", rule_dtype_drift,
         "the plain fill returns the declared score dtype"),
    Rule("R203", "wide-params", WARNING, "kernel", rule_wide_params,
         "no float64/int64 parameter leaves K1 would narrow"),
    Rule("R301", "host-callback", ERROR, "kernel", rule_host_callback,
         "no host read in the PE or its initializers"),
    Rule("R302", "const-capture", WARNING, "kernel", rule_const_capture,
         "no large tensor captured by the PE or its initializers"),
    Rule("R303", "hlo-transfer", WARNING, "point", rule_hlo_transfer,
         "where the point's program reads a device tensor on the host"),
    Rule("R401", "k1-smem", ERROR, "point", rule_k1_smem,
         "K1 shared memory within the card's limit; ptxas spills"),
    Rule("R402", "k1-grid", ERROR, "point", rule_k1_grid,
         "K1 tb_pack divides the strip; warps per pair in range"),
    Rule("R403", "tb-budget", WARNING, "point", rule_tb_budget,
         "block traceback store within the serving memory budget"),
]
