"""Engine registry of the port (counterpart of ``repro.runtime.registry``).

An engine is a matrix-fill back-end ``fn(spec, params, queries, refs,
q_lens, r_lens, *, with_tb, **options) -> DPResult`` over a batch of padded
pairs (the batch axis is written out where JAX vmaps a per-pair engine);
``with_tb=False`` lets it skip the pointer store.  Built-ins
register with a deferred loader, or, for ``wavefront``, a router that
imports its fills at call time, so importing this module builds and loads
no kernel.

Registered: ``reference`` — the full-matrix oracle (``core.reference``),
eager torch on the inputs' device, every spec, with the (Q+1, R+1, L) matrix
and the ``'row'`` pointer store; ``wavefront`` — the anti-diagonal fill
with JAX's options ``strip``, ``tb_pack``, ``live_bound`` and ``xdrop``,
plus ``strip_warps`` (K1's warps per pair), routed by
:func:`wavefront_fill_route`: with ``xdrop=None`` it runs kernel K1 (CUDA on
CUDA tensors, its plain version on CPU tensors), exactly as a plain
wavefront plan always has; with ``xdrop`` set it runs ``core.engine``, eager
torch on the inputs' device, because K1's strips run as a time-offset
pipeline and no strip sees the others' cells on its diagonal, so none can
prune against the running best (JAX's Pallas K1 never took ``xdrop``
either: it is an option of its XLA engine).  K1 is never replaced where it
can run, and a K1 failure raises.  ``myers`` — kernel K2, the bit-vector
unit-cost engine for #16/#17 (score-only, no options), the same way;
``banded`` — the band-packed O(n·W) sweep (``core.banded``, eager torch on
the inputs' device, as JAX computes it outside any kernel), score-only, for
banded specs, with the ``xdrop`` option.  Score-only engines register
``traceback=False``.  ``engine_fill`` names the fill a plan runs.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Mapping, Optional, Protocol


class Engine(Protocol):
    """Matrix-fill back end: spec + params + a batch of padded pairs ->
    DPResult."""

    def __call__(self, spec, params, queries, refs, q_lens=None,
                 r_lens=None, *, with_tb=True, **options):
        ...


@dataclasses.dataclass
class _Entry:
    name: str
    fn: Optional[Callable] = None        # resolved engine
    loader: Optional[Callable] = None    # deferred constructor
    options: Mapping[str, object] = dataclasses.field(default_factory=dict)
    # option name -> candidate values the autotuner may sweep; only
    # result-preserving schedule knobs (never xdrop)
    tunable: Mapping[str, tuple] = dataclasses.field(default_factory=dict)
    # the fill a plan runs: a name, or fill(options) -> name
    fill: object = ""
    # supports(spec) -> None (accepted) | str (why the engine cannot run it)
    supports: Optional[Callable] = None
    # whether the engine emits a pointer store a traceback can walk
    traceback: bool = True


_REGISTRY: dict[str, _Entry] = {}
_LOCK = threading.Lock()


def register_engine(name: str, fn: Optional[Callable] = None, *,
                    loader: Optional[Callable] = None,
                    options: Optional[Mapping[str, object]] = None,
                    tunable: Optional[Mapping[str, tuple]] = None,
                    supports: Optional[Callable] = None,
                    traceback: bool = True, fill=None,
                    overwrite: bool = False) -> None:
    """Register engine ``name`` eagerly (``fn``) or deferred
    (``loader() -> fn``, resolved on first :func:`get_engine`).

    ``options`` maps the keyword knobs the engine accepts to their defaults
    (``None`` = resolved from the kernel spec at plan time, ``"dynamic"`` =
    a runtime argument the plan passes, not a cache knob); ``tunable``
    maps options to the candidate values the autotuner (``repro_torch.tune``)
    may sweep, and must name declared options only; ``supports(spec)``
    returns None or the reason the engine cannot run ``spec``;
    ``traceback=False`` marks a score-only engine; ``fill`` names what a
    plan of the engine runs (a string, or ``fill(options)`` of a plan's
    resolved options; default the engine's name)."""
    if (fn is None) == (loader is None):
        raise ValueError("pass exactly one of fn= or loader=")
    opts = dict(options or {})
    tunable = {k: tuple(v) for k, v in dict(tunable or {}).items()}
    bad = sorted(set(tunable) - set(opts))
    if bad:
        raise ValueError(
            f"engine {name!r}: tunable option(s) {bad} not declared in "
            f"options={sorted(opts)}")
    with _LOCK:
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"engine {name!r} already registered")
        _REGISTRY[name] = _Entry(name=name, fn=fn, loader=loader,
                                 options=opts, tunable=tunable,
                                 fill=fill or name, supports=supports,
                                 traceback=traceback)


def unregister_engine(name: str) -> None:
    """Remove a registration (test fixtures that seed a defect for the plan
    linter; nothing else unregisters)."""
    with _LOCK:
        _REGISTRY.pop(name, None)


def get_engine(name: str) -> Callable:
    """Resolve an engine by name, materializing deferred loaders once."""
    entry = _REGISTRY.get(name)
    if entry is None:
        raise ValueError(
            f"unknown engine {name!r}; have {available_engines()}")
    if entry.fn is None:
        with _LOCK:
            if entry.fn is None:
                entry.fn = entry.loader()
    return entry.fn


def available_engines() -> list[str]:
    return sorted(_REGISTRY)


def engine_options(name: str) -> dict[str, object]:
    entry = _REGISTRY.get(name)
    return dict(entry.options) if entry else {}


def engine_tunable(name: str) -> dict[str, tuple]:
    """Candidate values per tunable option of engine ``name`` (``{}`` when
    it has nothing to tune)."""
    entry = _REGISTRY.get(name)
    return dict(entry.tunable) if entry else {}


def engine_fill(name: str, options: Optional[Mapping] = None) -> str:
    """What a plan of engine ``name`` with these resolved options runs
    (``plan_cache_info`` reports it beside each plan)."""
    entry = _REGISTRY.get(name)
    if entry is None:
        return f"unknown engine {name!r}"
    fill = entry.fill
    return fill(dict(options or {})) if callable(fill) else str(fill)


def engine_supports(name: str, spec) -> Optional[str]:
    """Why engine ``name`` cannot run ``spec`` — None when it can."""
    entry = _REGISTRY.get(name)
    if entry is None:
        return f"unknown engine {name!r}"
    if entry.supports is None:
        return None
    return entry.supports(spec)


def engine_traceback(name: str) -> bool:
    """True when engine ``name`` emits a pointer store to walk."""
    entry = _REGISTRY.get(name)
    return bool(entry.traceback) if entry else False


def _load_reference():
    from repro_torch.core import reference
    return reference.run


# the row-major oracle (the paper's C-simulation analogue)
register_engine("reference", loader=_load_reference, fill="eager torch")


K1_FILL = "K1"
ENGINE_FILL = "eager torch (core.engine)"


def wavefront_fill_route(options: Mapping) -> str:
    """The fill a ``wavefront`` plan runs: ``K1_FILL`` unless ``xdrop`` is
    set, ``ENGINE_FILL`` (``core.engine.run``) when it is.  The one place
    that chooses; K1 cannot prune by X-drop across its pipelined strips."""
    return K1_FILL if options.get("xdrop") is None else ENGINE_FILL


def _wavefront(spec, params, queries, refs, q_lens=None, r_lens=None, *,
               with_tb: bool = True, strip=None, tb_pack=None,
               live_bound=None, xdrop=None, strip_warps=None):
    if wavefront_fill_route({"xdrop": xdrop}) == K1_FILL:
        from repro_torch.kernels.wavefront import ops
        return ops.run(spec, params, queries, refs, q_lens, r_lens,
                       tb_pack=tb_pack, strip_warps=strip_warps,
                       with_tb=with_tb)
    from repro_torch.core import engine
    return engine.run(spec, params, queries, refs, q_lens, r_lens,
                      strip=strip, tb_pack=tb_pack, live_bound=live_bound,
                      xdrop=xdrop, with_tb=with_tb)


def _wavefront_supports(spec) -> Optional[str]:
    from repro_torch.kernels.wavefront import kernel
    return kernel.supports(spec)


# the per-device strip default lives with the engine (one copy); importing
# it imports no kernel
from repro_torch.core.engine import STRIP_DEFAULTS  # noqa: E402

# the anti-diagonal fill (paper §5.1/§5.2): K1, or the eager engine under
# X-drop.  strip: per-device dict resolved at plan time; live_bound: the
# batch's shared fill bound, passed by the plan at dispatch; xdrop changes
# results and is never tunable; strip_warps: K1's warps per pair (None =
# its heuristic).
register_engine("wavefront", fn=_wavefront,
                options={"strip": STRIP_DEFAULTS, "tb_pack": None,
                         "live_bound": "dynamic", "xdrop": None,
                         "strip_warps": None},
                tunable={"tb_pack": (1, 2, 4, 8),
                         "strip_warps": (1, 2, 4, 8)},
                supports=_wavefront_supports, fill=wavefront_fill_route)


def _load_myers():
    from repro_torch.kernels.myers import ops
    return ops.run


def _myers_supports(spec) -> Optional[str]:
    from repro_torch.core import myers
    return myers.supports(spec)


# K2: CUDA bit-vector edit distance (Myers 1999), kernels #16/#17 only
register_engine("myers", loader=_load_myers, supports=_myers_supports,
                traceback=False, fill="K2")


def _load_banded():
    from repro_torch.core import banded
    return banded.run


def _banded_supports(spec) -> Optional[str]:
    if spec.band is None:
        return "banded engine requires spec.band (fixed banding width)"
    return None


# O(n*W) band-packed lanes, score-only (no kernel: JAX runs it in XLA)
register_engine("banded", loader=_load_banded, options={"xdrop": None},
                supports=_banded_supports, traceback=False,
                fill="eager torch (core.banded)")
