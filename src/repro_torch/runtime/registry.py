"""Engine registry of the port (counterpart of ``repro.runtime.registry``).

An engine is a matrix-fill back-end ``fn(spec, params, queries, refs,
q_lens, r_lens, *, with_tb, **options) -> DPResult`` over a batch of padded
pairs (the batch axis is written out where JAX vmaps a per-pair engine);
``with_tb=False`` lets it skip the pointer store.  Built-ins
register with a deferred loader, so importing this module imports no engine.

Registered: ``reference`` — the full-matrix oracle (``core.reference``),
eager torch on the inputs' device, every spec, with the (Q+1, R+1, L) matrix
and the ``'row'`` pointer store; ``wavefront`` — kernel K1 (CUDA on CUDA
tensors, its plain version on CPU tensors), with the ``tb_pack`` option;
``myers`` — kernel K2, the bit-vector unit-cost engine for #16/#17
(score-only, no options), the same way.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Mapping, Optional


@dataclasses.dataclass
class _Entry:
    name: str
    fn: Optional[Callable] = None        # resolved engine
    loader: Optional[Callable] = None    # deferred constructor
    options: Mapping[str, object] = dataclasses.field(default_factory=dict)
    # supports(spec) -> None (accepted) | str (why the engine cannot run it)
    supports: Optional[Callable] = None


_REGISTRY: dict[str, _Entry] = {}
_LOCK = threading.Lock()


def register_engine(name: str, fn: Optional[Callable] = None, *,
                    loader: Optional[Callable] = None,
                    options: Optional[Mapping[str, object]] = None,
                    supports: Optional[Callable] = None) -> None:
    """Register engine ``name`` eagerly (``fn``) or deferred
    (``loader() -> fn``, resolved on first :func:`get_engine`).

    ``options`` maps the keyword knobs the engine accepts to their defaults
    (``None`` = resolved from the kernel spec at plan time);
    ``supports(spec)`` returns None or the reason the engine cannot run
    ``spec``."""
    if (fn is None) == (loader is None):
        raise ValueError("pass exactly one of fn= or loader=")
    with _LOCK:
        if name in _REGISTRY:
            raise ValueError(f"engine {name!r} already registered")
        _REGISTRY[name] = _Entry(name=name, fn=fn, loader=loader,
                                 options=dict(options or {}),
                                 supports=supports)


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


def engine_supports(name: str, spec) -> Optional[str]:
    """Why engine ``name`` cannot run ``spec`` — None when it can."""
    entry = _REGISTRY.get(name)
    if entry is None:
        return f"unknown engine {name!r}"
    if entry.supports is None:
        return None
    return entry.supports(spec)


def _load_reference():
    from repro_torch.core import reference
    return reference.run


# the row-major oracle (the paper's C-simulation analogue)
register_engine("reference", loader=_load_reference)


def _load_wavefront():
    from repro_torch.kernels.wavefront import ops
    return ops.run


def _wavefront_supports(spec) -> Optional[str]:
    from repro_torch.kernels.wavefront import kernel
    return kernel.supports(spec)


# K1: CUDA anti-diagonal fill kernel (paper §5.1/§5.2)
register_engine("wavefront", loader=_load_wavefront,
                options={"tb_pack": None}, supports=_wavefront_supports)


def _load_myers():
    from repro_torch.kernels.myers import ops
    return ops.run


def _myers_supports(spec) -> Optional[str]:
    from repro_torch.core import myers
    return myers.supports(spec)


# K2: CUDA bit-vector edit distance (Myers 1999), kernels #16/#17 only
register_engine("myers", loader=_load_myers, supports=_myers_supports)
