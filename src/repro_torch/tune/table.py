"""The port's tuning table: sweep winners keyed by deployment point
(counterpart of ``repro.tune.table``).

One JSON file maps ``(kernel, engine, bucket, batch, device name, torch
version)`` to the schedule options (``tb_pack``, ``strip_warps``) a measured
sweep picked.  Staleness is structural: the device name
(``torch.cuda.get_device_name`` for a CUDA device, ``"cpu"`` on the CPU) and
``torch.__version__`` are part of the key, so an entry recorded on another
card or against another torch never matches, and a miss falls back to the
hand-picked defaults.  A ``schema`` field guards the file format.

``runtime.plan.get_plan`` consults :func:`lookup` when the caller passed no
explicit schedule option.  Resolution order:

1. env ``REPRO_TORCH_TUNE_TABLE=off|0|none|disabled|false`` — no table, the
   hand-picked defaults apply exactly (wins over :func:`set_table` too);
2. a table installed with :func:`set_table`;
3. env ``REPRO_TORCH_TUNE_TABLE=<path>``;
4. ``TUNE_TABLE_TORCH.json`` at the repository root, if present.

The JAX package's ``TUNE_TABLE.json`` and ``REPRO_TUNE_TABLE`` are never
read.  Any load problem (missing file, corrupt JSON, wrong schema) resolves
to no table.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import threading
from typing import Optional

import torch

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNE_TABLE"
DEFAULT_TABLE_NAME = "TUNE_TABLE_TORCH.json"
_OFF_VALUES = {"off", "0", "none", "disabled", "false"}


def device_label(device="cuda") -> str:
    """The name a table entry records for ``device``: the card's name for a
    CUDA device, ``"cpu"`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def entry_key(kernel: str, engine: str, bucket: tuple,
              batch_size: Optional[int], *, device="cuda",
              device_name: Optional[str] = None,
              torch_version: Optional[str] = None) -> str:
    """Canonical key of one tuning point.  ``bucket`` is the per-pair
    ``(Q, R)``; the device name (from ``device`` unless ``device_name`` is
    given) and torch version default to the running process's."""
    name = device_name or device_label(device)
    version = torch_version or torch.__version__
    b = "single" if batch_size is None else f"b{int(batch_size)}"
    return "|".join([kernel, engine, f"{int(bucket[0])}x{int(bucket[1])}",
                     b, name, version])


@dataclasses.dataclass
class TuningTable:
    """In-memory view of one table file (see the module docstring)."""
    entries: dict = dataclasses.field(default_factory=dict)
    schema: int = SCHEMA_VERSION
    created: Optional[str] = None
    path: Optional[str] = None

    @classmethod
    def load(cls, path) -> "TuningTable":
        """Load a table file; raises on an unreadable file or a foreign
        schema (:func:`lookup` treats either as no table)."""
        path = str(path)
        with open(path) as f:
            raw = json.load(f)
        schema = raw.get("schema")
        if schema != SCHEMA_VERSION:
            raise ValueError(
                f"tuning table {path}: schema {schema!r} != "
                f"{SCHEMA_VERSION} (stale file; re-run python -m "
                f"repro_torch.tune)")
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            raise ValueError(f"tuning table {path}: no entries mapping")
        return cls(entries=dict(entries), schema=schema,
                   created=raw.get("created"), path=path)

    def save(self, path=None) -> str:
        path = str(path or self.path)
        if not path or path == "None":
            raise ValueError("TuningTable.save: no path")
        payload = {"schema": self.schema, "created": self.created,
                   "entries": self.entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self.path = path
        return path

    def record(self, kernel: str, engine: str, bucket: tuple,
               batch_size: Optional[int], options: dict, *, device="cuda",
               **meta) -> str:
        """Store a sweep winner for ``device``; ``meta`` (measured times,
        speedup, ...) rides along for reports and is never read at
        dispatch."""
        key = entry_key(kernel, engine, bucket, batch_size, device=device)
        self.entries[key] = {"options": dict(options), **meta}
        return key

    def lookup_options(self, kernel: str, engine: str, bucket: tuple,
                       batch_size: Optional[int], *,
                       device="cuda") -> Optional[dict]:
        ent = self.entries.get(entry_key(kernel, engine, bucket, batch_size,
                                         device=device))
        if not isinstance(ent, dict):
            return None
        opts = ent.get("options")
        return dict(opts) if isinstance(opts, dict) else None

    def __len__(self) -> int:
        return len(self.entries)


# ---------------------------------------------------------------------------
# The process-wide active table (what get_plan consults).
# ---------------------------------------------------------------------------
_LOCK = threading.Lock()
_OVERRIDE: Optional[TuningTable] = None       # set_table(TuningTable)
_OVERRIDE_PATH: Optional[str] = None          # set_table("path")
_CACHED: Optional[tuple] = None               # (path, mtime, table|None)


def default_path() -> pathlib.Path:
    """``TUNE_TABLE_TORCH.json`` at the repository root (three levels above
    this package: src/repro_torch/tune -> repo)."""
    return pathlib.Path(__file__).resolve().parents[3] / DEFAULT_TABLE_NAME


def set_table(table=None) -> None:
    """Install the active table: a :class:`TuningTable`, a path, or None to
    restore discovery by env and default file.  ``off`` in the env still
    wins."""
    global _OVERRIDE, _OVERRIDE_PATH, _CACHED
    with _LOCK:
        _CACHED = None
        if table is None:
            _OVERRIDE = _OVERRIDE_PATH = None
        elif isinstance(table, TuningTable):
            _OVERRIDE, _OVERRIDE_PATH = table, None
        else:
            _OVERRIDE, _OVERRIDE_PATH = None, str(table)


def _load_cached(path: str) -> Optional[TuningTable]:
    """One cached table, revalidated by mtime, so lookups on the dispatch
    path do not re-read the file."""
    global _CACHED
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    with _LOCK:
        if _CACHED is not None and _CACHED[0] == path \
                and _CACHED[1] == mtime:
            return _CACHED[2]
    try:
        table = TuningTable.load(path)
    except Exception:
        table = None
    with _LOCK:
        _CACHED = (path, mtime, table)
    return table


def active_table() -> Optional[TuningTable]:
    """The table :func:`lookup` consults, or None (disabled or absent)."""
    env = os.environ.get(ENV_VAR)
    if env is not None and env.strip().lower() in _OFF_VALUES:
        return None
    if _OVERRIDE is not None:
        return _OVERRIDE
    if _OVERRIDE_PATH is not None:
        return _load_cached(_OVERRIDE_PATH)
    if env:
        return _load_cached(env)
    p = default_path()
    return _load_cached(str(p)) if p.is_file() else None


def lookup(kernel: str, engine: str, bucket: tuple,
           batch_size: Optional[int], *, device="cuda") -> Optional[dict]:
    """Winning options for one point on ``device``, or None."""
    table = active_table()
    if table is None:
        return None
    return table.lookup_options(kernel, engine, bucket, batch_size,
                                device=device)
