"""Build the port's CUDA kernels at first use.

Each kernel source under ``kernels/*/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  Libraries go to ``build/repro_torch/`` at the repository root
(git-ignored), named by a hash of the source, the headers beside it
(``*.cuh``) and the flags, so an edited source or header rebuilds and an
unchanged one loads at once.  Two sources build
concurrently when called from two threads (one lock per library).  A
generated source (K1's PE functors, ``kernels/wavefront/synth.py``) lives
under ``build/repro_torch/gen/`` and names the directory of the headers it
includes (``include_dirs``), whose ``*.cuh`` join its hash.  Importing
this module builds nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR.parent.parent / "build" / "repro_torch"


@dataclasses.dataclass
class Built:
    """A loaded kernel library and what its build reported."""
    lib: ctypes.CDLL
    path: Path
    ptxas_log: str       # nvcc's -Xptxas -v report (kept beside the library)
    seconds: float       # build wall time (0.0 when loaded from cache)


_LOADED: dict[str, Built] = {}
_LOCKS: dict[str, threading.Lock] = {}
_LOCK = threading.Lock()
_THREAD = threading.local()     # seconds this thread has spent in load()


def thread_load_seconds() -> float:
    """Wall seconds the calling thread has spent in :func:`load` (builds,
    loads and waits on another thread's build of the same library)."""
    return getattr(_THREAD, "seconds", 0.0)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(source: Path, include_dirs=()) -> str:
    h = hashlib.sha256(source.read_bytes())
    for d in (source.parent, *map(Path, include_dirs)):
        for header in sorted(d.glob("*.cuh")):
            h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _key(source: Path, include_dirs=()) -> str:
    return f"{source.stem}_{_digest(source, include_dirs)}"


def kept_report(source, include_dirs=()) -> str | None:
    """The ``-Xptxas -v`` report a build of ``source`` (as it is now) kept
    beside its library, or None when it has not been built here."""
    source = Path(source)
    if not source.exists():
        return None
    report = BUILD_DIR / f"{_key(source, include_dirs)}.ptxas.txt"
    return report.read_text() if report.exists() else None


def ptxas_entries(log: str) -> list:
    """``(mangled entry name, registers, spill bytes, stack frame bytes)``
    for each entry function of an ``nvcc -Xptxas -v`` log."""
    rows, cur, spill, stack = [], None, 0, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill, stack = m.group(1), 0, 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack = int(m.group(1))
            spill = int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rows.append((cur, int(m.group(1)), spill, stack))
            cur = None
    return rows


def load(source: Path, include_dirs=()) -> Built:
    """Compile ``source`` (once per content hash) and load it;
    ``include_dirs`` go to nvcc as ``-I``."""
    t0 = time.perf_counter()
    try:
        return _load(Path(source), include_dirs)
    finally:
        _THREAD.seconds = thread_load_seconds() + time.perf_counter() - t0


def _load(source: Path, include_dirs) -> Built:
    key = _key(source, include_dirs)
    with _LOCK:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        built = _LOADED.get(key)
        if built is not None:
            return built
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"{key}.so"
        report = out.with_suffix(".ptxas.txt")
        log, seconds = "", 0.0
        if out.exists() and report.exists():
            log = report.read_text()
        else:
            tmp = BUILD_DIR / f"{key}.{os.getpid()}.tmp.so"
            cmd = [nvcc_path(), *NVCC_FLAGS,
                   *(f"-I{d}" for d in include_dirs), "-o", str(tmp),
                   str(source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {source.name} (exit {proc.returncode}):"
                    f"\n{log}")
            report.write_text(log)
            os.replace(tmp, out)   # atomic: concurrent builders never see
            #                        a half-written library
        built = Built(lib=ctypes.CDLL(str(out)), path=out, ptxas_log=log,
                      seconds=seconds)
        _LOADED[key] = built
        return built
