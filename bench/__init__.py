"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix, entry or per-layer metric lives
in a file of its own and is found by the name ``BENCHMARK.json`` or a data
file gives it:

* ``configs/<config>.json``: the DP kernel, its parameters, the adapter
  that builds the program's spec (``programs/<adapter>.py``), the plain
  reference (``reference/<reference>.py``), the limits of the check, the
  frozen work floor of ``floor.py`` and the host process's settings;
* ``traffic/<traffic>.json``: the parameters of a mix, its ``kind`` (the
  generator ``traffic_kinds/<kind>.py``) and its ``entry`` (the program's
  call the window drives, ``entries/<entry>.py``);
* ``metrics/<metric>.py``: a ``read(run)`` that returns the metric or
  None where the run has nothing to read.

Nothing here imports the JAX package ``repro`` or JAX.
"""
import importlib.util
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def load_module(kind: str, name: str, bench_dir: Path = BENCH):
    """``bench/<kind>/<name>.py``, loaded from its path (a metric's name
    may hold dots)."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.is_file():
        known = sorted(p.stem for p in path.parent.glob("*.py"))
        raise ValueError(f"no {kind} {name!r}; known: {known}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
