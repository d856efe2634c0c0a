"""The port's plan autotuner (counterpart of ``repro.tune``): design-space
search over K1's result-preserving launch knobs, persisted winners, and warm
boot.

* ``space``  — the legal option grid, derived from the engine registry
  (``tb_pack`` x ``strip_warps`` for ``wavefront``);
* ``cost``   — rank candidates by an analytic H100 model before any launch,
  pruning the space to a top-K (the default always survives);
* ``search`` — time the survivors through the real plan cache, each held
  bit-equal to the default plan first;
* ``table``  — persist winners in ``TUNE_TABLE_TORCH.json``, keyed by
  (kernel, engine, bucket, batch, device name, torch version); ``get_plan``
  consults it for defaults, ``REPRO_TORCH_TUNE_TABLE=off`` disables it;
* ``warm``   — dispatch a service's channel grid once at boot.

``python -m repro_torch.tune`` runs a sweep and writes a table.
"""
from .space import (default_options, enumerate_space, grid_findings,
                    tunable_names)
from .cost import device_model, k1_bytes, point_cells, predict, rank
from .search import assert_parity, make_batch, run_sweep, tune_point
from .table import (ENV_VAR, SCHEMA_VERSION, TuningTable, active_table,
                    default_path, entry_key, lookup, set_table)
from .warm import warm_grid, warm_plan

__all__ = [
    "default_options", "enumerate_space", "grid_findings", "tunable_names",
    "device_model", "k1_bytes", "point_cells", "predict", "rank",
    "assert_parity", "make_batch", "run_sweep", "tune_point",
    "ENV_VAR", "SCHEMA_VERSION", "TuningTable", "active_table",
    "default_path", "entry_key", "lookup", "set_table",
    "warm_grid", "warm_plan",
]
