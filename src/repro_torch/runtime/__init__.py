"""Engine registry, length bucketing, plan cache and batch dispatch of the
port (counterpart of ``repro.runtime``).

Every public name of ``repro.runtime`` that the port has is here.  Two
have no counterpart, because they exist only for XLA: ``align_impl``, the
traceable fill + traceback that JAX's plans jit and that callers inside a
trace inline (eager torch has no trace to inline into; a plan's
``CompiledPlan.__call__`` is the execution core), and ``lower_plan_hlo``,
a plan's lowered HLO text (the port compiles no HLO; its kernels' work is
counted by ``launch/hlo_cost.py``).
"""
from .registry import (Engine, available_engines, engine_options,
                       engine_tunable, get_engine, register_engine)
from .plan import (CompiledPlan, clear_plan_cache, get_plan,
                   plan_cache_info, resolve_engine_options,
                   traceback_bytes, validate_int_option,
                   validate_pow2_option)
from .bucketing import (Bucket, bucket_length, bucket_shape,
                        inverse_permutation, max_grid_bucket,
                        pack_by_bucket, pad_to_bucket)
from .dispatch import run_pairs, run_pipelined

# names of ``repro.runtime`` with no counterpart here (see the docstring)
JAX_ONLY = ("align_impl", "lower_plan_hlo")

__all__ = [
    "Engine", "available_engines", "engine_options", "engine_tunable",
    "get_engine", "register_engine",
    "CompiledPlan", "clear_plan_cache", "get_plan",
    "plan_cache_info", "resolve_engine_options",
    "traceback_bytes", "validate_int_option", "validate_pow2_option",
    "Bucket", "bucket_length", "bucket_shape", "inverse_permutation",
    "max_grid_bucket", "pack_by_bucket", "pad_to_bucket",
    "run_pairs", "run_pipelined",
]
