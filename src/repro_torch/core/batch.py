"""Outer-loop parallelism of the port (counterpart of ``repro.core.batch``):
one kernel over many sequence pairs in one launch.  The sharded aligner
comes with the multi-GPU item of the ROADMAP."""
from __future__ import annotations

import numpy as np

from repro_torch.runtime import plan as plan_mod

from . import types as T
from .api import as_codes


def align_batch(spec: T.DPKernelSpec, params, queries, refs,
                q_lens=None, r_lens=None, engine_name: str = "wavefront",
                with_traceback: bool = True, strip=None, tb_pack=None,
                device="cuda"):
    """Align a batch.  queries: (N, Lq), refs: (N, Lr); q_lens/r_lens: (N,)
    effective lengths (None = full).  ``strip``/``tb_pack`` select the
    engine schedule (None = the tuned or hand-picked defaults), as in
    ``get_plan``.  Lengths given on the host keep the traceback bound free
    of a device synchronisation."""
    dev = plan_mod.resolve_device(device)
    queries = as_codes(queries, spec.char_dtype, dev)
    refs = as_codes(refs, spec.char_dtype, dev)
    n = queries.shape[0]
    if q_lens is None:
        q_lens = np.full((n,), queries.shape[1], np.int32)
    if r_lens is None:
        r_lens = np.full((n,), refs.shape[1], np.int32)
    plan = plan_mod.get_plan(spec, engine_name, tuple(queries.shape[1:]),
                             tuple(refs.shape[1:]), batch_size=n,
                             with_traceback=with_traceback, strip=strip,
                             tb_pack=tb_pack, device=dev)
    return plan(params, queries, refs, q_lens, r_lens)
