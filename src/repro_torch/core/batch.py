"""Outer-loop parallelism of the port (counterpart of ``repro.core.batch``),
the paper's N_B / N_K: ``align_batch`` runs one kernel over many sequence
pairs in one launch (N_B blocks on one device); ``make_sharded_aligner``
splits the batch over a mesh axis (N_K independent channels, one a rank),
through a sharded plan of the shared cache."""
from __future__ import annotations

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import plan as plan_mod

from . import types as T
from .api import as_codes


def _align(spec, params, queries, refs, q_lens, r_lens, engine_name,
           device, **plan_kw):
    """The batch entry's body: the codes' copy to ``device``, the plan and
    its call, under the ``batch.align`` span (its copy under
    ``batch.h2d``)."""
    with obs_trace.span("batch.align", cat="batch") as sp:
        dev = plan_mod.resolve_device(device)
        with obs_trace.span("batch.h2d", cat="batch"):
            queries = as_codes(queries, spec.char_dtype, dev)
            refs = as_codes(refs, spec.char_dtype, dev)
        n = queries.shape[0]
        sp.set(n=n, bucket=(queries.shape[1], refs.shape[1]))
        if q_lens is None:
            q_lens = np.full((n,), queries.shape[1], np.int32)
        if r_lens is None:
            r_lens = np.full((n,), refs.shape[1], np.int32)
        plan = plan_mod.get_plan(spec, engine_name, tuple(queries.shape[1:]),
                                 tuple(refs.shape[1:]), batch_size=n,
                                 device=dev, **plan_kw)
        return plan(params, queries, refs, q_lens, r_lens)


def align_batch(spec: T.DPKernelSpec, params, queries, refs,
                q_lens=None, r_lens=None, engine_name: str = "wavefront",
                with_traceback: bool = True, strip=None, tb_pack=None,
                device="cuda"):
    """Align a batch.  queries: (N, Lq), refs: (N, Lr); q_lens/r_lens: (N,)
    effective lengths (None = full).  ``strip``/``tb_pack`` select the
    engine schedule (None = the tuned or hand-picked defaults), as in
    ``get_plan``.  Lengths given on the host keep the traceback bound free
    of a device synchronisation."""
    return _align(spec, params, queries, refs, q_lens, r_lens, engine_name,
                  device, with_traceback=with_traceback, strip=strip,
                  tb_pack=tb_pack)


def make_sharded_aligner(spec: T.DPKernelSpec, mesh, axis: str = "data",
                         engine_name: str = "wavefront",
                         with_traceback: bool = True, device=None):
    """An aligner whose batch is split over ``axis`` of ``mesh`` (a
    ``DeviceMesh``): every rank of the axis calls it with the whole batch,
    which must divide the axis size, runs its own contiguous rows (K1 on
    the card) and gets every row's results.  The plan comes from the
    shared cache, keyed by the mesh (``PlanKey.placement``), so
    ``plan_cache_info`` sees every sharded shape.  ``device`` defaults to
    the mesh's device type."""
    dev = plan_mod.resolve_device(device or mesh.device_type)

    def aligner(params, queries, refs, q_lens=None, r_lens=None):
        return _align(spec, params, queries, refs, q_lens, r_lens,
                      engine_name, dev, with_traceback=with_traceback,
                      mesh=mesh, mesh_axis=axis)

    return aligner
