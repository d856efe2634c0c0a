"""Wrapper around K1 (port of ``repro/kernels/wavefront/ops.py``): pads the
query to the lane strip, builds the masked boundary row and column
(``core/reference.py::boundaries``), launches
the fill, and reduces across strips to the ``DPResult`` the engines return.
The three steps run under the ``k1.prep``, ``k1.launch`` and ``k1.fold``
spans (``repro_torch.obs.trace``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import types as T
from repro_torch.core.reference import boundaries
from repro_torch.core.spec_utils import batch_lens, resolve_tb_pack
from repro_torch.obs import trace as obs_trace
from . import kernel as K


def run(spec: T.DPKernelSpec, params, queries, refs, q_lens=None,
        r_lens=None, *, tb_pack: Optional[int] = None,
        strip_warps: Optional[int] = None,
        with_tb: bool = True) -> T.DPResult:
    """Fill a batch: queries (B, Q) + char_shape, refs (B, R) + char_shape
    of the spec's char dtype, on one device; q_lens/r_lens (B,) effective
    lengths (None = full); ``strip_warps`` is K1's warps per pair (None =
    its heuristic).

    The end cell is the first optimum in (strip, lane) order — row-major
    first, the same cell as ``core/reference.py`` picks — with each lane's
    first column; it is (0, 0) when the score is the sentinel (no live
    cell in the objective region), as the reference reports it.  Under a
    sum semiring the score is the ⊕-fold of the lanes' region mass and the
    end cell is (0, 0)."""
    with obs_trace.span("k1.prep", cat="k1"):
        B, Q = queries.shape[:2]
        R = refs.shape[1]
        dev = queries.device
        pack = resolve_tb_pack(spec, tb_pack)
        q_lens = batch_lens(Q if q_lens is None else q_lens, B, dev)
        r_lens = batch_lens(R if r_lens is None else r_lens, B, dev)
        pad = (-Q) % K.N_PE
        if pad:
            queries = torch.cat([queries, queries.new_zeros(
                (B, pad) + tuple(queries.shape[2:]))], dim=1)
        init_row, init_col = boundaries(spec, params, Q + pad, R, q_lens,
                                        r_lens)
        lens = torch.stack([q_lens, r_lens], dim=1).contiguous()
    with obs_trace.span("k1.launch", cat="k1"):
        tb, best, best_j = K.wavefront_fill(
            spec, params, queries.contiguous(), refs.contiguous(), init_row,
            init_col, lens, tb_pack=pack, with_tb=with_tb, warps=strip_warps)
    with obs_trace.span("k1.fold", cat="k1"):
        flat = best.reshape(B, -1)
        layout = ("chunk", K.N_PE) if pack == 1 else ("chunk", K.N_PE, pack)
        zero = torch.zeros((B,), dtype=torch.int32, device=dev)
        if spec.is_sum:
            return T.DPResult(score=spec.reduce_best(flat, axis=1),
                              end_i=zero, end_j=zero, tb=tb,
                              tb_layout=layout)
        k = spec.arg_best(flat, axis=1)[:, None]        # first optimum
        score = flat.gather(1, k)[:, 0]
        live = score != spec.sentinel()
        end_i = torch.where(live, (k[:, 0] + 1).to(torch.int32), zero)
        end_j = torch.where(live, best_j.reshape(B, -1).gather(1, k)[:, 0],
                            zero)
        return T.DPResult(score=score, end_i=end_i, end_j=end_j, tb=tb,
                          tb_layout=layout)
