"""GACT-style tiled long alignment (counterpart of ``repro.core.tiling``;
paper claim 5, §6.2 tiling heuristic).

Long alignments (10 kb to 1 Mb reads) do not fit one DP pass; GACT
[Darwin, ASPLOS'18] tiles the DP matrix with T x T tiles and an O-cell
overlap: each tile is aligned with traceback from the best far-boundary
cell, the path is committed only up to the overlap margin, and the next
tile starts at the committed endpoint.  This is the host driver over the
fixed-shape plans of ``runtime.plan``: on the card every tile is one K1
launch and one walk.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime import plan as plan_mod

from . import types as T
from .traceback import path_cells


@dataclasses.dataclass
class TiledAlignment:
    moves: np.ndarray     # start->end move codes over the whole alignment
    n_tiles: int
    end_i: int
    end_j: int


def tiled_align(spec: T.DPKernelSpec, params, query, ref, tile: int = 128,
                overlap: int = 32, engine_name: str = "wavefront",
                device="cuda") -> TiledAlignment:
    """Drive fixed-size tile alignments across a long (query, ref) pair on
    ``device``.

    ``spec`` must be a global-style kernel with traceback (e.g. #2).  Two
    plans are used: interior tiles trace back from the best far-boundary
    cell (overlap region), the final tile from the corner.  Both come from
    the shared plan cache.
    """
    assert spec.traceback is not None and spec.region == T.REGION_CORNER
    interior_spec = dataclasses.replace(
        spec, region=T.REGION_LAST_ROW_COL,
        traceback=dataclasses.replace(spec.traceback, stop=T.STOP_ORIGIN))
    dev = plan_mod.resolve_device(device)

    query = np.asarray(query)
    ref = np.asarray(ref)
    q_shape = (tile,) + query.shape[1:]
    r_shape = (tile,) + ref.shape[1:]
    tile_interior = plan_mod.get_plan(interior_spec, engine_name,
                                      q_shape, r_shape, device=dev)
    tile_final = plan_mod.get_plan(spec, engine_name, q_shape, r_shape,
                                   device=dev)
    Q, R = len(query), len(ref)
    qi = rj = 0
    all_moves: list[int] = []
    n_tiles = 0
    pad_q = np.zeros((tile,) + query.shape[1:], query.dtype)
    pad_r = np.zeros((tile,) + ref.shape[1:], ref.dtype)

    while qi < Q or rj < R:
        if qi >= Q:   # only reference remains: trailing insertions
            all_moves.extend([T.MOVE_LEFT] * (R - rj))
            rj = R
            break
        if rj >= R:   # only query remains: trailing deletions
            all_moves.extend([T.MOVE_UP] * (Q - qi))
            qi = Q
            break
        n_tiles += 1
        ql = min(tile, Q - qi)
        rl = min(tile, R - rj)
        q_t, r_t = pad_q.copy(), pad_r.copy()
        q_t[:ql] = query[qi:qi + ql]
        r_t[:rl] = ref[rj:rj + rl]
        last = (qi + ql >= Q) and (rj + rl >= R)
        fn = tile_final if last else tile_interior
        a = fn(params, torch.as_tensor(q_t, device=dev),
               torch.as_tensor(r_t, device=dev), ql, rl)
        cells = path_cells(a)                      # start->end cells
        n = int(a.n_moves)
        moves = [int(m) for m in a.moves[:n].cpu().numpy()][::-1]
        assert int(a.start_i) == 0 and int(a.start_j) == 0, (
            "tile path must reach the committed origin; increase tile size")
        if last:
            commit = len(moves)
        else:
            # commit the path prefix ending at the last cell inside the
            # overlap margin
            commit = 0
            for k, (ci, cj) in enumerate(cells):
                if ci <= ql - (overlap if ql == tile else 0) and \
                   cj <= rl - (overlap if rl == tile else 0):
                    commit = k
            if commit == 0:
                raise RuntimeError(
                    "tile did not advance; tile/overlap too small")
        all_moves.extend(moves[:commit])
        ci, cj = cells[commit]
        qi += ci
        rj += cj
        if last:
            break
    return TiledAlignment(moves=np.asarray(all_moves, np.uint8),
                          n_tiles=n_tiles, end_i=qi, end_j=rj)
