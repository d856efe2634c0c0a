"""GPipe-style pipeline parallelism over a 'pipe' mesh axis (port of
``repro/sharding/pipeline.py``).

Stage s holds layer-slice s of the stacked params; microbatches march
through the stages with one point-to-point exchange per tick (each stage
sends its output to the next, ``dist.batch_isend_irecv`` on the axis's
sub-group), the systolic fill-and-drain schedule of JAX's shard_map with
``ppermute``.  Fill and drain leave M / (M + P - 1) of the ticks busy;
the outputs are collected on the last stage and broadcast over the axis.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map


def _stage_slice(t, mesh, axis: str, sid: int):
    """This stage's params: a DTensor split on dim 0 over ``axis`` gives
    its local block, a whole tensor its row ``sid``."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[sid]


def pipeline_apply(mesh, axis: str, stage_fn: Callable, stage_params,
                   microbatches):
    """stage_params: a tree whose leaves are (P_stages, ...), whole on
    every rank or DTensors split on dim 0 over ``axis``; microbatches:
    (M, mb, ...), the same on every rank of ``axis``.  Returns the
    (M, mb, ...) outputs of the final stage, on every rank."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    xs = microbatches
    M = xs.shape[0]
    params_one = tree_map(lambda t: _stage_slice(t, mesh, axis, sid),
                          stage_params)
    nxt = (dist.get_global_rank(group, sid + 1)
           if sid < n_stages - 1 else None)
    prv = dist.get_global_rank(group, sid - 1) if sid > 0 else None
    carry = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(M + n_stages - 1):
        inp = xs[min(t, M - 1)] if sid == 0 else carry
        y = stage_fn(params_one, inp).contiguous()
        m_out = t - (n_stages - 1)        # the last stage commits
        if sid == n_stages - 1 and 0 <= m_out < M:
            outs[m_out] = y
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y, nxt, group))
        if prv is not None:
            carry = torch.empty_like(y)
            ops.append(dist.P2POp(dist.irecv, carry, prv, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
    dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return outs


def sequential_reference(stage_fn, stage_params, microbatches, n_stages):
    """Oracle: apply the stages in order to each microbatch, no
    pipelining."""
    def one(x):
        for s in range(n_stages):
            x = stage_fn(tree_map(lambda t: t[s], stage_params), x)
        return x
    return torch.stack([one(x) for x in microbatches])
