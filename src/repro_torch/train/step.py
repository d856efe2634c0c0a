"""Train-step factory (port of ``repro/train/step.py``): loss -> grads (with
microbatch accumulation) -> optional EF-int8 compression -> AdamW.

A train state is a dict: ``params`` (the model's tree), ``opt`` (AdamW's
``{"mu", "count"}``), ``step`` (an int32 0-dim tensor) and, with error
feedback, ``ef``.  ``step_fn(state, batch)`` updates it in place (AdamW
writes into the parameters and moments; see ``optim/adamw.py``) and returns
it with the step's metrics.

On a mesh the state's leaves are DTensors placed by
``ShardCtx(mesh, rules).tree(abstract_state(...), state_logical(...))``
(``make_state(shardings=)`` for a fresh state, ``shard_state`` for a
whole one), the batch a DTensor split on its batch axis, and
``make_train_step(..., sc=ShardCtx(...))`` runs the same code on them:
the model's products on DTensor shards (K3 and K4 on each rank's own
heads), each gradient brought to its parameter's placements (the
reduce-scatter of FSDP, the all-reduce of data parallelism) and AdamW
updating every shard in place, so the state stays placed as resolved, as
JAX's ``out_shardings=state_sh`` keeps it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import get_model
from repro_torch.models.params import (_to_tensor, from_jax, init_params,
                                       leaves, tree_map, unflatten)
from repro_torch.optim import adamw
from repro_torch.sharding import local_slice, place, replicate_plain
from . import compress as C
from .loss import lm_loss

F32 = torch.float32


def make_state(cfg, opt_cfg: adamw.AdamWConfig, generator: torch.Generator,
               device, use_ef: bool = False, shardings=None):
    """A fresh state on ``device``, the parameters drawn from ``generator``
    (a ``torch.Generator`` on that device); with ``shardings`` (a tree of
    ``MeshSharding`` over the state) placed on the mesh as DTensors, the
    same numbers on every rank's blocks as the unplaced state's.  Each
    parameter is placed as soon as it is drawn and the moments and
    residuals are made on each rank's own blocks, so a rank never holds
    more than one leaf whole."""
    get_model(cfg)
    sh = shardings or {}
    params = init_params(cfg, generator, device, sh.get("params"))
    step = torch.zeros((), dtype=torch.int32, device=device)
    state = {"params": params,
             "opt": adamw.init_state(opt_cfg, params, sh.get("opt")),
             "step": step if shardings is None else place(step, sh["step"])}
    if use_ef:
        state["ef"] = C.init_ef(params)
    return state


def abstract_state(cfg, opt_cfg: adamw.AdamWConfig, use_ef: bool = False):
    """The state as ``meta`` tensors (no storage), for placement."""
    ap = get_model(cfg).abstract(cfg)
    state = {"params": ap,
             "opt": adamw.abstract_state(opt_cfg, ap),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    if use_ef:
        state["ef"] = tree_map(lambda p: torch.empty(
            p.shape, dtype=torch.bfloat16, device="meta"), ap)
    return state


def state_logical(cfg, opt_cfg: adamw.AdamWConfig, use_ef: bool = False):
    """The state's logical axes, parallel to ``abstract_state``."""
    lg = get_model(cfg).logical(cfg)
    state = {"params": lg,
             "opt": adamw.state_logical(opt_cfg, lg),
             "step": ()}
    if use_ef:
        state["ef"] = lg
    return state


def shard_state(state, shardings):
    """``device_put``: a whole state (the same on every rank) as DTensors
    of ``shardings`` (a tree of ``MeshSharding``), each rank keeping its
    own block."""
    return tree_map(place, state, shardings)


def state_from_jax(cfg, opt_cfg: adamw.AdamWConfig, tree, device):
    """Carry a JAX train state (``repro.train.make_state``'s tree as numpy
    arrays: params, opt {mu, count}, step and, if present, ef) onto
    ``device``; the parameters through ``models.params.from_jax``, every
    other leaf with the shape of its parameter checked."""
    params = from_jax(cfg, tree["params"], device)

    def carry(p, a):     # the array's own dtype (bf16 as its bits)
        return _to_tensor(a, p.dtype, device)

    def moments(p, mu):
        names = ("m_q", "m_s", "v_q", "v_s") if opt_cfg.quantized else \
            ("m", "v")
        if set(mu) != set(names):
            raise ValueError(f"moments {sorted(mu)} where {names} are "
                             f"expected")
        for n in ("m_q", "v_q") if opt_cfg.quantized else names:
            if tuple(np.shape(mu[n])) != tuple(p.shape):
                raise ValueError(f"moment {n} is {np.shape(mu[n])}, its "
                                 f"parameter {tuple(p.shape)}")
        return {n: carry(p, mu[n]) for n in names}

    state = {"params": params,
             "opt": {"mu": tree_map(moments, params, tree["opt"]["mu"]),
                     "count": torch.as_tensor(np.array(
                         tree["opt"]["count"]), device=device)},
             "step": torch.as_tensor(np.array(tree["step"]), device=device)}
    if "ef" in tree:
        state["ef"] = tree_map(carry, params, tree["ef"])
    return state


def _microbatch(batch, accum):
    """Split the leading batch dim into ``accum`` microbatches (JAX's
    contiguous rows; a DTensor batch is gathered, split and each part
    placed as the batch was: token batches are small)."""
    def split(x):
        if isinstance(x, DTensor):
            full = x.full_tensor()
            return [DTensor.from_local(local_slice(part, x.device_mesh,
                                                   x.placements),
                                       x.device_mesh, x.placements,
                                       run_check=False)
                    for part in split(full).contiguous()]
        B = x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum_steps "
                             f"{accum}")
        return x.reshape((accum, B // accum) + tuple(x.shape[1:]))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def _local(x):
    """A replicated DTensor's value as a plain tensor."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def loss_and_grads(cfg, params, batch, sc=None):
    """-> (loss, metrics, grads) of one batch: the loss and metrics as
    plain tensors, each gradient in its parameter's placements (a
    DTensor's partial sums reduced)."""
    live = [t.detach().requires_grad_() for t in leaves(params)]
    with replicate_plain(params):
        loss, metrics = lm_loss(cfg, get_model(cfg).forward(
            cfg, unflatten(params, live), batch, sc=sc), batch)
        grads = torch.autograd.grad(loss, live)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g
                 for g, p in zip(grads, live)]
        return (_local(loss.detach()),
                {k: _local(torch.as_tensor(v).detach())
                 for k, v in metrics.items()},
                unflatten(params, list(grads)))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, lr_fn: Callable,
                    sc=None, use_ef: bool = False):
    """``step_fn(state, batch) -> (state, metrics)``; ``sc`` is the
    model's activation hook (a ``ShardCtx`` on a mesh)."""
    accum = cfg.accum_steps

    def step_fn(state, batch):
        params = state["params"]
        with replicate_plain(params):
            return _step(state, params, batch)

    def _step(state, params, batch):
        if accum == 1:
            loss, metrics, grads = loss_and_grads(cfg, params, batch, sc)
        else:
            grads = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=F32,
                               device=leaves(params)[0].device)
            ms = []
            for mb in _microbatch(batch, accum):
                l, m, g = loss_and_grads(cfg, params, mb, sc)
                grads = tree_map(lambda a, b: a + b / accum, grads, g)
                loss = loss + l / accum
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if use_ef:   # the int8 wire format with error feedback
            grads, state["ef"] = C.ef_compress(grads, state["ef"])
        lr = lr_fn(_local(state["step"]))
        _, _, gn = adamw.update(opt_cfg, lr, params, grads, state["opt"])
        state["step"] = state["step"] + 1
        return state, dict(metrics, loss=loss, grad_norm=_local(gn), lr=lr)

    return step_fn
