"""Train-step factory (port of ``repro/train/step.py``): loss -> grads (with
microbatch accumulation) -> optional EF-int8 compression -> AdamW.

A train state is a dict: ``params`` (the model's tree), ``opt`` (AdamW's
``{"mu", "count"}``), ``step`` (an int32 0-dim tensor) and, with error
feedback, ``ef``.  ``step_fn(state, batch)`` updates it in place (AdamW
writes into the parameters and moments; see ``optim/adamw.py``) and returns
it with the step's metrics.  JAX's ``abstract_state`` and ``state_logical``
feed the sharded dry run and wait for multi-GPU placement (ROADMAP queue 1
item 14).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.models import get_model
from repro_torch.models.params import (_to_tensor, from_jax, init_params,
                                       leaves, tree_map, unflatten)
from repro_torch.optim import adamw
from . import compress as C
from .loss import lm_loss

F32 = torch.float32


def make_state(cfg, opt_cfg: adamw.AdamWConfig, generator: torch.Generator,
               device, use_ef: bool = False):
    """A fresh state on ``device``, the parameters drawn from ``generator``
    (a ``torch.Generator`` on that device)."""
    get_model(cfg)
    params = init_params(cfg, generator, device)
    state = {"params": params,
             "opt": adamw.init_state(opt_cfg, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if use_ef:
        state["ef"] = C.init_ef(params)
    return state


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
    """Split the leading batch dim into ``accum`` microbatches."""
    def split(x):
        B = x.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum_steps "
                             f"{accum}")
        return x.reshape((accum, B // accum) + tuple(x.shape[1:]))
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, lr_fn: Callable,
                    use_ef: bool = False):
    model = get_model(cfg)
    accum = cfg.accum_steps

    def value_and_grad(params, mb):
        live = [t.detach().requires_grad_() for t in leaves(params)]
        loss, metrics = lm_loss(cfg, model.forward(cfg, unflatten(
            params, live), mb), mb)
        grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: torch.as_tensor(v).detach()
                                for k, v in metrics.items()},
                unflatten(params, list(grads)))

    def step_fn(state, batch):
        params = state["params"]
        if accum == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            grads = tree_map(torch.zeros_like, params)
            loss = torch.zeros((), dtype=F32,
                               device=leaves(params)[0].device)
            ms = []
            for mb in _microbatch(batch, accum):
                l, m, g = value_and_grad(params, mb)
                grads = tree_map(lambda a, b: a + b / accum, grads, g)
                loss = loss + l / accum
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if use_ef:   # the int8 wire format with error feedback
            grads, state["ef"] = C.ef_compress(grads, state["ef"])
        lr = lr_fn(state["step"])
        _, _, gn = adamw.update(opt_cfg, lr, params, grads, state["opt"])
        state["step"] = state["step"] + 1
        return state, dict(metrics, loss=loss, grad_norm=gn, lr=lr)

    return step_fn
