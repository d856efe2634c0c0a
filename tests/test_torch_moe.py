"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``moe_apply`` and its ``jax.vjp``, in f32 on the reduced qwen3-moe-30b-a3b
config moved case by case: both routers, shared experts, a ragged tail
(``T % moe_group != 0``, whose zero pad rows route like tokens with every
score tied), and capacity factors that drop choices (1.0 and 0.5 beside the
reduced config's no-drop 8.0), so that which choices are dropped is
compared, not only the sums.  Tolerances: y and the aux loss within atol
2e-4 / rtol 1e-4 (the whole-model forward tolerance of
``tests/test_models.py``); gradients of every parameter and of x within
1e-3 of the leaf's largest entry (as ``tests/test_torch_lm.py``)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro_torch import configs as pconfigs
from repro_torch.models import moe

TOL = dict(atol=2e-4, rtol=1e-4)
GRAD_TOL = 1e-3

# (router, shared experts, batch, seq, capacity factor); moe_group 16,
# 8 experts, top-2
CASES = {
    "softmax-nodrop": ("softmax", 0, 2, 16, 8.0),
    "softmax-cf1": ("softmax", 0, 2, 16, 1.0),
    "softmax-cf0.5": ("softmax", 0, 2, 16, 0.5),
    "sigmoid-cf1": ("sigmoid", 0, 2, 16, 1.0),
    "sigmoid-shared-cf0.5": ("sigmoid", 1, 2, 16, 0.5),
    "softmax-ragged-cf1": ("softmax", 0, 2, 13, 1.0),
    "softmax-ragged-cf0.5": ("softmax", 0, 3, 7, 0.5),
    "sigmoid-shared2-ragged-nodrop": ("sigmoid", 2, 2, 13, 8.0),
}


def _cfgs(router, shared, cf):
    changes = dict(router=router, n_shared_experts=shared,
                   capacity_factor=cf)
    return (dataclasses.replace(
        jconfigs.get("qwen3-moe-30b-a3b", reduced=True), **changes),
        dataclasses.replace(
        pconfigs.get("qwen3-moe-30b-a3b", reduced=True), **changes))


def _params(jc, seed):
    """JAX's init with every leaf moved by N(0, 0.1) noise."""
    p = jparams.init_params(jax.random.PRNGKey(seed), jmoe.moe_defs(jc),
                            jnp.float32)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32), p)


def _torch(tree, grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.array(a),
                                               requires_grad=grad), tree)


def _dropped(pc, p, x):
    """Choices the port's router drops on x (at the config's capacity)."""
    B, S, D = x.shape
    T = B * S
    g = min(pc.moe_group, T)
    xt = torch.nn.functional.pad(torch.as_tensor(x).reshape(T, D),
                                 (0, 0, 0, (-T) % g)).reshape(-1, g, D)
    keep = moe.route(pc, torch.as_tensor(p["router"]), xt,
                     moe._capacity(pc, g))[-1]
    return int((~keep).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_and_vjp_match_jax(case):
    router, shared, B, S, cf = CASES[case]
    jc, pc = _cfgs(router, shared, cf)
    seed = sorted(CASES).index(case)
    p = _params(jc, seed)
    rng = np.random.default_rng(100 + seed)
    x = rng.normal(size=(B, S, jc.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    daux = np.float32(rng.normal())

    (jy, jaux), vjp = jax.vjp(lambda pp, xx: jmoe.moe_apply(jc, pp, xx),
                              jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dy), jnp.asarray(daux)))

    pp, px = _torch(p, grad=True), torch.tensor(x, requires_grad=True)
    py, paux = moe.moe_apply(pc, pp, px)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(paux.detach()), float(jaux), **TOL)
    leaves = jax.tree.leaves(pp) + [px]
    grads = torch.autograd.grad(
        (py * torch.as_tensor(dy)).sum() + paux * float(daux), leaves)
    want = jax.tree.leaves(jgp) + [jgx]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max()

    drops = _dropped(pc, p, x)
    if cf < 8.0:       # the case exercises the drop order
        assert drops > 0
    else:
        assert drops == 0


def test_capacity_matches_jax():
    for g in (1, 7, 16, 256):
        for cf in (0.5, 1.0, 1.25, 8.0):
            jc, pc = _cfgs("softmax", 0, cf)
            assert moe._capacity(pc, g) == jmoe._capacity(jc, g)


def test_top_k_ties_take_the_lower_expert():
    """Tied scores (a zero pad row scores every expert alike) route to the
    lowest experts first, as ``jax.lax.top_k`` orders them."""
    _, pc = _cfgs("softmax", 0, 1.0)
    router = torch.randn(pc.d_model, pc.n_experts)
    xt = torch.zeros((1, 4, pc.d_model))
    _, gate, idx, slot, keep = moe.route(pc, router, xt, 2)
    assert idx.tolist() == [[[0, 1]] * 4]
    # choice-major: the four first choices of expert 0 take slots 0-3
    assert slot[0, :, 0].tolist() == [0, 1, 2, 3]
    assert keep[0, :, 0].tolist() == [True, True, False, False]
    np.testing.assert_allclose(gate.numpy(), 0.5)


def test_param_defs_match_jax():
    for shared in (0, 2):
        jc, pc = _cfgs("sigmoid", shared, 1.0)
        jd = jax.tree.map(lambda d: (d.shape, d.init),
                          jmoe.moe_defs(jc), is_leaf=jparams.is_def)
        pd = jax.tree.map(lambda d: (d.shape, d.init), moe.moe_defs(pc),
                          is_leaf=lambda d: isinstance(d, moe.ParamDef))
        assert pd == jd
        assert moe.moe_defs(pc)["router"].dtype == torch.float32
