"""Spec layer of the PyTorch port vs the JAX package: sentinels, pointer
packing, masks, PE cells, FSMs and boundary inits of K1's int32 max-plus
zoo kernels and the unit-cost edit kernels #16/#17, and what ``make``
refuses.  These kernels are int32, so every comparison is exact; the float
and min-plus kernels are in tests/test_torch_zoo_float.py."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_zoo as jzoo
from repro.core import semiring as jsemiring
from repro.core import spec_utils as jsu
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.core import semiring as psemiring
from repro_torch.core import spec_utils as psu
from repro_torch.core import types as PT

from torch_parity import PORTED
from torch_parity import kernel_pair as _pair

# the float and min-plus zoo kernels (tested in
# tests/test_torch_zoo_float.py)
FLOAT_AND_MINPLUS = [8, 9, 10, 14]
# K1's kernels plus the edit kernels, which carry no PE family (the myers
# engine hard-codes their recurrence)
SPEC_KERNELS = PORTED + [16, 17]


@pytest.mark.parametrize("kid", SPEC_KERNELS)
def test_declaration_matches(kid):
    jspec, jparams, spec, params = _pair(kid)
    assert spec.name == jspec.name
    assert spec.sentinel() == int(np.asarray(jspec.sentinel()))
    assert spec.tb_pack == jspec.tb_pack
    assert spec.ptr_bits == jspec.ptr_bits
    assert (spec.n_layers, spec.region, spec.band, spec.objective) == \
        (jspec.n_layers, jspec.region, jspec.band, jspec.objective)
    assert spec.semiring.name == jspec.semiring.name
    if jspec.traceback is None:
        assert spec.traceback is None
    else:
        assert (spec.traceback.n_states, spec.traceback.stop,
                spec.traceback.initial_state) == \
            (jspec.traceback.n_states, jspec.traceback.stop,
             jspec.traceback.initial_state)
    assert (spec.family is None) == (kid in (16, 17))
    for k, v in jparams.items():
        np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(v))


@pytest.mark.parametrize("kid", SPEC_KERNELS)
def test_band_and_region_masks(kid):
    jspec, _, spec, _ = _pair(kid)
    ii, jj = np.meshgrid(np.arange(41), np.arange(37), indexing="ij")
    ii, jj = ii.astype(np.int32), jj.astype(np.int32)
    np.testing.assert_array_equal(
        psu.band_mask(spec, torch.as_tensor(ii), torch.as_tensor(jj)).numpy(),
        np.asarray(jsu.band_mask(jspec, jnp.asarray(ii), jnp.asarray(jj))))
    for q_len, r_len in [(40, 36), (25, 31), (7, 3)]:
        got = psu.region_mask(spec, torch.as_tensor(ii), torch.as_tensor(jj),
                              q_len, r_len).numpy()
        want = np.asarray(jsu.region_mask(jspec, jnp.asarray(ii),
                                          jnp.asarray(jj), q_len, r_len))
        np.testing.assert_array_equal(got, want)


def _random_cells(rng, spec, n):
    L = spec.n_layers
    hi = 20 if spec.family and spec.family.sub == PT.SUB_MATRIX else 4
    q = rng.integers(0, hi, n).astype(np.uint8)
    r = rng.integers(0, hi, n).astype(np.uint8)
    cells = []
    for _ in range(3):
        c = rng.integers(-40, 41, (n, L)).astype(np.int32)
        dead = rng.random((n, L)) < 0.1
        c[dead] = -(1 << 30)
        cells.append(c)
    i = rng.integers(0, 64, n).astype(np.int32)
    j = rng.integers(0, 64, n).astype(np.int32)
    return q, r, cells, i, j


@pytest.mark.parametrize("kid", SPEC_KERNELS)
def test_pe_cells_match(kid, rng):
    jspec, jparams, spec, params = _pair(kid)
    q, r, (diag, up, left), i, j = _random_cells(rng, spec, 512)
    vpe = jax.vmap(jspec.pe, in_axes=(None, 0, 0, 0, 0, 0, 0, 0))
    js, jptr = vpe(jparams, q, r, diag, up, left, i, j)
    t = torch.as_tensor
    ps, pptr = spec.pe(params, t(q), t(r), t(diag), t(up), t(left), t(i),
                       t(j))
    assert ps.dtype == torch.int32
    np.testing.assert_array_equal(
        ps.numpy(), np.asarray(js).reshape(512, spec.n_layers))
    np.testing.assert_array_equal(pptr.numpy(), np.asarray(jptr))


@pytest.mark.parametrize("kid", [k for k in PORTED if k != 12])
def test_fsm_matches(kid, rng):
    jspec, _, spec, _ = _pair(kid)
    n_states = spec.traceback.n_states
    state = rng.integers(0, n_states, 1024).astype(np.int32)
    ptr = rng.integers(0, 1 << spec.ptr_bits, 1024).astype(np.int32)
    jm, jn = jspec.traceback.fsm(jnp.asarray(state), jnp.asarray(ptr))
    pm, pn = spec.traceback.fsm(torch.as_tensor(state), torch.as_tensor(ptr))
    np.testing.assert_array_equal(pm.numpy(), np.broadcast_to(
        np.asarray(jm), (1024,)))
    np.testing.assert_array_equal(pn.numpy(), np.broadcast_to(
        np.asarray(jn), (1024,)))


@pytest.mark.parametrize("kid", SPEC_KERNELS)
def test_init_rows_and_columns(kid):
    jspec, jparams, spec, params = _pair(kid)
    k = np.arange(70, dtype=np.int32)
    L = spec.n_layers
    for jfn, pfn in ((jspec.init_row, spec.init_row),
                     (jspec.init_col, spec.init_col)):
        want = np.asarray(jfn(jparams, jnp.asarray(k))).reshape(70, L)
        got = pfn(params, torch.as_tensor(k)).reshape(70, L)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kid", FLOAT_AND_MINPLUS)
def test_make_refuses_unported(kid):
    """``make`` builds the float and min-plus kernels under the JAX name,
    by index and by name, and refuses an index or a name that neither
    package has."""
    name = jzoo.KERNELS[kid][0]
    assert pzoo.make(kid)[0].name == pzoo.make(name)[0].name == name
    with pytest.raises(KeyError, match=f"#{kid + 100}"):
        pzoo.make(kid + 100)
    with pytest.raises(KeyError, match=f"{name}_x"):
        pzoo.make(f"{name}_x")


@pytest.mark.parametrize("name", ["maxplus", "minplus", "logsumexp"])
def test_semirings_match(name, rng):
    jsr = {s.name: s for s in jsemiring.BY_OBJECTIVE.values()}[name]
    psr = {s.name: s for s in psemiring.BY_OBJECTIVE.values()}[name]
    a = rng.normal(size=(6, 5)).astype(np.float32)
    b = rng.normal(size=(6, 5)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert psr.selective == jsr.selective
    np.testing.assert_allclose(psr.combine(ta, tb).numpy(),
                               np.asarray(jsr.combine(a, b)), rtol=1e-6)
    for axis in (None, 0, 1):
        np.testing.assert_allclose(psr.reduce(ta, axis=axis).numpy(),
                                   np.asarray(jsr.reduce(a, axis=axis)),
                                   rtol=1e-6)
        np.testing.assert_array_equal(psr.arg(ta, axis=axis).numpy(),
                                      np.asarray(jsr.arg(a, axis=axis)))


def test_sentinel_absorbed_by_logsumexp():
    s = torch.tensor(-1e30, dtype=torch.float32)
    assert torch.equal(psemiring.LOG_SUM_EXP.combine(s, s), s)
    assert float(psemiring.LOG_SUM_EXP.combine(s, torch.tensor(-3.5))) == -3.5


def test_tb_pack_resolution():
    spec, _ = pzoo.make(2)                 # affine: 4-bit pointers
    assert psu.resolve_tb_pack(spec, None) == 2
    assert psu.resolve_tb_pack(spec, 1) == 1
    with pytest.raises(ValueError, match="ptr_bits"):
        psu.resolve_tb_pack(spec, 4)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        psu.resolve_tb_pack(spec, 3)
