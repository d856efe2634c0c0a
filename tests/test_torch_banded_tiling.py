"""The port's ``banded`` engine and ``tiled_align`` against the JAX
package's, on the CPU.

``banded`` (``repro_torch.core.banded``) is held exactly to JAX's
``repro.core.banded.run`` on #11-13, with and without ``xdrop``: score and
end cell (both engines pick the first optimum in diagonal, then lane
order); on the banded pair-HMM under logsumexp it is held to JAX's
``reference`` engine to rtol 2e-5 (see that test for why).
``tiled_align`` on the port's ``wavefront`` (K1's plain version here) is
held to JAX's ``tiled_align`` on the ``reference`` engine: the same moves,
tiles and end cell (K1 and ``reference`` share the row-major end-cell
rule; ROADMAP queue 3, "End-cell tie-break")."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import align as jalign
from repro.core import alphabets as jalphabets
from repro.core import banded as jbanded
from repro.core import tiling as jtiling
from repro.prob import kernels as jprob
from repro_torch.core import banded, tiling
from repro_torch.core.api import align
from repro_torch.core.kernels_zoo import from_reference_params
from repro_torch.prob import kernels as pprob
from repro_torch.runtime import plan as plan_mod

from torch_parity import kernel_pair, random_codes


def _batch(rng, spec, B, Q, R, spread):
    qs = np.stack([random_codes(rng, spec, Q) for _ in range(B)])
    rs = np.stack([random_codes(rng, spec, R) for _ in range(B)])
    ql = rng.integers(Q // 2, Q + 1, B).astype(np.int32)
    rl = np.clip(ql + rng.integers(-spread, spread + 1, B), 1,
                 R).astype(np.int32)
    # related pairs: the reference is the query with a few changes
    for b in range(0, B, 2):
        n = min(ql[b], rl[b])
        rs[b, :n] = qs[b, :n]
        rs[b, rng.integers(0, n, 3)] = random_codes(rng, spec, 3)
    return qs, rs, ql, rl


def _jax_rows(jspec, jparams, qs, rs, ql, rl, xdrop):
    out = []
    for b in range(len(ql)):
        w = jbanded.run(jspec, jparams, jnp.asarray(qs[b]),
                        jnp.asarray(rs[b]), int(ql[b]), int(rl[b]),
                        xdrop=xdrop)
        out.append((float(w.score), int(w.end_i), int(w.end_j)))
    return out


@pytest.mark.parametrize("xdrop", [None, 12, 40])
@pytest.mark.parametrize("kid", [11, 12, 13])
def test_banded_equals_jax_banded(kid, xdrop):
    rng = np.random.default_rng(kid)
    jspec, jparams, spec, params = kernel_pair(kid)
    qs, rs, ql, rl = _batch(rng, spec, 8, 64, 72, spec.band // 2 + 2)
    got = banded.run(spec, params, torch.as_tensor(qs), torch.as_tensor(rs),
                     torch.as_tensor(ql), torch.as_tensor(rl), xdrop=xdrop)
    want = _jax_rows(jspec, jparams, qs, rs, ql, rl, xdrop)
    assert [(float(s), int(i), int(j)) for s, i, j in
            zip(got.score, got.end_i, got.end_j)] == want
    assert got.tb is None and got.score.dtype == spec.score_dtype
    if xdrop is not None:
        plain = banded.run(spec, params, torch.as_tensor(qs),
                           torch.as_tensor(rs), torch.as_tensor(ql),
                           torch.as_tensor(rl))
        # pruning never raises a score
        assert bool((got.score <= plain.score).all())


@pytest.mark.parametrize("kid", [11, 12, 13])
def test_banded_scores_equal_reference_engine(kid):
    rng = np.random.default_rng(20 + kid)
    _, _, spec, params = kernel_pair(kid)
    qs, rs, ql, rl = _batch(rng, spec, 6, 48, 48, 2)
    args = (torch.as_tensor(qs), torch.as_tensor(rs), torch.as_tensor(ql),
            torch.as_tensor(rl))
    got = banded.run(spec, params, *args)
    from repro_torch.core import reference
    want = reference.run(spec, params, *args)
    assert torch.equal(got.score, want.score)


def test_banded_pairhmm_logsumexp_equals_jax_reference():
    """The banded pair-HMM forward under logsumexp, held to JAX's
    ``reference`` engine (rtol 2e-5).  JAX's own ``banded`` reads an
    out-of-band neighbour lane clamped to the band's edge lane instead of
    the sentinel (``repro/core/banded.py:66-70`` tests the lane after
    clipping it); on #11-13 that never changes a score, but row 0's unit
    mass in Y reaches the clamped reads here, so JAX's banded adds mass the
    reference does not.  The port masks those reads (ROADMAP queue 3,
    "Banded lane clamp")."""
    rng = np.random.default_rng(5)
    jspec = jprob.pairhmm("logsumexp", band=8)
    jparams = jprob.default_params()
    spec = pprob.pairhmm("logsumexp", band=8)
    params = from_reference_params({k: np.asarray(v)
                                    for k, v in jparams.items()})
    qs, rs, ql, rl = _batch(rng, spec, 4, 32, 40, 4)
    got = banded.run(spec, params, torch.as_tensor(qs), torch.as_tensor(rs),
                     torch.as_tensor(ql), torch.as_tensor(rl))
    want = [float(jalign(jspec, jparams, jnp.asarray(qs[b, :ql[b]]),
                         jnp.asarray(rs[b, :rl[b]]), engine_name="reference",
                         with_traceback=False).score) for b in range(4)]
    np.testing.assert_allclose(got.score.numpy(), want, rtol=2e-5)
    with pytest.raises(ValueError, match="sum-semiring"):
        banded.run(spec, params, torch.as_tensor(qs), torch.as_tensor(rs),
                   xdrop=5)


@pytest.mark.parametrize("kid", [11, 12, 13])
def test_banded_through_the_plan_cache_equals_jax_align(kid):
    rng = np.random.default_rng(30 + kid)
    jspec, jparams, spec, params = kernel_pair(kid)
    q, r = random_codes(rng, spec, 40), random_codes(rng, spec, 44)
    want = jalign(jspec, jparams, jnp.asarray(q), jnp.asarray(r),
                  engine_name="banded", with_traceback=False)
    got = align(spec, params, q, r, engine_name="banded",
                with_traceback=False, device="cpu")
    assert (float(got.score), int(got.end_i), int(got.end_j)) == \
        (float(want.score), int(want.end_i), int(want.end_j))
    plan = plan_mod.get_plan(spec, "banded", (64,), (64,), batch_size=4,
                             with_traceback=False, xdrop=9, device="cpu")
    assert plan.key.xdrop == 9
    assert plan_mod.plan_key_str(plan.key).endswith("/x9/cpu")


def test_banded_refusals():
    _, _, spec, params = kernel_pair(11)
    with pytest.raises(ValueError, match="score-only"):
        plan_mod.get_plan(spec, "banded", (64,), (64,), device="cpu")
    _, _, spec2, _ = kernel_pair(2)
    with pytest.raises(ValueError, match="requires spec.band"):
        plan_mod.get_plan(spec2, "banded", (64,), (64,),
                          with_traceback=False, device="cpu")
    with pytest.raises(ValueError, match="does not accept"):
        plan_mod.get_plan(spec, "wavefront", (64,), (64,), xdrop=5,
                          device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        plan_mod.get_plan(spec, "banded", (64,), (64,),
                          with_traceback=False, xdrop=-1, device="cpu")


# -- tiling ------------------------------------------------------------------
def _pair(rng, nq, nr=None, rate=0.1):
    ref = jalphabets.random_dna(rng, nr or nq)
    read = jalphabets.mutate(rng, ref[:nq], rate)
    return read, ref


@pytest.mark.parametrize("case", [(200, None, 96, 32), (150, 260, 96, 32),
                                  (260, 150, 64, 16), (500, None, 128, 48)])
def test_tiled_align_equals_jax_reference(case):
    nq, nr, tile, overlap = case
    rng = np.random.default_rng(nq + (nr or 0))
    jspec, jparams, spec, params = kernel_pair(2)
    q, r = _pair(rng, nq, nr)
    got = tiling.tiled_align(spec, params, q, r, tile=tile, overlap=overlap,
                             device="cpu")
    want = jtiling.tiled_align(jspec, jparams, jnp.asarray(q),
                               jnp.asarray(r), tile=tile, overlap=overlap,
                               engine_name="reference")
    np.testing.assert_array_equal(got.moves, want.moves)
    assert (got.n_tiles, got.end_i, got.end_j) == \
        (want.n_tiles, want.end_i, want.end_j)
    assert (got.end_i, got.end_j) == (len(q), len(r))
    assert got.n_tiles > 1


def test_tiled_align_reference_engine_equals_wavefront():
    rng = np.random.default_rng(9)
    _, _, spec, params = kernel_pair(2)
    q, r = _pair(rng, 300)
    a = tiling.tiled_align(spec, params, q, r, tile=96, overlap=32,
                           device="cpu")
    b = tiling.tiled_align(spec, params, q, r, tile=96, overlap=32,
                           engine_name="reference", device="cpu")
    np.testing.assert_array_equal(a.moves, b.moves)
    assert (a.end_i, a.end_j) == (b.end_i, b.end_j)
