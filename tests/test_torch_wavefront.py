"""K1 of the PyTorch port: its plain version against the JAX oracle
``repro.kernels.wavefront.ref.run`` (per-lane best, best_j and the
('chunk', 32, pack) pointer store), the wrapper's cross-strip reduction
against ``repro.core.reference.run``, and — on a GPU only — the CUDA kernel
against its plain version.  Every comparison is exact (int32 kernels).

The JAX package is imported inside the CPU tests only, so that
``pytest -m gpu`` runs this file on a GPU machine without JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import kernels_zoo as pzoo
from repro_torch.kernels.wavefront import kernel as K
from repro_torch.kernels.wavefront import ops

PORTED = [1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 15]


def _pair(kid):
    from torch_parity import kernel_pair
    return kernel_pair(kid)


def _batch(rng, spec, B, Q, R):
    """Codes and effective lengths below the bucket (banded kernels keep
    the corner inside the band)."""
    hi = 20 if spec.name == "protein_local" else 4
    qs = rng.integers(0, hi, (B, Q)).astype(np.uint8)
    rs = rng.integers(0, hi, (B, R)).astype(np.uint8)
    ql = rng.integers(Q // 2, Q + 1, B).astype(np.int32)
    ql[0] = Q
    if spec.band is not None:
        rl = np.clip(ql + rng.integers(-spec.band // 2, spec.band // 2 + 1,
                                       B), 1, R).astype(np.int32)
    else:
        rl = rng.integers(R // 3, R + 1, B).astype(np.int32)
    return qs, rs, ql, rl


def _fill_inputs(spec, params, qs, rs, ql, rl, device="cpu"):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    q_lens, r_lens = t(ql), t(rl)
    init_row, init_col = ops.boundaries(spec, params, qs.shape[1],
                                        rs.shape[1], q_lens, r_lens)
    lens = torch.stack([q_lens, r_lens], dim=1).contiguous()
    return t(qs), t(rs), init_row, init_col, lens


@pytest.mark.parametrize("kid", PORTED)
def test_plain_fill_matches_oracle(kid, rng):
    from repro.core.traceback import pack_lanes as jpack_lanes
    from repro.kernels.wavefront import ref as jwref
    jspec, jparams, spec, params = _pair(kid)
    B, Q, R = 3, 64, 48
    qs, rs, ql, rl = _batch(rng, spec, B, Q, R)
    oracle = [jwref.run(jspec, jparams, qs[b], rs[b], ql[b], rl[b], n_pe=32)
              for b in range(B)]
    args = _fill_inputs(spec, params, qs, rs, ql, rl)
    before = K.launches
    for pack in sorted({spec.tb_pack, 1}):
        tb, best, best_j = K.wavefront_fill(spec, params, *args,
                                            tb_pack=pack)
        assert tb.shape == (B, Q // 32, 32 // pack, 32 + R - 1)
        for b, (o_best, o_best_j, o_tb) in enumerate(oracle):
            np.testing.assert_array_equal(best[b].numpy(), o_best)
            np.testing.assert_array_equal(best_j[b].numpy(), o_best_j)
            want = np.asarray(jpack_lanes(np.swapaxes(o_tb, 1, 2), pack))
            np.testing.assert_array_equal(tb[b].numpy(),
                                          np.swapaxes(want, 1, 2))
    assert K.launches == before      # CPU tensors never reach the kernel


@pytest.mark.parametrize("kid", PORTED)
def test_ops_run_matches_reference_engine(kid, rng):
    from repro.core import reference as jreference
    jspec, jparams, spec, params = _pair(kid)
    B, Q, R = 3, 40, 56            # Q pads up to the 32-row strip
    qs, rs, ql, rl = _batch(rng, spec, B, Q, R)
    res = ops.run(spec, params, torch.as_tensor(qs), torch.as_tensor(rs),
                  torch.as_tensor(ql), torch.as_tensor(rl))
    for b in range(B):
        want = jreference.run(jspec, jparams, qs[b], rs[b], int(ql[b]),
                              int(rl[b]))
        assert int(res.score[b]) == int(want.score)
        assert int(res.end_i[b]) == int(want.end_i)
        assert int(res.end_j[b]) == int(want.end_j)
    pack = spec.tb_pack
    assert res.tb_layout == (("chunk", 32) if pack == 1
                             else ("chunk", 32, pack))


def test_score_only_fill_skips_the_store(rng):
    spec, params = pzoo.make(2)
    qs, rs, ql, rl = _batch(rng, spec, 2, 32, 32)
    args = _fill_inputs(spec, params, qs, rs, ql, rl)
    tb, best, best_j = K.wavefront_fill(spec, params, *args, with_tb=False)
    full = K.wavefront_fill(spec, params, *args)
    assert tb is None
    assert torch.equal(best, full[1]) and torch.equal(best_j, full[2])


def test_wrapper_rejects_bad_inputs(rng):
    spec, params = pzoo.make(1)
    qs, rs, ql, rl = _batch(rng, spec, 2, 32, 16)
    q, r, row, col, lens = _fill_inputs(spec, params, qs, rs, ql, rl)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.wavefront_fill(spec, params, q[:, :30], r, row, col[:, :31], lens)
    with pytest.raises(ValueError, match="init_row"):
        K.wavefront_fill(spec, params, q, r, row.long(), col, lens)
    with pytest.raises(ValueError, match="tb_pack"):
        K.wavefront_fill(spec, params, q, r, row, col, lens, tb_pack=3)


def test_shared_memory_estimate():
    affine, _ = pzoo.make(2)
    protein, _ = pzoo.make(15)
    assert K.smem_bytes(affine, 256, warps=4) == 4 * 257 * 3 * 4
    assert K.smem_bytes(protein, 64, warps=1) == 24 * 24 * 4 + 65 * 4
    assert K.supports(affine) is None


@pytest.mark.gpu
@pytest.mark.parametrize("kid", PORTED)
def test_cuda_kernel_matches_plain(kid):
    """K1 on the card equals its plain version on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is CUDA C++ with no CPU mode)")
    rng = np.random.default_rng(kid)
    spec, params = pzoo.make(kid)
    for B, Q, R in [(16, 64, 64), (8, 256, 256)]:
        qs, rs, ql, rl = _batch(rng, spec, B, Q, R)
        args = _fill_inputs(spec, params, qs, rs, ql, rl, device="cuda")
        for pack in sorted({spec.tb_pack, 1}):
            before = K.launches
            got = K.wavefront_fill(spec, params, *args, tb_pack=pack)
            assert K.launches == before + 1
            want = K.wavefront_fill_plain(spec, params, *args, tb_pack=pack)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
