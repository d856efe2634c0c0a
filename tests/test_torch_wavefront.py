"""K1 of the PyTorch port: its plain version against the JAX oracle
``repro.kernels.wavefront.ref.run`` (per-lane best, best_j and the
('chunk', 32, pack) pointer store), the wrapper's cross-strip reduction
against ``repro.core.reference.run``, and — on a GPU only — the CUDA kernel
against its plain version.  Every comparison of the int32 kernels is exact;
the f32 families (#8-10, the pair-HMM) are held on the card at rtol 1e-5
(max/min) and 2e-5 (logsumexp), with pointers and end columns exact
wherever the scores are bit-equal.

The JAX package is imported inside the CPU tests only, so that
``pytest -m gpu`` runs this file on a GPU machine without JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import kernels_zoo as pzoo
from repro_torch.kernels.wavefront import kernel as K
from repro_torch.kernels.wavefront import ops
from repro_torch.core.spec_utils import band_mask

PORTED = [1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 15]
# K1's other families: zoo kernels and the pair-HMM specs of repro_torch.prob
EXT = [8, 9, 10, 14, "pairhmm_logsumexp", "pairhmm_maxplus",
       "pairhmm_backward_logsumexp", "pairhmm_backward_maxplus",
       "pairhmm_logsumexp_band16"]


def _ext_case(name):
    """(spec, params) of an EXT entry."""
    from repro_torch import prob
    if isinstance(name, int):
        return pzoo.make(name)
    objective = "max" if name.endswith("maxplus") else "logsumexp"
    if name.startswith("pairhmm_backward"):
        return prob.pairhmm_backward(objective), prob.default_params()
    band = 16 if name.endswith("band16") else None
    return prob.pairhmm(objective, band=band), prob.default_params()


def _codes(rng, spec, shape):
    """Random characters of a spec's alphabet: profile columns, complex
    samples, integer squiggles or byte codes."""
    if spec.char_shape == (5,):
        counts = rng.multinomial(8, [0.22, 0.22, 0.22, 0.22, 0.12],
                                 size=shape)
        return (counts / 8).astype(np.float32)
    if spec.char_shape == (2,):
        return rng.normal(size=shape + (2,)).astype(np.float32)
    if spec.char_dtype == torch.int32:
        return rng.integers(0, 128, shape).astype(np.int32)
    hi = 20 if spec.name == "protein_local" else 4
    return rng.integers(0, hi, shape).astype(np.uint8)


def _pair(kid):
    from torch_parity import kernel_pair
    return kernel_pair(kid)


def _batch(rng, spec, B, Q, R):
    """Codes and effective lengths below the bucket (banded kernels keep
    the corner inside the band)."""
    qs = _codes(rng, spec, (B, Q))
    rs = _codes(rng, spec, (B, R))
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
    """Warps per pair (halved while the batch overfills 132 SMs at 32
    warps each, at least 2), power-of-two ring slots, and
    csrc/wavefront.cu's block layout: mbarriers (full, empty per ring
    slot), the substitution matrix, the handoff rings (warps x slots x 16
    columns x up layers), the init row's up layers, one 32-wavefront
    pointer tile of 32 x 36 bytes per warp, and the query and reference
    codes (the latter with 32 bytes each side), each rounded up to 16
    bytes."""
    affine, _ = pzoo.make(2)
    protein, _ = pzoo.make(15)
    assert [K.strip_warps(256, n, 132) for n in (132, 256, 1024, 8192)] \
        == [8, 8, 4, 2]
    assert K.strip_warps(1024, 256, 132) == 8
    assert K.strip_warps(64, 1024, 132) == 2
    assert K.strip_warps(32, 1024, 132) == 1
    assert [K.ring_chunks(256, 8), K.ring_chunks(1024, 8),
            K.ring_chunks(1024, 4)] == [4, 16, 32]
    assert K.smem_bytes(affine, 256, 256, 8) == (
        8 * 4 * 2 * 8 + 8 * 4 * 16 * 2 * 4 + (257 * 2 * 4 + 8)
        + 8 * 32 * 36 + 256 + (256 + 64))
    assert K.smem_bytes(affine, 256, 256, 8, with_tb=False) == \
        K.smem_bytes(affine, 256, 256, 8) - 8 * 32 * 36
    assert K.smem_bytes(protein, 64, 64, 2) == (
        2 * 4 * 2 * 8 + 24 * 24 * 4 + 2 * 4 * 16 * 4 + (65 * 4 + 12)
        + 2 * 32 * 36 + 64 + (64 + 64))
    assert K.supports(affine) is None


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule, emulated on the CPU.  csrc/wavefront.cu runs
# each strip of a pair on its own warp, hands the strip's bottom row to the
# next strip through a ring of RING_CHUNK-column chunks, shuffles only the
# layers the PE reads from the cell above, takes the diagonal from the H
# received one wavefront earlier, and visits only a banded strip's live
# wavefronts.  The emulation follows those rules lane by lane (32 lanes as
# one tensor) and must equal the plain version bit for bit; the handoff
# protocol itself (waits, slots, phases) is simulated with its warps
# interleaved.
POISON = 1 << 20            # what a column read before it was written holds
EXT_SPECS = {"ext-linear": ("linear", 16), "ext-affine": ("affine", 16)}


def _strip_window(c, q_len, r_len, R, band):
    """The wavefronts [w_start, w_end) strip c of a pair visits, as the
    kernel computes them."""
    n_w = min(32 + R - 1, max(r_len + 31, 0))
    w_lo, w_end = 0, n_w
    if band is not None:
        l_max = min(31, q_len - 32 * c - 1)
        w_lo = max(0, 32 * c - band)
        w_end = min(n_w, 32 * c + 2 * l_max + band + 1)
    w_start = max(w_lo - 1, 0)
    return w_start, max(w_end, w_start)


def _emulate_k1(spec, params, query, ref, init_row, init_col, lens, pack,
                lag=K.STRIP_LAG):
    """K1's schedule on the CPU.  Strip c + 1 reads column x of strip c's
    bottom row at wavefront x - 1 from chunk (x - 1) // RING_CHUNK, which
    strip c signals after its wavefront RING_CHUNK (k + 1) + lag - 2; a
    column written after that signal reads as POISON."""
    from repro_torch.core.spec_utils import region_mask
    from repro_torch.core.traceback import pack_lanes
    B, Q = query.shape[:2]
    R = ref.shape[1]
    L = spec.n_layers
    dt = spec.score_dtype
    C, WT, CH = Q // 32, 32 + R - 1, K.RING_CHUNK
    ring_l = list(K.ring_layers(spec))
    diag_l = list(spec.family.diag_layers)
    lanes = torch.arange(32)
    sent = spec.sentinel()
    store = torch.zeros((B, C, 32, WT), dtype=torch.uint8)
    best = torch.full((B, C, 32), sent, dtype=dt)
    best_j = torch.zeros((B, C, 32), dtype=torch.int32)
    for b in range(B):
        q_len, r_len = int(lens[b, 0]), int(lens[b, 1])
        rl = max(min(r_len, R), 0)
        n_live = 0 if q_len <= 0 else min(C, -(-q_len // 32))
        above = None                  # (values, wavefront written) by column
        for c in range(n_live):
            i = 32 * c + lanes + 1
            w_start, w_end = _strip_window(c, q_len, r_len, R, spec.band)
            qc = query[b, 32 * c + lanes]
            col_b = init_col[b, i]
            col_d = init_col[b, i - 1].clone()
            if c == 0:
                col_d[0] = init_row[b, 0]
            prev = torch.full((32, L), sent, dtype=dt)
            up_prev = torch.full((32, L), sent, dtype=dt)
            vals = torch.full((R + 32, L), sent, dtype=dt)
            when = torch.full((R + 32,), -1, dtype=torch.int64)
            for w in range(w_start, w_end):
                j = w - lanes + 1
                rc = ref[b, (w - lanes).clamp(0, R - 1)]
                up = torch.full((32, L), sent, dtype=dt)
                up[1:, ring_l] = prev[:-1, ring_l]
                x = w + 1
                if c == 0:
                    up[0, ring_l] = init_row[b, min(x, R), ring_l]
                elif x <= rl and (spec.band is None
                                  or abs(32 * c - x) <= spec.band):
                    seen = 0 <= int(above[1][x]) <= \
                        CH * (w // CH + 1) + lag - 2
                    up[0, ring_l] = above[0][x, ring_l] if seen else POISON
                diag = torch.full((32, L), sent, dtype=dt)
                diag[:, diag_l] = up_prev[:, diag_l]
                up_prev = up.clone()
                left = prev.clone()
                one = j == 1
                left[one] = col_b[one]
                diag[one] = torch.where(
                    torch.isin(torch.arange(L), torch.tensor(diag_l)),
                    col_d[one], torch.full_like(col_d[one], sent))
                scores, ptr = spec.pe(params, qc, rc, diag, up, left, i, j)
                valid = (j >= 1) & (j <= r_len) & (i <= q_len) & \
                    band_mask(spec, i, j)
                cur = torch.where(valid[:, None], scores.to(dt), sent)
                store[b, c, :, w] = torch.where(valid, ptr, 0).to(
                    torch.uint8)
                if c + 1 < n_live and w >= 31:
                    vals[w - 30], when[w - 30] = cur[31], w
                region = region_mask(spec, i, j, q_len, r_len)
                cand = torch.where(region, cur[:, spec.primary_layer], sent)
                if spec.is_sum:
                    best[b, c] = torch.where(
                        region, spec.combine(best[b, c], cand), best[b, c])
                else:
                    upd = spec.better(cand, best[b, c])
                    best[b, c] = torch.where(upd, cand, best[b, c])
                    best_j[b, c] = torch.where(upd, j.to(torch.int32),
                                               best_j[b, c])
                prev = cur
            above = (vals, when)
    tb = pack_lanes(store.transpose(2, 3), pack).transpose(2, 3)
    return tb.contiguous(), best, best_j


def _case(name):
    if name in EXT_SPECS:
        from repro_torch.mapping import extend
        mode, band = EXT_SPECS[name]
        return extend.extension_spec(band, mode)
    if name in EXT:
        return _ext_case(name)
    return pzoo.make(name)


@pytest.mark.parametrize("name", PORTED + list(EXT_SPECS) + EXT)
def test_kernel_schedule_matches_plain(name, rng):
    """The lane-level schedule (diagonal layers from the previous up, masked
    ring layers, banded windows, handoff at STRIP_LAG, the objective's
    fold) equals the plain version on every family K1 instantiates and
    the mapper's two extension specs."""
    spec, params = _case(name)
    B, Q, R = 3, 96, 80
    qs, rs, ql, rl = _batch(rng, spec, B, Q, R)
    ql[1] = 40                      # a dead third strip
    args = _fill_inputs(spec, params, qs, rs, ql, rl)
    for pack in sorted({spec.tb_pack, 1}):
        want = K.wavefront_fill_plain(spec, params, *args, tb_pack=pack)
        got = _emulate_k1(spec, params, *args, pack)
        for g, w, what in zip(got, want, ("tb", "best", "best_j")):
            assert torch.equal(g, w), f"{spec.name} pack {pack}: {what}"


@pytest.mark.parametrize("lag", [K.STRIP_LAG, K.STRIP_LAG - 1])
def test_strip_handoff_lag(lag, rng):
    """At STRIP_LAG the next strip reads every column after it is written;
    one wavefront less and it reads a column before its producer wrote
    it, and the fill differs: STRIP_LAG is the least safe lag."""
    spec, params = pzoo.make(2)
    qs, rs, ql, rl = _batch(rng, spec, 2, 96, 80)
    args = _fill_inputs(spec, params, qs, rs, ql, rl)
    want = K.wavefront_fill_plain(spec, params, *args, tb_pack=spec.tb_pack)
    got = _emulate_k1(spec, params, *args, spec.tb_pack, lag=lag)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    assert same == (lag == K.STRIP_LAG)


def _simulate_handoff(Q, R, lens, band, warps, nch, lag=K.STRIP_LAG):
    """Interleave the warps of one pair under the kernel's handoff
    protocol (csrc/wavefront.cu: full/empty mbarrier per ring slot, waits
    on a phase's parity; blocks of RING_CHUNK wavefronts, lane 0 reading
    the row above one wavefront ahead).  A strip signals chunk k after its
    wavefront RING_CHUNK (k + 1) + lag - 2.  A warp runs until it must wait
    or has just signalled a chunk full, which hands the turn to the others,
    so that a reader runs as far ahead as the protocol lets it.  Returns
    ``(deadlocked, stale)``: whether every unfinished warp waits at once,
    and the reads of a slot that did not hold the column read."""
    C, CH = Q // 32, K.RING_CHUNK
    q_len, r_len = lens
    rl = max(min(r_len, R), 0)
    NK = -(-rl // CH)
    n_live = 0 if q_len <= 0 else min(C, -(-q_len // 32))
    done = {"full": [[0] * nch for _ in range(warps)],
            "empty": [[0] * nch for _ in range(warps)]}
    slot = [[[None] * CH for _ in range(nch)] for _ in range(warps)]
    stale = []
    progress = [0]

    def ready(kind, g, n):
        """Phase n // nch of the slot's barrier has completed; the parity
        wait the kernel uses is only sound if it is not two phases on."""
        count = done[kind][g][n % nch]
        assert count <= n // nch + 1, "a barrier ran two phases ahead"
        return count > n // nch

    def arrive(kind, g, n):
        done[kind][g][n % nch] += 1
        progress[0] += 1

    def warp(g):
        for c in range(g, C, warps):
            if c >= n_live:
                continue
            consume, produce = c > 0, c + 1 < n_live
            gin, gout = (c - 1) % warps, c % warps
            seq_in = (c - 1) // warps * NK if consume else 0
            seq_out = c // warps * NK
            w_start, w_end = _strip_window(c, q_len, r_len, R, band)
            st = {"done": 0, "held": -1, "sig": 0}

            def acquire(k):
                while st["done"] < min(k, NK):
                    n = seq_in + st["done"]
                    while st["held"] != st["done"] and \
                            not ready("full", gin, n):
                        yield
                    arrive("empty", gin, n)
                    st["done"] += 1
                    st["held"] = -1
                if k < NK and st["held"] != k:
                    while not ready("full", gin, seq_in + k):
                        yield
                    st["held"] = k

            def enter(k):
                while st["sig"] <= k:
                    n = seq_out + st["sig"]
                    while n >= nch and not ready("empty", gout, n - nch):
                        yield
                    if st["sig"] == k:
                        break
                    arrive("full", gout, n)
                    st["sig"] += 1
                    yield

            def read(x):                # lane 0 reads column x of c - 1
                if consume and x <= rl and (band is None
                                            or abs(32 * c - x) <= band):
                    n = seq_in + (x - 1) // CH
                    if slot[gin][n % nch][(x - 1) % CH] != (c - 1, x):
                        stale.append((c, x))

            if w_end > w_start:
                if consume:
                    yield from acquire(w_start // CH)
                read(w_start + 1)
                for m in range((w_start + 1) // CH, w_end // CH + 1):
                    lo, hi = max(w_start, CH * m - 1), min(w_end, CH * m + CH - 1)
                    if consume:
                        yield from acquire(m)
                    pk = m - 32 // CH
                    wr = produce and 0 <= pk < NK
                    if wr:
                        yield from enter(pk)
                    for w in range(lo, hi):
                        read(w + 2)
                        if wr:
                            n = seq_out + pk
                            slot[gout][n % nch][(w - 31) % CH] = (c, w - 30)
                            if w == CH * (pk + 1) + lag - 2:
                                arrive("full", gout, n)
                                st["sig"] = pk + 1
                                yield
                    if consume and st["held"] == m:
                        arrive("empty", gin, seq_in + m)
                        st["done"], st["held"] = m + 1, -1
            if consume:
                yield from acquire(NK)
            if produce and st["sig"] < NK:
                yield from enter(NK - 1)
                arrive("full", gout, seq_out + NK - 1)
                yield

    live = {g: warp(g) for g in range(warps)}
    while live:
        before = progress[0]
        for g in list(live):
            try:
                next(live[g])
            except StopIteration:
                del live[g]
                progress[0] += 1
        if progress[0] == before:
            return True, stale
    return False, stale


@pytest.mark.parametrize("Q,R,lens,band,warps", [
    (256, 256, (256, 256), None, 8),     # one strip per warp
    (256, 256, (250, 240), None, 4),     # two strips per warp
    (1024, 1024, (1024, 1024), None, 8), # four strips per warp
    (1024, 1024, (1000, 700), None, 8),  # ragged lengths
    (512, 96, (500, 96), None, 2),       # few chunks, many strips
    (1024, 1024, (1024, 1000), 64, 8),   # banded: strips skip wavefronts
    (256, 256, (150, 214), 16, 4),       # a mapper extension job
    (96, 80, (40, 80), None, 3),         # a dead strip
])
def test_handoff_protocol_never_waits_forever(Q, R, lens, band, warps):
    """With ring_chunks slots no interleaving of the warps deadlocks, and
    every column a strip reads is the one its producer wrote; a producer
    that signals a chunk one wavefront early lets a greedy reader see a
    stale column."""
    nch = K.ring_chunks(R, warps)
    assert _simulate_handoff(Q, R, lens, band, warps, nch) == (False, [])
    _, stale = _simulate_handoff(Q, R, lens, band, warps, nch,
                                 lag=K.STRIP_LAG - 1)
    assert stale


def test_handoff_ring_too_small_deadlocks():
    """The simulation does find a deadlock: eight warps on 32 strips with
    two slots per ring close the ring on themselves."""
    assert _simulate_handoff(1024, 1024, (1024, 1024), None, 8, 2)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("kid", PORTED)
def test_cuda_kernel_matches_plain(kid):
    """K1 on the card equals its plain version on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is CUDA C++ with no CPU mode)")
    rng = np.random.default_rng(kid)
    spec, params = pzoo.make(kid)
    for B, Q, R in [(16, 64, 64), (8, 256, 256), (3, 1024, 1024)]:
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


def _hold_float(spec, got, want, what):
    """K1 against its plain version on one batch: best within the
    family's tolerance (exact for int32), and, for every pair whose best
    is bit-equal, best_j and the pointer store exact."""
    tb, best, best_j = got
    ptb, pbest, pbest_j = want
    if not spec.score_dtype.is_floating_point:
        assert all(torch.equal(g, w) for g, w in zip(got, want)
                   if g is not None), what
        return
    rtol = 2e-5 if spec.is_sum else 1e-5
    torch.testing.assert_close(best, pbest, rtol=rtol, atol=0, msg=what)
    same = (best == pbest).reshape(best.shape[0], -1).all(dim=1)
    assert torch.equal(best_j[same], pbest_j[same]), what
    if tb is not None:
        assert torch.equal(tb[same], ptb[same]), what


@pytest.mark.gpu
@pytest.mark.parametrize("name", EXT)
def test_cuda_ext_families_match_plain(name):
    """K1's f32 max-plus, min-plus and logsumexp instantiations and sDTW's
    int32 min-plus on the card against the plain version on the same
    card, at buckets 64 (batch 16), 256 (batch 8) and 1024 (batch 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is CUDA C++ with no CPU mode)")
    rng = np.random.default_rng(7)
    spec, params = _ext_case(name)
    for B, Q, R in [(16, 64, 64), (8, 256, 256), (3, 1024, 1024)]:
        qs, rs, ql, rl = _batch(rng, spec, B, Q, R)
        args = _fill_inputs(spec, params, qs, rs, ql, rl, device="cuda")
        for pack in sorted({spec.tb_pack, 1}):
            before = K.launches
            got = K.wavefront_fill(spec, params, *args, tb_pack=pack)
            assert K.launches == before + 1
            want = K.wavefront_fill_plain(spec, params, *args, tb_pack=pack)
            torch.cuda.synchronize()
            _hold_float(spec, got, want, f"{name} {Q}x{R} pack {pack}")


@pytest.mark.gpu
@pytest.mark.parametrize("kid", PORTED + [8, 9, 14])
def test_cuda_empty_and_out_of_band_pairs(kid):
    """Empty queries or references and banded corners outside the band
    give the CPU path's result on the card: the sentinel score, end cell
    (0, 0), no moves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 is CUDA C++ with no CPU mode)")
    from repro_torch.runtime import dispatch
    rng = np.random.default_rng(kid)
    spec, params = pzoo.make(kid)
    shapes = [(0, 5), (5, 0), (0, 0), (32, 1), (1, 32), (2, 64)]
    pairs = [(_codes(rng, spec, (nq,)), _codes(rng, spec, (nr,)))
             for nq, nr in shapes]
    tb = spec.traceback is not None
    got = dispatch.run_pairs(spec, params, pairs, block=4,
                             with_traceback=tb)
    want = dispatch.run_pairs(spec, params, pairs, block=4,
                              with_traceback=tb, device="cpu")
    for (nq, nr), g, w in zip(shapes, got, want):
        for f in ("score", "end_i", "end_j") + (("n_moves",) if tb else ()):
            assert np.array_equal(np.asarray(getattr(g, f)),
                                  np.asarray(getattr(w, f))), (nq, nr, f)


def test_both_sources_rebuild_when_the_shared_header_changes(tmp_path):
    """K1's two sources include csrc/wavefront_kernel.cuh, so the build
    key of each covers the header as well as the source."""
    from repro_torch.kernels import build
    for name in ("wavefront.cu", "wavefront_ext.cu"):
        (tmp_path / name).write_bytes((K.CSRC / name).read_bytes())
    header = tmp_path / "wavefront_kernel.cuh"
    header.write_text("// one version\n")
    before = [build._digest(tmp_path / n) for n in ("wavefront.cu",
                                                     "wavefront_ext.cu")]
    header.write_text("// another version\n")
    after = [build._digest(tmp_path / n) for n in ("wavefront.cu",
                                                    "wavefront_ext.cu")]
    assert before[0] != after[0] and before[1] != after[1]
    assert K.SOURCES == (K.CSRC / "wavefront.cu", K.CSRC / "wavefront_ext.cu")
