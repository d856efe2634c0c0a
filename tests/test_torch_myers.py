"""K2 of the PyTorch port and the ``myers`` engine vs the JAX package on the
CPU: the plain version behind ``ops.run`` against ``repro.core.myers.run``,
and ``align``/``run_pairs`` with ``engine_name="myers"`` against JAX's
``myers`` and ``reference`` engines, for #16 and #17 on DNA, protein and
codes up to 31, multiword queries, lengths below the bucket, empty and
identical pairs, and the thresholds k = -1, 0, the exact distance and one
below it.  Every comparison is exact.  On a GPU only, the CUDA kernel is
held against its plain version.

The JAX package is imported inside the CPU tests only, so that
``pytest -m gpu`` runs this file on a GPU machine without JAX."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.core import myers as M
from repro_torch.core import kernels_zoo as pzoo
from repro_torch.kernels.myers import kernel as K
from repro_torch.kernels.myers import ops
from repro_torch.kernels.wavefront import kernel as K1
from repro_torch.runtime import dispatch, registry

EDIT = ["edit_distance", "edit_search"]
SENT = 1 << 30
FIELDS = ("score", "end_i", "end_j")


def _batch(rng, n_sym, B, Q, R):
    """Pairs below the bucket, with an identical pair, a near-identical
    one, one-row and one-column pairs, and empty pairs on either side."""
    qs = rng.integers(0, n_sym, (B, Q)).astype(np.uint8)
    rs = rng.integers(0, n_sym, (B, R)).astype(np.uint8)
    ql = rng.integers(1, Q + 1, B).astype(np.int32)
    rl = rng.integers(1, R + 1, B).astype(np.int32)
    n = min(Q, R)
    ql[0], rl[0] = n, n                      # identical pair
    rs[0, :n] = qs[0, :n]
    ql[1], rl[1] = n, R                      # query mutated inside the ref
    rs[1, 3:3 + n - 6] = qs[1, 3:n - 3]
    ql[2], rl[2] = 1, R
    ql[3], rl[3] = Q, 1
    ql[4] = 0
    rl[5] = 0
    return qs, rs, ql, rl


def _jax_run(kname, k, qs, rs, ql, rl):
    import jax
    import jax.numpy as jnp
    from repro.core import kernels_zoo as jzoo
    from repro.core import myers as jmyers
    jspec, _ = jzoo.make(kname)
    params = {"max_dist": jnp.int32(k)}
    out = jax.vmap(lambda q, r, a, b: jmyers.run(jspec, params, q, r, a, b))(
        qs, rs, ql, rl)
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _port_run(kname, k, qs, rs, ql, rl):
    spec, _ = pzoo.make(kname)
    t = torch.as_tensor
    before = K.launches
    out = ops.run(spec, {"max_dist": k}, t(qs), t(rs), t(ql), t(rl))
    assert K.launches == before      # CPU tensors never reach the kernel
    return {f: getattr(out, f).numpy() for f in FIELDS}


@pytest.mark.parametrize("n_sym", [4, 24, 32])    # DNA, protein, codes <= 31
@pytest.mark.parametrize("kname", EDIT)
def test_plain_engine_matches_jax_myers(kname, n_sym, rng):
    B, Q, R = 12, 160, 96                          # 5 words of 32 bits
    qs, rs, ql, rl = _batch(rng, n_sym, B, Q, R)
    d = _jax_run(kname, -1, qs, rs, ql, rl)["score"][1]
    assert 0 < d < SENT
    for k in (-1, 0, int(d), int(d) - 1):
        want = _jax_run(kname, k, qs, rs, ql, rl)
        got = _port_run(kname, k, qs, rs, ql, rl)
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"{kname} k={k}: {f}")
        if k == int(d) - 1:
            assert got["score"][1] == SENT     # one below the distance
        if k == int(d):
            assert got["score"][1] == d


@pytest.mark.parametrize("kname", EDIT)
def test_plain_fill_ignores_bucket_padding(kname, rng):
    """The same pairs in buckets 64 and 128 with junk codes in the padding
    give the same outputs, and codes >= 32 in the query match nothing while
    reference codes clip to 31."""
    qs, rs, ql, rl = _batch(rng, 4, 8, 40, 40)
    qs[6, :5] = 200
    rs[7, :5] = 255
    lens = torch.as_tensor(np.stack([ql, rl], 1))
    outs = []
    for bucket in (64, 128):
        q = rng.integers(0, 4, (8, bucket)).astype(np.uint8)
        r = rng.integers(0, 4, (8, bucket)).astype(np.uint8)
        q[:, :40], r[:, :40] = qs, rs
        outs.append(K.myers_fill_plain(torch.as_tensor(q), torch.as_tensor(r),
                                       lens, glob=kname == "edit_distance",
                                       k=-1))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = _jax_run(kname, -1, qs, rs, ql, rl)
    got = _port_run(kname, -1, qs, rs, ql, rl)
    np.testing.assert_array_equal(got["score"], want["score"])


def _pairs(rng, n_sym, n, lo, hi):
    pairs = []
    for _ in range(n):
        q = rng.integers(0, n_sym, int(rng.integers(lo, hi))).astype(np.uint8)
        r = rng.integers(0, n_sym, int(rng.integers(lo, hi))).astype(np.uint8)
        pairs.append((q, r))
    pairs[0] = (pairs[0][0], pairs[0][0].copy())           # identical
    return pairs


@pytest.mark.parametrize("kname", EDIT)
def test_run_pairs_matches_jax_engines(kname, rng):
    from repro.core import kernels_zoo as jzoo
    from repro.runtime import dispatch as jdispatch
    jspec, _ = jzoo.make(kname)
    spec, _ = pzoo.make(kname)
    pairs = _pairs(rng, 4, 9, 5, 150)                      # buckets 16-256
    for k in (-1, 0, 12):
        jparams = {"max_dist": np.int32(k)}
        params = pzoo.from_reference_params(jparams)
        got = dispatch.run_pairs(spec, params, pairs, engine_name="myers",
                                 block=4, device="cpu")
        want = jdispatch.run_pairs(jspec, jparams, pairs,
                                   engine_name="myers", block=4)
        exact = jdispatch.run_pairs(jspec, jparams, pairs,
                                    engine_name="reference", block=4)
        for g, w, e in zip(got, want, exact):
            for f in FIELDS:
                assert int(getattr(g, f)) == int(getattr(w, f)), f
            # the reference engine has no threshold: saturate it at k
            score = int(e.score)
            if 0 <= k < score:
                assert int(g.score) == SENT
            else:
                assert (int(g.score), int(g.end_i), int(g.end_j)) == \
                    (score, int(e.end_i), int(e.end_j))


@pytest.mark.parametrize("kname", EDIT)
def test_align_matches_jax_myers(kname, rng):
    from repro.core import api as japi
    from repro.core import kernels_zoo as jzoo
    jspec, jparams = jzoo.make(kname)
    spec, params = pzoo.make(kname)
    q = rng.integers(0, 4, 70).astype(np.uint8)
    r = np.concatenate([rng.integers(0, 4, 9).astype(np.uint8), q[2:],
                        rng.integers(0, 4, 5).astype(np.uint8)])
    want = japi.align(jspec, jparams, q, r, engine_name="myers")
    got = api.align(spec, params, q, r, engine_name="myers", device="cpu")
    for f in FIELDS:
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert got.moves is None


def test_engine_admission_and_wrapper_checks(rng):
    edit, _ = pzoo.make(16)
    linear, _ = pzoo.make(7)
    assert registry.engine_supports("myers", edit) is None
    assert "unit-cost" in registry.engine_supports("myers", linear)
    # K1 has no hand-written edit functor; it runs #16 through one
    # generated from the PE, which scores as K2 does
    assert "family" in K1.hand_written(edit)
    assert K1.supports(edit) is None and K1.is_generated(edit)
    q = rng.integers(0, 4, 8).astype(np.uint8)
    r = rng.integers(0, 4, 8).astype(np.uint8)
    on_k1 = api.align(edit, {"max_dist": -1}, q, r, device="cpu",
                      with_traceback=False)
    on_k2 = api.align(edit, {"max_dist": -1}, q, r, engine_name="myers",
                      device="cpu", with_traceback=False)
    assert int(on_k1.score) == int(on_k2.score)
    assert [K.n_words(q) for q in (1, 64, 65, 256, 1024)] == [1, 1, 2, 4, 16]
    with pytest.raises(ValueError, match="1024"):
        K.n_words(1025)
    q = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="lens"):
        K.myers_fill(q, q, torch.ones((2, 2), dtype=torch.int64),
                     glob=True, k=-1)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kname", EDIT)
def test_score_trail_gives_the_threshold_exit(kname, rng):
    """The last-row score trail of an unthresholded sweep holds its answers,
    and the exit rule chip_smoke.py applies to that trail picks exactly the
    rows a thresholded sweep stops."""
    glob = kname == "edit_distance"
    qs, rs, ql, rl = _batch(rng, 4, 12, 160, 96)
    lens = np.stack([ql, rl], 1)
    args = (torch.as_tensor(qs), torch.as_tensor(rs), torch.as_tensor(lens))
    score, best, best_j, _, trail = M.sweep(*args, glob=glob, k=-1,
                                            trace=True)
    t = trail.numpy()
    live = (ql >= 1) & (rl >= 1)
    for b in np.flatnonzero(live):
        row = t[b, 1:rl[b] + 1]
        if glob:
            assert row[-1] == score[b]
        else:
            assert (row.min(), np.argmin(row) + 1) == (best[b], best_j[b])
    exit_rows = _chip_smoke()._k_exit_rows
    for k in (-1, 0, 5, 20, 60):
        stopped = M.sweep(*args, glob=glob, k=k)[0].numpy() == SENT
        np.testing.assert_array_equal(
            exit_rows(t, lens, glob, k) | ~live, stopped, err_msg=f"k={k}")


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule, emulated on the CPU.  csrc/myers.cu gives each
# 64-bit word of a pair its own lane (32 / NW pairs a warp): at step t lane
# w advances column t - w + 1 with the hin lane w - 1 produced one step
# earlier, and the lane of the score word sw tests the k-exit every
# CHECK_EVERY steps and at the last column, sending the answer to the
# pair's lanes by a shuffle.  The 64-bit words are Python integers (torch
# has no unsigned 64-bit arithmetic on the CPU).
W64 = (1 << 64) - 1


def _emulate_k2(qs, rs, lens, glob, k, nw, check_every):
    B, Q = qs.shape
    R = rs.shape[1]
    P = 32 // nw
    out = np.zeros((3, B), np.int64)
    for b0 in range(0, B, P):
        lanes = []
        for lane in range(32):
            b, w = b0 + lane // nw, lane % nw
            q_len = min(max(int(lens[b, 0]), 0), Q) if b < B else 0
            r_len = min(max(int(lens[b, 1]), 0), R) if b < B else 0
            live = q_len >= 1 and r_len >= 1
            sw = (q_len - 1) >> 6 if live else 0
            peq = [0] * 32
            for i in range(64 * w, min(q_len, 64 * w + 64)):
                if qs[b, i] < 32:
                    peq[qs[b, i]] |= 1 << (i - 64 * w)
            lanes.append(dict(b=b, w=w, q_len=q_len, r_len=r_len, sw=sw,
                              sb=(q_len - 1) & 63 if live else 0, peq=peq,
                              vp=W64, vn=0, hout=0, score=q_len, best=SENT,
                              bestj=0, prev=(q_len, SENT), stopped=False,
                              done=not live,
                              t_hi=r_len - 1 + w if live and w <= sw
                              else -1,
                              t_end=r_len - 1 + sw if live else -1))
        t_max = max(x["t_end"] for x in lanes)
        for t in range(t_max + 1):
            if t % check_every == 0:
                for x in lanes:     # the k-exit test before column j
                    j = t - x["w"] + 1
                    if (x["w"] == x["sw"] and x["w"] <= t <= x["t_hi"]
                            and k >= 0 and min(x["best"], x["score"]
                                               - (x["r_len"] - (j - 1)))
                            > k):
                        x["stopped"] = True
                for lane, x in enumerate(lanes):
                    if lanes[lane - x["w"] + x["sw"]]["stopped"]:
                        x["done"], x["t_hi"] = True, -1
                if all(x["done"] or t > x["t_end"] for x in lanes):
                    break
            hins = [0] + [x["hout"] for x in lanes[:-1]]   # __shfl_up_sync
            for x, h in zip(lanes, hins):
                if not x["w"] <= t <= x["t_hi"]:
                    continue
                j = t - x["w"] + 1
                hin = (1 if glob else 0) if x["w"] == 0 else h
                c = min(int(rs[x["b"], j - 1]), 31)
                eq0, vp, vn = x["peq"][c], x["vp"], x["vn"]
                hneg, hpos = int(hin < 0), int(hin > 0)
                xv = eq0 | vn
                eq = eq0 | hneg
                xh = ((((eq & vp) + vp) & W64) ^ vp) | eq
                ph = vn | (~(xh | vp) & W64)
                mh = vp & xh
                x["hout"] = (ph >> 63) - (mh >> 63)
                x["prev"] = (x["score"], x["best"])
                sb = x["sb"]
                x["score"] += ((ph >> sb) & 1) - ((mh >> sb) & 1)
                if not glob and x["score"] < x["best"]:
                    x["best"], x["bestj"] = x["score"], j
                phs = ((ph << 1) & W64) | hpos
                mhs = ((mh << 1) & W64) | hneg
                x["vp"] = mhs | (~(xv | phs) & W64)
                x["vn"] = phs & xv
        for x in lanes:     # the last column is always tested
            s_prev, b_prev = x["prev"]
            if (x["w"] == x["sw"] and not x["done"] and k >= 0
                    and min(b_prev, s_prev - 1) > k):
                x["stopped"] = True
        for x in lanes:
            if x["b"] < B and x["w"] == x["sw"]:
                dead = not (x["q_len"] >= 1 and x["r_len"] >= 1) \
                    or x["stopped"]
                out[:, x["b"]] = ((SENT, SENT, 0) if dead else
                                  (x["score"], x["best"], x["bestj"]))
    return out


def _k2_plain(qs, rs, ql, rl, glob, k):
    lens = torch.as_tensor(np.stack([ql, rl], 1))
    got = K.myers_fill_plain(torch.as_tensor(qs), torch.as_tensor(rs), lens,
                             glob=glob, k=k)
    return np.stack([g.numpy() for g in got]).astype(np.int64)


@pytest.mark.parametrize("nw", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kname", EDIT)
def test_kernel_schedule_matches_plain(kname, nw, rng):
    """The word-lane diagonal schedule equals the plain sweep at every
    instantiation, in both modes, without and with thresholds."""
    glob = kname == "edit_distance"
    Q = 40 if nw == 1 else 64 * nw - 24        # n_words(Q) == nw
    B = max(2 * (32 // nw), 8)                 # two warps of pairs
    qs, rs, ql, rl = _batch(rng, 4, B, Q, 48)
    assert K.n_words(Q) == nw
    lens = np.stack([ql, rl], 1)
    free = _k2_plain(qs, rs, ql, rl, glob, -1)
    for k in (-1, 0, 5, int(np.median(free[0 if glob else 1][:6]))):
        want = _k2_plain(qs, rs, ql, rl, glob, k)
        got = _emulate_k2(qs, rs, lens, glob, k, nw, K.CHECK_EVERY)
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")


@pytest.mark.parametrize("every", [1, 4, 8])
def test_late_k_exit_gives_the_same_outputs(every, rng):
    """Testing the k-exit every 1, 4 or 8 steps (and at the last column)
    gives the outputs of the plain sweep, which tests every column, for
    every k from 0 to beyond the largest distance."""
    qs, rs, ql, rl = _batch(rng, 4, 32, 100, 72)
    lens = np.stack([ql, rl], 1)
    for glob in (True, False):
        for k in range(0, 80, 3):
            want = _k2_plain(qs, rs, ql, rl, glob, k)
            got = _emulate_k2(qs, rs, lens, glob, k, 2, every)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"glob={glob} k={k}")


def test_check_every_is_the_kernels():
    """kernel.py's CHECK_EVERY, the period the schedule test emulates, is
    the constant csrc/myers.cu compiles in."""
    m = re.search(r"constexpr int CHECK_EVERY = (\d+);",
                  K.SOURCE.read_text())
    assert m is not None and int(m.group(1)) == K.CHECK_EVERY


@pytest.mark.gpu
@pytest.mark.parametrize("kname", EDIT)
def test_cuda_kernel_matches_plain(kname):
    """K2 on the card equals its plain version on the same card, at NW 1, 4
    and 16 and every threshold case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K2 is CUDA C++ with no CPU mode)")
    rng = np.random.default_rng(1)
    glob = kname == "edit_distance"
    for Q in (64, 256, 1024):
        qs, rs, ql, rl = _batch(rng, 4, 64, Q, Q)
        dev = "cuda"
        q, r = torch.as_tensor(qs, device=dev), torch.as_tensor(rs, device=dev)
        lens = torch.as_tensor(np.stack([ql, rl], 1), device=dev)
        for k in (-1, 0, Q // 8):
            before = K.launches
            got = K.myers_fill(q, r, lens, glob=glob, k=k)
            assert K.launches == before + 1
            want = K.myers_fill_plain(q, r, lens, glob=glob, k=k)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
