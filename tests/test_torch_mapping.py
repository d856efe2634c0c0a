"""The read mapper of the PyTorch port vs the JAX package on the CPU, stage by
stage and end to end: ``mix32`` (inputs at and above 2**31), k-mer hashes and
minimizers over N runs, the minimizer index, seeding and the anchor sort
(beyond 2 Mb), every field of the chaining DP over a batch, the read
simulator, the screen's keep-mask and the extension results, and the SAM text
of ``ReadMapper`` in both gap modes and both filter modes against JAX's
default and reference engines.  Every comparison is exact."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alphabets as jalphabets
from repro.data import synthetic as jsynthetic
from repro.mapping import ReadMapper as JReadMapper
from repro.mapping import chain as jchain
from repro.mapping import extend as jextend
from repro.mapping import index as jindex
from repro.mapping import seed as jseed
from repro_torch.data import synthetic
from repro_torch.mapping import ReadMapper
from repro_torch.mapping import chain, extend, index, seed
from repro_torch.runtime import plan as plan_mod

K, W = 13, 8


def _t(a):
    """A tensor of a copy (JAX hands out read-only arrays); uint32 hashes
    become the int64 the port holds them in."""
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _ref(rng, n, n_runs=((500, 520), (1000, 1003))):
    ref = jalphabets.random_dna(rng, n)
    for a, b in n_runs:
        ref[a:b] = 4
    return ref


def _reads(rng, ref, n_sim=30, n_junk=6, seed_=3):
    rs = synthetic.sample_reads(ref, n_sim, 150, error_rate=0.05,
                                seed=seed_)
    reads = [rs.reads[i, : rs.lens[i]] for i in range(n_sim)]
    return reads + [jalphabets.random_dna(rng, 150) for _ in range(n_junk)]


def test_mix32_matches_including_high_bit_inputs(rng):
    edge = [0, 1, 2**16 - 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1,
            0x85EBCA6B, 0xC2B2AE35]
    vals = np.concatenate([np.asarray(edge, np.uint64),
                           rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    want = np.asarray(jindex.mix32(jnp.asarray(vals.astype(np.uint32))))
    got = index.mix32(_t(vals.astype(np.int64))).numpy()
    assert (vals >= 2**31).sum() > 1000
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_kmer_hashes_and_minimizers_match(rng):
    seqs = np.stack([_ref(rng, 700, ((0, 6), (300, 330))),
                     _ref(rng, 700, ((690, 700),))])
    got_h = index.kmer_hashes(_t(seqs), K).numpy()
    got_pos, got_val = (x.numpy() for x in index.minimizers(_t(seqs), K, W))
    for b, s in enumerate(seqs):
        want_h = np.asarray(jindex.kmer_hashes(jnp.asarray(s), K))
        np.testing.assert_array_equal(got_h[b], want_h)
        assert (want_h == jindex.AMBIG_HASH).any()
        pos, val = jindex.minimizers(jnp.asarray(s), K, W)
        np.testing.assert_array_equal(got_pos[b], np.asarray(pos))
        np.testing.assert_array_equal(got_val[b], np.asarray(val))


def test_build_index_and_lookup_match(rng):
    ref = _ref(rng, 20000)
    want = jindex.build_index(ref, k=K, w=W)
    got = index.build_index(ref, k=K, w=W, device="cpu")
    np.testing.assert_array_equal(got.hashes.numpy(), np.asarray(want.hashes))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    assert got.n_minimizers == want.n_minimizers and got.ref_len == 20000
    probe = np.asarray(want.hashes)[::37]
    for g, w in zip(index.lookup_range(got, _t(probe)),
                    jindex.lookup_range(want, jnp.asarray(probe))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _padded(reads, bucket):
    out = np.zeros((len(reads), bucket), np.uint8)
    lens = np.zeros((len(reads),), np.int32)
    for i, r in enumerate(reads):
        out[i, : len(r)] = r
        lens[i] = len(r)
    return out, lens


def _seed_batch(rng):
    ref = _ref(rng, 8192)
    reads = [ref[700:850], ref[3000:3060], jalphabets.revcomp_dna(
        ref[5000:5140]), jalphabets.random_dna(rng, 150)]
    reads += _reads(rng, ref, 4, 0, seed_=7)
    return ref, *_padded(reads, 256)


def _jax_seed(jidx, reads, lens, n_anchors=192):
    def one(read, n):
        q, r, v = jseed.seed_anchors(jidx, read, n)
        return (q, r, v), jseed.top_anchors(q, r, v, n_anchors)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(one))(jnp.asarray(reads),
                                           jnp.asarray(lens)))


def test_seed_and_top_anchors_match(rng):
    ref, reads, lens = _seed_batch(rng)
    jidx = jindex.build_index(ref, k=K, w=W)
    idx = index.build_index(ref, k=K, w=W, device="cpu")
    want_seed, want_top = _jax_seed(jidx, reads, lens)
    got_seed = seed.seed_anchors(idx, _t(reads), _t(lens))
    got_top = seed.top_anchors(*got_seed, 192)
    for g, w in zip(got_seed + got_top, want_seed + want_top):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want_seed[2].sum() > 20


def test_top_anchors_exact_order_beyond_2mb(rng):
    r = np.asarray([3_000_000, 10, 2_500_000, 3_000_000, 7], np.int32)
    q = np.asarray([5, 3, 7, 2, 9], np.int32)
    v = np.asarray([True, True, True, True, False])
    big_r = rng.integers(2**30, 2**31 - 1, 64).astype(np.int32)
    big_r[::4] = big_r[1::4]                       # ties on r, broken by q
    big_q = rng.integers(0, 2**31 - 1, 64).astype(np.int32)
    big_v = rng.random(64) < 0.8
    for qq, rr, vv, n in ((q, r, v, 5), (big_q, big_r, big_v, 48)):
        want = [np.asarray(x) for x in jseed.top_anchors(
            jnp.asarray(qq), jnp.asarray(rr), jnp.asarray(vv), n)]
        got = seed.top_anchors(_t(qq)[None], _t(rr)[None], _t(vv)[None], n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), w)
    assert got[1][0].numpy()[:4].tolist() == sorted(big_r[big_v])[:4]


def test_chain_anchors_every_field(rng):
    ref, reads, lens = _seed_batch(rng)
    jidx = jindex.build_index(ref, k=K, w=W)
    _, top = _jax_seed(jidx, reads, lens, n_anchors=64)
    q, r, v = (np.array(x) for x in top)
    # hand-made rows: a co-linear run among noise, a drifting diagonal, and
    # no valid anchor at all
    colin = np.arange(10, 80, 10, dtype=np.int32)
    q[0, :7], r[0, :7], v[0, :7] = colin, colin + 500, True
    q[1, :4] = [10, 30, 50, 70]
    r[1, :4] = [110, 132, 151, 173]
    v[1, :] = False
    v[1, :4] = True
    v[2, :] = False
    q, r, v = (np.asarray(x) for x in jax.vmap(
        lambda a, b, c: jseed.top_anchors(a, b, c, 64))(q, r, v))
    want = jax.jit(jax.vmap(lambda a, b, c, n: jchain.chain_anchors(
        a, b, c, K, n)))(q, r, v, lens)
    got = chain.chain_anchors(_t(q), _t(r), _t(v), K, _t(lens))
    for f in chain.ChainResult._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.n_anchors[0]) >= 6 and float(got.score[2]) < 0


def test_sample_reads_same_seed():
    ref = jalphabets.random_dna(np.random.default_rng(5), 4096)
    for s in (3, 11):
        want = jsynthetic.sample_reads(ref, 12, 150, error_rate=0.08, seed=s)
        got = synthetic.sample_reads(ref, 12, 150, error_rate=0.08, seed=s)
        for f in ("reads", "lens", "pos", "strand"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _jobs(rng, ref):
    jobs = []
    for i, read in enumerate(_reads(rng, ref, 10, 3, seed_=5)):
        start = int(rng.integers(0, len(ref) - 260))
        if i < 10:           # a window around the read's true origin
            hits = [p for p in range(0, len(ref) - 150)
                    if np.array_equal(ref[p:p + 20], read[:20])]
            start = max(hits[0] - 40, 0) if hits else start
        jobs.append((read, start, ref[start:start + 230],
                     [32, 64, 128][i % 3]))
    return ([jextend.ExtendJob(*j) for j in jobs],
            [extend.ExtendJob(*j) for j in jobs])


@pytest.mark.parametrize("gap_mode", ["linear", "affine"])
def test_screen_and_extend_jobs_match(gap_mode, rng):
    ref = jalphabets.random_dna(rng, 8192)
    jjobs, jobs = _jobs(rng, ref)
    keep = extend.screen_jobs(jobs, block=8, device="cpu")
    assert keep == jextend.screen_jobs(jjobs, block=8)
    assert 0 < sum(keep) < len(keep)
    got = extend.extend_jobs(jobs, block=4, gap_mode=gap_mode, device="cpu")
    for engine in ("wavefront", "reference"):
        assert got == jextend.extend_jobs(jjobs, engine_name=engine, block=4,
                                          gap_mode=gap_mode)


@pytest.mark.parametrize("filter_mode", ["myers", "off"])
@pytest.mark.parametrize("gap_mode", ["linear", "affine"])
def test_read_mapper_sam_matches_jax(gap_mode, filter_mode):
    rng = np.random.default_rng(0)
    ref = jalphabets.random_dna(rng, 8192)
    reads = _reads(rng, ref)
    mapper = ReadMapper(ref, gap_mode=gap_mode, filter_mode=filter_mode,
                        device="cpu")
    got = mapper.to_sam(mapper.map_reads(reads))
    assert sum(line.split("\t")[1] in ("0", "16")
               for line in got.splitlines()) >= 28
    for engine in ("wavefront", "reference"):
        jmapper = JReadMapper(ref, gap_mode=gap_mode,
                              filter_mode=filter_mode, engine_name=engine)
        assert got == jmapper.to_sam(jmapper.map_reads(reads)), engine


def test_mapper_device_rule_and_plan_reuse(rng, monkeypatch):
    ref = jalphabets.random_dna(rng, 8192)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReadMapper(ref)
    mapper = ReadMapper(ref, device="cpu")
    rs = synthetic.sample_reads(ref, 12, 150, error_rate=0.05, seed=5)
    plan_mod.clear_plan_cache()
    first = mapper.map_reads(rs.reads, rs.lens)
    size = plan_mod.plan_cache_info()["size"]
    assert size >= 2                          # screen and extension plans
    rs2 = synthetic.sample_reads(ref, 12, 150, error_rate=0.05, seed=6)
    mapper.map_reads(torch.as_tensor(rs2.reads), rs2.lens)
    info = plan_mod.plan_cache_info()
    assert info["size"] == size and info["hits"] > 0
    engines = {key.engine for key in info["keys"]}
    assert engines == {"myers", "wavefront"}
    hits = sum(rec.is_mapped and abs(rec.pos - 1 - int(p)) <= 5
               for rec, p in zip(first, rs.pos))
    assert hits >= 11
