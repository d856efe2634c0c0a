"""Traffic kind ``sites``: genotyping sites as GATK HaplotypeCaller forms
them: a haplotype window, 1-3 alternates with one SNP at its centre, reads
drawn round-robin from the site's genotype, every read against every
haplotype (reads on the query axis).  Sites follow each other across block
boundaries, as a stream of sites cut into fixed batches.

Keys: ``reads_per_site``, ``haplotypes`` ([lo, hi] a site), ``read_len``
and ``hap_len`` ([lo, hi] bases), ``error_rate`` of the reads.
"""
from __future__ import annotations

import numpy as np

from bench import traffic as t


def _site_shapes(traffic, rng, rows: int):
    """(haplotypes, haplotype length, read length) of the pool's sites:
    the fewest sites of a fixed grid that fill ``rows``, permuted by the
    seed but for the last site, which the pool's end cuts the same way
    for every seed."""
    reads = int(traffic["reads_per_site"])
    h_lo, h_hi = traffic["haplotypes"]
    n_h = np.arange(int(h_lo), int(h_hi) + 1)
    cycle = n_h[np.arange(rows) % len(n_h)]
    n = int(np.searchsorted(np.cumsum(cycle * reads), rows)) + 1
    haps = cycle[:n]
    # the length grids in an order of their own, the same for every seed
    fixed = np.random.default_rng(0)
    hap_len = t.grid(n, *traffic["hap_len"], "uniform")[fixed.permutation(n)]
    read_len = t.grid(n, *traffic["read_len"], "uniform")[
        fixed.permutation(n)]
    order = np.concatenate([rng.permutation(n - 1), [n - 1]])
    return haps[order], hap_len[order], read_len[order]


def make(traffic: dict, rng) -> list:
    rows = int(traffic["batch"]) * int(traffic["pool_blocks"])
    reads_per = int(traffic["reads_per_site"])
    rate = float(traffic["error_rate"])
    qs, ql, rs, rl = [], [], [], []
    for n_h, L, m in zip(*_site_shapes(traffic, rng, rows)):
        n_h, L, m = int(n_h), int(L), int(m)
        ref = rng.integers(0, 4, L).astype(np.uint8)
        pos = L // 2
        haps = [ref]
        for a in range(n_h - 1):
            alt = ref.copy()
            alt[pos] = (alt[pos] + 1 + a) % 4
            haps.append(alt)
        genotype = (0, int(rng.integers(0, n_h)))
        lo, hi = max(0, pos - m + 1), min(pos, L - m)
        starts = rng.integers(lo, hi + 1, reads_per)
        src = np.stack(haps)[[genotype[k % 2] for k in range(reads_per)]]
        frags = np.concatenate([src[k, s:s + m]
                                for k, s in enumerate(starts)])
        reads, read_lens = t.mutate(rng, frags, np.full(reads_per, m), rate)
        offs = np.concatenate([[0], np.cumsum(read_lens)])
        for k in range(reads_per):
            for h in haps:
                qs.append(reads[offs[k]:offs[k + 1]])
                ql.append(read_lens[k])
                rs.append(h)
                rl.append(L)
    ql = np.asarray(ql[:rows], np.int64)
    rl = np.asarray(rl[:rows], np.int64)
    return t.blocks(np.concatenate(qs[:rows]), ql, np.concatenate(rs[:rows]),
                    rl, traffic)
