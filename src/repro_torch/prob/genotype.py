"""Genotyping on the pair-HMM forward likelihood, the GATK core loop
(counterpart of ``repro.prob.genotype``).

Stage 1, evidence: the forward log-likelihood of every (read, haplotype)
pair, batched through ``runtime.dispatch.run_pairs`` (score-only
sum-semiring plans; on the card kernel K1's logsumexp instantiation),
normalized by haplotype length so that alleles compare.

Stage 2, genotype likelihoods: for a ploidy-P genotype G (a multiset of
haplotype indices) each read is an independent draw from a uniform mixture
over G's alleles:

    log P(read | G) = logsumexp_{h in G} ll[read, h] - log P
    log P(reads | G) = sum over reads

Stage 3, calls: phred-scaled PLs (0 at the best genotype), GQ = the
second-best PL, capped at 99.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.runtime import dispatch

from . import kernels as K

MAX_GQ = 99
_LOG10 = float(np.log(10.0))


def read_hap_log_likelihoods(reads: Sequence, haps: Sequence, params=None, *,
                             engine_name: str = "wavefront", block: int = 8,
                             pipeline_depth: int = 2, hap_norm: bool = True,
                             device="cuda") -> np.ndarray:
    """(n_reads, n_haps) forward log-likelihood matrix, all pairs batched.

    ``hap_norm`` subtracts ``log(len(hap))`` per column, the uniform
    free-start normalization that makes haplotypes of different lengths
    comparable.  ``device`` is where the fills run (the card unless
    ``"cpu"`` is asked for)."""
    if params is None:
        params = K.default_params()
    reads = [np.asarray(r, np.uint8) for r in reads]
    haps = [np.asarray(h, np.uint8) for h in haps]
    pairs = [(r, h) for r in reads for h in haps]
    outs = dispatch.run_pairs(K.cached_pairhmm(), params, pairs,
                              engine_name=engine_name, block=block,
                              with_traceback=False,
                              pipeline_depth=pipeline_depth, device=device)
    ll = np.asarray([float(o.score) for o in outs],
                    np.float64).reshape(len(reads), len(haps))
    if hap_norm:
        ll -= np.log([max(len(h), 1) for h in haps])[None, :]
    return ll


def genotypes(n_haps: int, ploidy: int = 2) -> List[Tuple[int, ...]]:
    """All unordered ploidy-sized allele multisets, VCF-style order
    (diploid over [ref, alt]: (0,0), (0,1), (1,1))."""
    return list(itertools.combinations_with_replacement(range(n_haps),
                                                        ploidy))


def genotype_log_likelihoods(ll: np.ndarray, ploidy: int = 2
                             ) -> Tuple[List[Tuple[int, ...]], np.ndarray]:
    """Per-genotype log-likelihoods from a read x haplotype matrix."""
    ll = np.asarray(ll, np.float64)
    gts = genotypes(ll.shape[1], ploidy)
    gl = np.empty((len(gts),), np.float64)
    for k, gt in enumerate(gts):
        per_read = np.logaddexp.reduce(ll[:, list(gt)], axis=1) \
            - np.log(ploidy)
        gl[k] = float(per_read.sum())
    return gts, gl


def call_genotype(ll: np.ndarray, ploidy: int = 2) -> dict:
    """The maximum-likelihood genotype with phred-scaled confidence:
    ``{"GT", "GQ", "PL", "genotypes", "gl"}``."""
    gts, gl = genotype_log_likelihoods(ll, ploidy)
    best = int(np.argmax(gl))
    pl = (10.0 / _LOG10) * (gl[best] - gl)
    rest = np.delete(pl, best)
    gq = int(min(MAX_GQ, round(float(rest.min())))) if rest.size else MAX_GQ
    return {"GT": gts[best], "GQ": gq,
            "PL": [int(round(p)) for p in pl],
            "genotypes": gts, "gl": gl}


def call_site(reads: Sequence, haps: Sequence, params=None, *,
              ploidy: int = 2, engine_name: str = "wavefront",
              block: int = 8, pipeline_depth: int = 2,
              hap_norm: bool = True, device="cuda") -> dict:
    """End-to-end single-site call: likelihood matrix + genotype call."""
    ll = read_hap_log_likelihoods(reads, haps, params,
                                  engine_name=engine_name, block=block,
                                  pipeline_depth=pipeline_depth,
                                  hap_norm=hap_norm, device=device)
    out = call_genotype(ll, ploidy)
    out["ll"] = ll
    return out
