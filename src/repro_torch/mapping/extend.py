"""Banded extension (mapping stage 4; counterpart of ``repro.mapping.extend``):
chains -> base-level alignments, behind the bit-parallel screen.

Each surviving chain defines an extension job: a reference window (the chain
span plus ``margin`` slack on both sides) and a band wide enough for the
chain's diagonal range plus indel drift.  The alignment is the zoo's
semiglobal kernel (the read end to end against a reference substring) with a
per-chain band, through ``runtime.dispatch.run_pairs`` on kernel K1.  Bands
quantize to power-of-two buckets, so the number of distinct specs, and of
plans, stays logarithmic in the observed diagonal spreads.

``gap_mode`` selects the scoring: ``'linear'`` (the zoo's semiglobal kernel)
or ``'affine'`` (semiglobal Gotoh).  ``screen_jobs`` is rung 1 of the filter
ladder: the thresholded ``edit_search`` kernel on the ``myers`` engine
(kernel K2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.kernels_zoo import dna_affine, dna_linear
from repro_torch.core.kernels_zoo import edit as edit_kernel
from repro_torch.runtime import bucketing, dispatch

from . import chain as chain_mod
from . import sam as sam_mod

# one scoring-param set per gap mode (the mapq/score gates in pipeline.py
# read the match bonus via ``match_bonus``)
EXTEND_PARAMS = dna_linear.default_params()
AFFINE_EXTEND_PARAMS = dna_affine.default_params()

GAP_MODES = ("linear", "affine")

# (band, gap_mode) -> (spec, params); one spec object per key keeps the plan
# cache keyed correctly (distinct spec constructions never share plans)
_SPECS: dict[tuple, tuple] = {}


def extension_spec(band: int, gap_mode: str = "linear"):
    key = (band, gap_mode)
    if key not in _SPECS:
        if gap_mode == "linear":
            _SPECS[key] = (dna_linear.semiglobal(band=band), EXTEND_PARAMS)
        elif gap_mode == "affine":
            _SPECS[key] = (dna_affine.semiglobal_affine(band=band),
                           AFFINE_EXTEND_PARAMS)
        else:
            raise ValueError(
                f"unknown gap_mode {gap_mode!r}; have {GAP_MODES}")
    return _SPECS[key]


def match_bonus(gap_mode: str = "linear") -> float:
    """Per-base match score of a gap mode (drives the extension-score gate
    in pipeline.py)."""
    params = AFFINE_EXTEND_PARAMS if gap_mode == "affine" else EXTEND_PARAMS
    return float(params["match"])


# the screen kernel: one module-level spec object, so every screen batch
# lands on the same plan-cache keys
SCREEN_SPEC = edit_kernel.edit_search()


def screen_jobs(jobs: list, *, k_frac: float = 0.35,
                engine_name: str = "myers", block: int = 64,
                pipeline_depth: int = 2, device="cuda") -> list:
    """Bit-parallel pre-filter over extension jobs; ``True`` = survivor.

    A placement whose best edit distance exceeds ``ceil(k_frac * read_len)``
    cannot pass the extension-score gate, so full DP never runs on it.  One
    engine-side threshold (the batch maximum) keeps a single plan per
    bucket; the exact per-job cut is applied on the host.
    """
    if not jobs:
        return []
    ks = [int(np.ceil(k_frac * len(j.read))) for j in jobs]
    params = edit_kernel.default_params(max(ks))
    pairs = [(j.read, j.window) for j in jobs]
    outs = dispatch.run_pairs(SCREEN_SPEC, params, pairs,
                              engine_name=engine_name, block=block,
                              with_traceback=False,
                              pipeline_depth=pipeline_depth, device=device)
    return [float(o.score) <= k for o, k in zip(outs, ks)]


@dataclasses.dataclass
class ExtendJob:
    """One read (strand-corrected, trimmed) and its reference window."""
    read: np.ndarray
    win_start: int
    window: np.ndarray
    band: int


def make_job(ref: np.ndarray, read: np.ndarray, ch: chain_mod.ChainResult,
             k: int, *, margin: int = 32,
             min_band: int = 32) -> Optional[ExtendJob]:
    """Extension window and band for one chained read (host-side ints)."""
    ref_len = len(ref)
    read_len = len(read)
    q_start, q_end = int(ch.q_start), int(ch.q_end)
    r_start, r_end = int(ch.r_start), int(ch.r_end)
    d_span = int(ch.d_max) - int(ch.d_min)
    start = max(r_start - q_start - margin, 0)
    end = min(r_end + (read_len - q_end) + margin, ref_len)
    if end - start < read_len // 2:
        return None
    # |i - j| along the true path <= window offset + chain skew + drift
    need = (r_start - q_start - start) + d_span + margin
    band = bucketing.bucket_length(need, min_bucket=min_band)
    return ExtendJob(read=read, win_start=start, window=ref[start:end],
                     band=band)


def extend_jobs(jobs: list, *, engine_name: str = "wavefront",
                block: int = 8, pipeline_depth: int = 2,
                gap_mode: str = "linear", device="cuda") -> list:
    """Run all extension jobs; returns per-job dicts in input order.

    Jobs group by band (one semiglobal spec each), and within a band by
    length bucket through the runtime's packed dispatch.
    """
    results: list = [None] * len(jobs)
    by_band: dict[int, list[int]] = {}
    for i, job in enumerate(jobs):
        by_band.setdefault(job.band, []).append(i)
    for band, idxs in sorted(by_band.items()):
        spec, params = extension_spec(band, gap_mode)
        pairs = [(jobs[i].read, jobs[i].window) for i in idxs]
        outs = dispatch.run_pairs(spec, params, pairs,
                                  engine_name=engine_name, block=block,
                                  with_traceback=True,
                                  pipeline_depth=pipeline_depth,
                                  device=device)
        for i, aln in zip(idxs, outs):
            job = jobs[i]
            results[i] = {
                "score": float(aln.score),
                # the path starts at cell (0, j0): read base 1 aligns after
                # window offset j0 -> 0-based genome position
                "pos": job.win_start + int(aln.start_j),
                "cigar": sam_mod.moves_to_sam_cigar(aln.moves, aln.n_moves),
            }
    return results
