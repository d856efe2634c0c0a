"""The ReadMapper facade (counterpart of ``repro.mapping.pipeline``): seed ->
chain -> screen -> extend -> SAM records.

The index, seeding and chaining run as tensor code on the mapper's device;
reads of one length bucket go through them together, padded with dummy rows
of length ``k`` up to a power of two of at least ``block`` rows (the shapes
the JAX package compiles once each; a dummy row changes no other row's
result).  Both strands are chained, the better one is extended.  The screen
runs kernel K2 and the banded semiglobal extension kernel K1, both through
the shared plan cache.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import alphabets
from repro_torch.runtime import bucketing
from repro_torch.runtime import plan as plan_mod

from . import chain as chain_mod
from . import extend as extend_mod
from . import index as index_mod
from . import sam as sam_mod
from . import seed as seed_mod


def seed_chain_batch(index, reads, lens, *, max_hits, max_occ, n_anchors,
                     max_dist, max_skew) -> chain_mod.ChainResult:
    """Stages 2+3 over a padded batch of reads (B, L) on the index's
    device."""
    q, r, v = seed_mod.seed_anchors(index, reads, lens, max_hits=max_hits,
                                    max_occ=max_occ)
    q, r, v = seed_mod.top_anchors(q, r, v, n_anchors)
    return chain_mod.chain_anchors(q, r, v, index.k, lens,
                                   max_dist=max_dist, max_skew=max_skew)


def mapq_from_chains(f1: float, f2: float, n_anchors: int) -> int:
    """minimap2-style mapping quality from the chain-score gap."""
    if f1 <= 0:
        return 0
    frac = max(0.0, 1.0 - max(f2, 0.0) / f1)
    return int(min(60.0, 60.0 * frac * min(1.0, n_anchors / 10.0)))


class ReadMapper:
    """Seed-and-extend read mapper over one reference sequence.

    >>> mapper = ReadMapper(ref_codes)            # uint8 DNA codes
    >>> records = mapper.map_reads(reads, lens)   # list[SamRecord]

    ``device`` defaults to ``"cuda"``; without a CUDA device the mapper
    raises unless given ``device="cpu"``.
    """

    def __init__(self, ref, *, k: int = 13, w: int = 8, margin: int = 32,
                 block: int = 8, n_anchors: int = 192, max_hits: int = 8,
                 max_occ: int = 64, max_dist: int = 512, max_skew: int = 64,
                 min_chain_score: float = 12.0,
                 min_extend_frac: float = 0.25,
                 engine_name: str = "wavefront", rname: str = "ref",
                 pipeline_depth: int = 2, gap_mode: str = "linear",
                 filter_mode: str = "myers", filter_k_frac: float = 0.35,
                 filter_engine: str = "myers", screen_block: int = 64,
                 device="cuda"):
        self.device = plan_mod.resolve_device(device)
        self.ref = np.asarray(ref, np.uint8)
        self.index = index_mod.build_index(self.ref, k=k, w=w,
                                           device=self.device)
        self.margin = margin
        self.block = block
        # a single exact k-mer anchor passes the chain gate (score = k);
        # the extension-score gate rejects impostor placements
        self.min_chain_score = min_chain_score
        self.min_extend_frac = min_extend_frac
        self.engine_name = engine_name
        self.rname = rname
        self.pipeline_depth = pipeline_depth
        if gap_mode not in extend_mod.GAP_MODES:
            raise ValueError(
                f"unknown gap_mode {gap_mode!r}; have {extend_mod.GAP_MODES}")
        self.gap_mode = gap_mode
        # filter ladder: 'myers' screens every extension candidate with the
        # thresholded bit-parallel edit_search before full DP runs ('off' =
        # extend every candidate)
        if filter_mode not in ("myers", "off"):
            raise ValueError(
                f"unknown filter_mode {filter_mode!r}; have ('myers', 'off')")
        self.filter_mode = filter_mode
        self.filter_k_frac = filter_k_frac
        self.filter_engine = filter_engine
        self.screen_block = plan_mod.validate_pow2_option(
            "screen_block", screen_block)
        self._chain_opts = dict(max_hits=max_hits, max_occ=max_occ,
                                n_anchors=n_anchors, max_dist=max_dist,
                                max_skew=max_skew)
        # reads pad to at least one full minimizer window
        self._read_min_bucket = bucketing.bucket_length(k + w)

    # -- input normalization ------------------------------------------------
    def _as_read_list(self, reads, lens):
        """Accept a padded (N, L) array or tensor, or a list of reads;
        ``lens`` trims padding in either form."""
        if isinstance(reads, torch.Tensor):
            reads = reads.cpu().numpy()
        if not isinstance(reads, (list, tuple)):
            reads = np.asarray(reads)
        read_list = [np.asarray(r, np.uint8) for r in reads]
        if lens is not None:
            read_list = [r[: int(n)] for r, n in zip(read_list, lens)]
        return read_list

    # -- stages 2+3: batched seed + chain, both strands ---------------------
    def _chain_reads(self, read_list):
        """Per-read (fwd ChainResult, rc ChainResult) of host scalars."""
        n = len(read_list)
        fwd_rows: list = [None] * n
        rc_rows: list = [None] * n
        groups: dict[int, list[int]] = {}
        for i, r in enumerate(read_list):
            b = bucketing.bucket_length(len(r),
                                        min_bucket=self._read_min_bucket)
            groups.setdefault(b, []).append(i)
        for b, idxs in sorted(groups.items()):
            rows = max(self.block, 2 ** int(np.ceil(np.log2(len(idxs)))))
            fwd = np.zeros((rows, b), np.uint8)
            rc = np.zeros((rows, b), np.uint8)
            lens = np.full((rows,), self.index.k, np.int32)  # dummy rows
            for row, i in enumerate(idxs):
                r = read_list[i]
                fwd[row, : len(r)] = r
                rc[row, : len(r)] = alphabets.revcomp_dna(r)
                lens[row] = len(r)
            lens_t = torch.as_tensor(lens, device=self.device)
            for reads, out in ((fwd, fwd_rows), (rc, rc_rows)):
                ch = seed_chain_batch(
                    self.index, torch.as_tensor(reads, device=self.device),
                    lens_t, **self._chain_opts)
                host = [x.cpu().numpy() for x in ch]
                for row, i in enumerate(idxs):
                    out[i] = chain_mod.ChainResult(*(x[row] for x in host))
        return fwd_rows, rc_rows

    # -- host: strand choice, chain gate, extension jobs --------------------
    def _plan_jobs(self, read_list, names, fwd_rows, rc_rows):
        """(jobs, job_meta, records): one extension job per read that passes
        the chain gate; records hold the unmapped reads so far."""
        jobs: list = []
        job_meta: list = []          # (record index, flag, seq, mapq, f1)
        records: list = [None] * len(read_list)
        for i, read in enumerate(read_list):
            cf, cr = fwd_rows[i], rc_rows[i]
            use_rc = float(cr.score) > float(cf.score)
            ch = cr if use_rc else cf
            other = cf if use_rc else cr
            f1 = float(ch.score)
            f2 = max(float(ch.score2), max(float(other.score), 0.0))
            if f1 < self.min_chain_score:
                records[i] = sam_mod.unmapped(names[i], read)
                continue
            oriented = alphabets.revcomp_dna(read) if use_rc else read
            job = extend_mod.make_job(self.ref, oriented, ch, self.index.k,
                                      margin=self.margin)
            if job is None:
                records[i] = sam_mod.unmapped(names[i], read)
                continue
            mapq = mapq_from_chains(f1, f2, int(ch.n_anchors))
            flag = sam_mod.FLAG_REVERSE if use_rc else 0
            jobs.append(job)
            job_meta.append((i, flag, oriented, mapq, f1))
        return jobs, job_meta, records

    def _screen(self, jobs, job_meta, records, read_list, names):
        """Ladder rung 1: the survivors of the bit-parallel screen (K2);
        rejected reads become unmapped records."""
        keep = extend_mod.screen_jobs(
            jobs, k_frac=self.filter_k_frac, engine_name=self.filter_engine,
            block=self.screen_block, pipeline_depth=self.pipeline_depth,
            device=self.device)
        kept_jobs, kept_meta = [], []
        for job, meta, ok in zip(jobs, job_meta, keep):
            if ok:
                kept_jobs.append(job)
                kept_meta.append(meta)
            else:
                i = meta[0]
                records[i] = sam_mod.unmapped(names[i], read_list[i])
        return kept_jobs, kept_meta

    def _extend(self, jobs):
        return extend_mod.extend_jobs(jobs, engine_name=self.engine_name,
                                      block=self.block,
                                      pipeline_depth=self.pipeline_depth,
                                      gap_mode=self.gap_mode,
                                      device=self.device)

    def _emit(self, ext, job_meta, records, read_list, names):
        """SAM records of the extended jobs, behind the extension-score
        gate: a true placement scores near match * read_len, impostors fall
        far below the fraction threshold."""
        match = extend_mod.match_bonus(self.gap_mode)
        for (i, flag, oriented, mapq, f1), res in zip(job_meta, ext):
            max_score = match * len(oriented)
            if res["score"] < self.min_extend_frac * max_score:
                records[i] = sam_mod.unmapped(names[i], read_list[i])
                continue
            records[i] = sam_mod.SamRecord(
                qname=names[i], flag=flag, rname=self.rname,
                pos=res["pos"] + 1, mapq=mapq, cigar=res["cigar"],
                seq=alphabets.decode_dna(oriented),
                score=res["score"], chain_score=f1)
        return records

    # -- the full pipeline --------------------------------------------------
    def map_reads(self, reads, lens=None,
                  names: Optional[Sequence[str]] = None):
        """Map a batch of reads; returns one SamRecord per read, in order."""
        read_list = self._as_read_list(reads, lens)
        if names is None:
            names = [f"read{i}" for i in range(len(read_list))]
        fwd_rows, rc_rows = self._chain_reads(read_list)
        jobs, job_meta, records = self._plan_jobs(read_list, names,
                                                  fwd_rows, rc_rows)
        if self.filter_mode == "myers" and jobs:
            jobs, job_meta = self._screen(jobs, job_meta, records, read_list,
                                          names)
        ext = self._extend(jobs)
        return self._emit(ext, job_meta, records, read_list, names)

    def to_sam(self, records) -> str:
        lines = [sam_mod.sam_header(self.rname, len(self.ref))]
        lines += [r.to_line() + "\n" for r in records]
        return "".join(lines)
