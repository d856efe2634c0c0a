"""Deterministic synthetic data (numpy copy of ``LMBatcher``, ``ReadSet``,
``sample_reads``, ``GenotypingSite`` and ``sample_site`` from
``repro.data.synthetic``): the same seed gives the same token batches,
reads and haplotypes as the JAX package's generators."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core import alphabets


@dataclasses.dataclass
class LMBatcher:
    """Infinite deterministic batch stream of next-token-predictable data.

    Tokens live in an ``active_vocab``-sized subset so the bigram structure
    is learnable within a few hundred steps regardless of the model's full
    vocabulary (entropy floor ~= 0.9*ln(8) + 0.1*ln(active_vocab)).
    """
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    frontend: Optional[str] = None   # None | vlm | audio
    d_model: int = 0
    prefix: int = 0                  # multimodal prefix length
    active_vocab: int = 0            # 0 -> min(vocab, 256)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        A = self.active_vocab or min(self.vocab, 256)
        # sparse deterministic bigram table: token -> 8 likely successors
        succ = rng.integers(0, A, size=(A, 8))
        while True:
            toks = np.empty((self.batch, self.seq), np.int32)
            cur = rng.integers(0, A, size=self.batch)
            for t in range(self.seq):
                toks[:, t] = cur
                pick = rng.integers(0, 8, size=self.batch)
                nxt = succ[cur, pick]
                noise = rng.random(self.batch) < 0.1
                cur = np.where(noise, rng.integers(0, A, self.batch), nxt)
            out = {"tokens": toks}
            if self.frontend == "vlm":
                out["prefix_embeds"] = rng.normal(
                    size=(self.batch, self.prefix, self.d_model)
                ).astype(np.float32) * 0.02
            elif self.frontend == "audio":
                out["frames"] = rng.normal(
                    size=(self.batch, self.prefix or self.seq, self.d_model)
                ).astype(np.float32) * 0.02
            yield out


@dataclasses.dataclass
class ReadSet:
    """Simulated reads with ground truth.

    ``reads`` is ``(n, max_len)`` zero-padded uint8 codes as sequenced
    (reverse-complemented where ``strand`` is True); ``pos`` is the 0-based
    leftmost reference coordinate of the source fragment, the SAM-style truth
    a mapper should recover on either strand.
    """
    reads: np.ndarray     # (n, max_len) uint8, zero-padded
    lens: np.ndarray      # (n,) int32 effective lengths
    pos: np.ndarray       # (n,) int64 true 0-based leftmost ref position
    strand: np.ndarray    # (n,) bool, True = reverse-complement read


def sample_reads(ref, n: int, length: int, error_rate: float = 0.05,
                 seed: int = 0, revcomp_frac: float = 0.5) -> ReadSet:
    """Fragments of ``length`` bases drawn uniformly from ``ref``, mutated
    with substitutions, insertions and deletions at ``error_rate``
    (``alphabets.mutate``) and reverse-complemented with probability
    ``revcomp_frac``."""
    rng = np.random.default_rng(seed)
    ref = np.asarray(ref, np.uint8)
    if len(ref) < length:
        raise ValueError(f"reference ({len(ref)}) shorter than read {length}")
    raw, pos, strand = [], [], []
    for _ in range(n):
        p = int(rng.integers(0, len(ref) - length + 1))
        read = alphabets.mutate(rng, ref[p: p + length], error_rate)
        rev = bool(rng.random() < revcomp_frac)
        if rev:
            read = alphabets.revcomp_dna(read)
        raw.append(read)
        pos.append(p)
        strand.append(rev)
    max_len = max(len(r) for r in raw)
    reads = np.zeros((n, max_len), np.uint8)
    lens = np.zeros((n,), np.int32)
    for i, r in enumerate(raw):
        reads[i, : len(r)] = r
        lens[i] = len(r)
    return ReadSet(reads=reads, lens=lens, pos=np.asarray(pos, np.int64),
                   strand=np.asarray(strand, bool))


@dataclasses.dataclass
class GenotypingSite:
    """One simulated variant site with ground truth.

    ``haplotypes[0]`` is the reference allele; each further haplotype
    carries one SNP near the window center.  ``reads`` are error-carrying
    fragments drawn from the alleles of the true ``genotype`` (every read
    covers the variant position, so each is informative evidence).
    """
    haplotypes: list           # list[np.ndarray uint8]
    reads: list                # list[np.ndarray uint8]
    genotype: tuple            # true allele indices, e.g. (0, 1)
    variant_pos: int           # SNP offset within the haplotype window


def sample_site(seed: int = 0, hap_len: int = 64, read_len: int = 32,
                n_reads: int = 12, error_rate: float = 0.02,
                genotype: tuple = (0, 1), n_alts: int = 1) -> GenotypingSite:
    """Deterministic single-site genotyping scenario: a reference haplotype
    window, ``n_alts`` SNP-carrying alternates, and reads sampled
    round-robin from the true genotype's alleles with substitutions and
    indels at ``error_rate``."""
    rng = np.random.default_rng(seed)
    if read_len > hap_len:
        raise ValueError(f"read_len {read_len} exceeds hap_len {hap_len}")
    if not 1 <= n_alts <= 3:
        # the SNP draws a distinct base mod 4; a 4th alt would wrap back
        # onto the reference allele
        raise ValueError(f"n_alts must be in [1, 3], got {n_alts}")
    ref_hap = alphabets.random_dna(rng, hap_len)
    pos = hap_len // 2
    haps = [ref_hap]
    for a in range(n_alts):
        alt = ref_hap.copy()
        alt[pos] = (alt[pos] + 1 + a) % 4
        haps.append(alt)
    if any(g >= len(haps) for g in genotype):
        raise ValueError(f"genotype {genotype} names a missing haplotype")
    # starts that keep the variant position inside the read window
    lo = max(0, pos - read_len + 1)
    hi = min(pos, hap_len - read_len)
    reads = []
    for i in range(n_reads):
        allele = haps[genotype[i % len(genotype)]]
        s = int(rng.integers(lo, hi + 1))
        reads.append(alphabets.mutate(rng, allele[s: s + read_len],
                                      error_rate))
    return GenotypingSite(haplotypes=haps, reads=reads, genotype=genotype,
                          variant_pos=pos)
