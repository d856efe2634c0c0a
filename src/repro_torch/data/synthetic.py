"""Deterministic read simulation (numpy copy of ``ReadSet`` and
``sample_reads`` from ``repro.data.synthetic``): the same seed gives the
same reads as the JAX package's simulator."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import alphabets


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
