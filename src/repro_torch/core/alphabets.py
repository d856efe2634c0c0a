"""Sequence alphabets (numpy copy of ``repro.core.alphabets``; paper
front-end step 1.1).

DNA/RNA use 2-bit codes (+N), proteins use 24 codes (20 AA + B/Z/X/*),
profiles are frequency vectors, DTW signals are float/complex samples.
"""
from __future__ import annotations

import numpy as np

DNA = "ACGT"
DNA_N = "ACGTN"
PROTEIN = "ARNDCQEGHILKMFPSTWYVBZX*"  # BLOSUM62 ordering

_DNA_LUT = {c: i for i, c in enumerate(DNA_N)}
_PROT_LUT = {c: i for i, c in enumerate(PROTEIN)}


def encode_dna(s: str) -> np.ndarray:
    """DNA string -> uint8 codes (A=0, C=1, G=2, T=3, N=4)."""
    return np.array([_DNA_LUT[c] for c in s.upper().replace("U", "T")],
                    dtype=np.uint8)


def decode_dna(codes) -> str:
    return "".join(DNA_N[int(c)] for c in codes)


def encode_protein(s: str) -> np.ndarray:
    return np.array([_PROT_LUT.get(c, _PROT_LUT["X"]) for c in s.upper()],
                    dtype=np.uint8)


def decode_protein(codes) -> str:
    return "".join(PROTEIN[int(c)] for c in codes)


def revcomp_dna(codes) -> np.ndarray:
    """Reverse complement of 2-bit DNA codes (A<->T, C<->G; N fixed)."""
    out = np.asarray(codes, np.uint8)[::-1]
    return np.where(out < 4, 3 - out, out).astype(np.uint8)


def random_dna(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=(n,)).astype(np.uint8)


def random_protein(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 20, size=(n,)).astype(np.uint8)


def mutate(rng: np.random.Generator, seq: np.ndarray, rate: float,
           n_symbols: int = 4) -> np.ndarray:
    """Apply substitutions/insertions/deletions at the given rate — a cheap
    PBSIM-like read simulator for benchmarks (paper §6.1)."""
    out = []
    for c in seq:
        r = rng.random()
        if r < rate / 3:            # deletion
            continue
        if r < 2 * rate / 3:        # insertion
            out.append(rng.integers(0, n_symbols))
        if r < rate:                # substitution
            out.append((int(c) + 1 + rng.integers(0, n_symbols - 1)) % n_symbols)
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)
