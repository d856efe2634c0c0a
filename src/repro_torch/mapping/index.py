"""Minimizer reference index (mapping stage 1; counterpart of
``repro.mapping.index``).

A minimap2-style (k, w) minimizer sketch in torch ops on the index's device:
k-mers pack into 2-bit codes, run through a murmur3-style integer mixer, and
each w-window keeps its minimum-hash k-mer.  The index is a sorted bucket
table (minimizer hashes sorted with their reference positions), so lookup is
two ``searchsorted`` calls giving a contiguous [lo, hi) occurrence range per
query hash.

Hashes are uint32 values held in int64 tensors.  The k-mer and window
scans are built from ``k`` (or ``w``) shifted slices rather than an
``(L, k)`` index gather, so a bacterial-size reference needs a few arrays
of its own length, not k of them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime import plan as plan_mod

MAX_KMER = 16   # 2 bits/base in a uint32
MASK32 = 0xFFFFFFFF

# k-mers containing ambiguous codes (N = 4) hash to this sentinel: it is the
# uint32 maximum, so window-minimum selection avoids it, and build_index
# drops it from the table.
AMBIG_HASH = 0xFFFFFFFF

_POS_BITS = 31   # positions < 2**31 pack under a hash in one int64 sort key


def _mul32(h, c: int):
    """Low 32 bits of ``h * c`` for uint32 values in int64: ``c`` splits into
    16-bit halves, so no partial product reaches 2**49 and none overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK32


def mix32(h):
    """murmur3 fmix32 finalizer over uint32 values held in an int64 tensor."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kmer_hashes(seq, k: int):
    """(..., L) uint8 codes -> (..., L-k+1) int64 mixed hashes of the packed
    k-mers (``AMBIG_HASH`` where a k-mer holds a code >= 4)."""
    if k > MAX_KMER:
        raise ValueError(f"k={k} exceeds {MAX_KMER} (2-bit packing)")
    codes = seq.long()
    n = codes.shape[-1] - k + 1
    packed = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                         device=codes.device)
    unambig = torch.ones_like(packed, dtype=torch.bool)
    for t in range(k):
        c = codes[..., t:t + n]
        packed |= (c & 3) << (2 * (k - 1 - t))
        unambig &= c < 4
    return torch.where(unambig, mix32(packed), AMBIG_HASH)


def minimizers(seq, k: int, w: int):
    """Per-window minimizers: ``(pos, hash)`` of length L-k-w+2 along the
    last axis.  Window t covers k-mer starts [t, t+w); ``pos[t]`` is the
    leftmost position of its minimum hash (int32)."""
    h = kmer_hashes(seq, k)
    n_win = h.shape[-1] - w + 1
    val = h[..., :n_win]
    arg = torch.zeros_like(val)
    for t in range(1, w):
        cand = h[..., t:t + n_win]
        upd = cand < val                 # strict: the leftmost minimum wins
        val = torch.where(upd, cand, val)
        arg = torch.where(upd, t, arg)
    pos = torch.arange(n_win, device=h.device) + arg
    return pos.to(torch.int32), val


@dataclasses.dataclass(frozen=True)
class MinimizerIndex:
    """Sorted bucket table over one reference sequence.

    ``hashes`` is sorted ascending (uint32 values in int64); ``positions[i]``
    is the reference start of the k-mer behind ``hashes[i]`` (int32).  Both
    live on the device the index was built for.
    """
    k: int
    w: int
    ref_len: int
    hashes: torch.Tensor
    positions: torch.Tensor

    @property
    def n_minimizers(self) -> int:
        return int(self.hashes.shape[0])


def build_index(ref, k: int = 13, w: int = 8, *,
                device="cuda") -> MinimizerIndex:
    """Sketch ``ref`` (uint8 DNA codes) on ``device`` and sort the minimizer
    table by (hash, position)."""
    dev = plan_mod.resolve_device(device)
    ref = torch.as_tensor(np.asarray(ref, np.uint8), device=dev)
    if ref.shape[0] < k + w - 1:
        raise ValueError(f"reference ({ref.shape[0]}) shorter than k+w-1")
    if ref.shape[0] >= 1 << _POS_BITS:
        raise ValueError(f"reference ({ref.shape[0]}) exceeds 2**31 bases")
    pos, h = minimizers(ref, k, w)
    keep = h != AMBIG_HASH              # ambiguous minimizers never match
    # adjacent windows share minimizers: one entry per distinct position
    # (the same position always carries the same hash), in lexsort order
    key = torch.unique((h[keep] << _POS_BITS) | pos[keep].long())
    return MinimizerIndex(
        k=k, w=w, ref_len=int(ref.shape[0]),
        hashes=(key >> _POS_BITS).contiguous(),
        positions=(key & ((1 << _POS_BITS) - 1)).to(torch.int32))


def lookup_range(index: MinimizerIndex, query_hashes):
    """[lo, hi) occurrence range in the sorted table per query hash."""
    lo = torch.searchsorted(index.hashes, query_hashes, side="left")
    hi = torch.searchsorted(index.hashes, query_hashes, side="right")
    return lo, hi
