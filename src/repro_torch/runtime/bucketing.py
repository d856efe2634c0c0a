"""Length-bucketed batching (numpy copy of ``repro.runtime.bucketing``):
pad-to-bucket + sort-and-pack scheduling.

The wavefront cost of one alignment is ``Q + R`` scan steps, so padding a
40-base query to a global 256-base shape wastes ~6x the work; padding to
the next power-of-two bucket caps overhead at ~2x worst case while keeping
the number of distinct compiled shapes logarithmic.  ``pack_by_bucket``
groups a mixed-length request stream into fixed-shape batches per bucket
and returns the inverse permutation that restores request order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

DEFAULT_MIN_BUCKET = 16
DEFAULT_GROWTH = 2.0


def max_grid_bucket(max_bucket: int, min_bucket: int = DEFAULT_MIN_BUCKET,
                    growth: float = DEFAULT_GROWTH) -> int:
    """Largest grid bucket ``min_bucket * growth**k <= max_bucket``.

    A cap below the grid's smallest bucket is a configuration error —
    every shape it admitted would be off-grid."""
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")
    if min_bucket > max_bucket:
        raise ValueError(
            f"max_bucket {max_bucket} is below min_bucket {min_bucket}")
    cap = min_bucket
    while True:
        nxt = int(math.ceil(cap * growth))
        if nxt > max_bucket:
            return cap
        cap = nxt


def bucket_length(n: int, min_bucket: int = DEFAULT_MIN_BUCKET,
                  max_bucket: Optional[int] = None,
                  growth: float = DEFAULT_GROWTH) -> int:
    """Smallest bucket ``min_bucket * growth**k >= n``; ``growth=2``
    gives power-of-two buckets.

    ``max_bucket`` snaps *down* to the largest grid bucket <= it, and
    lengths above that snapped cap raise: an off-grid cap (say 100 on the
    16/32/64/128 grid) must never leak an off-grid 100-wide shape into the
    plan cache, silently splitting it per clamped length.
    """
    if n < 0:
        raise ValueError(f"negative length {n}")
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")
    if max_bucket is not None:
        cap = max_grid_bucket(max_bucket, min_bucket, growth)
        if n > cap:
            raise ValueError(
                f"length {n} exceeds largest bucket {cap} "
                f"(max_bucket={max_bucket})")
    b = min_bucket
    while b < n:
        b = int(math.ceil(b * growth))
    return b


def bucket_shape(q_len: int, r_len: int,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_bucket: Optional[int] = None,
                 growth: float = DEFAULT_GROWTH) -> tuple[int, int]:
    """Per-pair bucket: each side rounds up independently."""
    return (bucket_length(q_len, min_bucket, max_bucket, growth),
            bucket_length(r_len, min_bucket, max_bucket, growth))


def pad_to_bucket(arr: np.ndarray, bucket: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``arr`` along ``axis`` up to ``bucket`` elements."""
    n = arr.shape[axis]
    if n > bucket:
        raise ValueError(f"length {n} exceeds bucket {bucket}")
    if n == bucket:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, bucket - n)
    return np.pad(arr, pad)


@dataclasses.dataclass
class Bucket:
    """One fixed-shape batch: requests ``indices`` padded to ``bucket``."""
    bucket: tuple[int, int]          # (q_bucket, r_bucket)
    indices: np.ndarray              # positions in the original stream


def pack_by_bucket(lengths: Sequence[tuple[int, int]],
                   block: Optional[int] = None,
                   min_bucket: int = DEFAULT_MIN_BUCKET,
                   max_bucket: Optional[int] = None,
                   growth: float = DEFAULT_GROWTH
                   ) -> tuple[list[Bucket], np.ndarray]:
    """Sort-and-pack a mixed-length stream into per-bucket batches.

    ``lengths`` is a sequence of ``(q_len, r_len)`` pairs.  Returns
    ``(batches, inv)``: each batch holds at most ``block`` request indices
    sharing one bucket shape; concatenating all ``batch.indices`` gives
    the packed order, and ``inv`` is its inverse permutation —
    ``packed_results[inv[i]]`` is the result of original request ``i``.

    Within a bucket, requests are ordered by descending ``q_len + r_len``
    before chunking, so blocks come out length-homogeneous: the engine's
    early-exit fill stops at the *block max* wavefront, and a sorted
    block's max is its own length scale rather than the bucket's.
    """
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (ql, rl) in enumerate(lengths):
        b = bucket_shape(ql, rl, min_bucket, max_bucket, growth)
        groups.setdefault(b, []).append(i)
    for idx in groups.values():
        idx.sort(key=lambda i: (-(lengths[i][0] + lengths[i][1]), i))
    batches: list[Bucket] = []
    order: list[int] = []
    for b in sorted(groups):
        idx = groups[b]
        step = block or len(idx) or 1
        for k in range(0, len(idx), step):
            chunk = np.asarray(idx[k:k + step], np.int64)
            batches.append(Bucket(bucket=b, indices=chunk))
            order.extend(int(i) for i in chunk)
    return batches, inverse_permutation(np.asarray(order, np.int64))


def inverse_permutation(order: np.ndarray) -> np.ndarray:
    """``inv`` such that ``inv[order[k]] == k``."""
    order = np.asarray(order, np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=np.int64)
    return inv
