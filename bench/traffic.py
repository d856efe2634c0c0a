"""The one traffic generator: a pool of padded blocks from a traffic file.

A traffic file (``traffic/<name>.json``) names its ``kind``, the generator
``traffic_kinds/<kind>.py`` whose ``make(traffic, rng)`` returns the
pool's blocks, and the parameters of that kind; a new mix of a known kind
is a new data file, and a new kind a new file beside the others.  Every
seed gets the same multiset of sizes in another order (window lengths and
site shapes come from a fixed grid of quantiles that the seed permutes),
so the seed changes the sequences and not the amount of work.

Common keys: ``kind``, ``entry`` (the program's call the window drives,
``entries/<entry>.py``), ``batch`` (pairs a call), ``bucket`` ([query,
reference] padded lengths), ``pool_blocks`` (distinct blocks the window
cycles through), ``check_pairs`` (pool pairs the reference checks, drawn
from the seed; 0 = all) and ``with_traceback``.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np

from bench import BENCH, load_module


@dataclasses.dataclass
class Block:
    """One call's inputs: codes padded to the bucket, effective lengths."""
    queries: np.ndarray      # (batch, Q) uint8
    refs: np.ndarray         # (batch, R) uint8
    q_lens: np.ndarray       # (batch,) int32
    r_lens: np.ndarray       # (batch,) int32

    @property
    def live_cells(self) -> int:
        return int(np.dot(self.q_lens.astype(np.int64),
                          self.r_lens.astype(np.int64)))


def mutate(rng, seqs: np.ndarray, lens: np.ndarray, rate: float,
           n_symbols: int = 4):
    """Edit every base of the concatenated sequences ``seqs`` (segment
    lengths ``lens``) at ``rate``, as ``repro_torch.core.alphabets.mutate``
    does base by base: a draw under rate/3 deletes the base; under 2 rate/3
    inserts a random base and then substitutes the base; under rate
    substitutes it.  Returns the concatenated results and their lengths."""
    seqs = np.asarray(seqs, np.uint8)
    n = seqs.shape[0]
    r = rng.random(n, np.float32)
    dele = r < rate / 3
    ins = np.flatnonzero(~dele & (r < 2 * rate / 3))
    sub = np.flatnonzero(~dele & (r < rate))       # insertions included
    sub_val = ((seqs[sub] + 1 + rng.integers(0, n_symbols - 1, sub.size,
                                             np.uint8)) % n_symbols
               ).astype(np.uint8)
    count = np.ones(n, np.int64)
    count[dele] = 0
    count[ins] = 2
    end = np.cumsum(count)
    out = np.empty(int(end[-1]) if n else 0, np.uint8)
    start = end - count
    first = seqs.copy()
    first[sub] = sub_val
    first[ins] = rng.integers(0, n_symbols, ins.size, np.uint8)
    keep = ~dele
    out[start[keep]] = first[keep]
    # an insertion writes its random base, then the substituted base
    out[start[ins] + 1] = sub_val[np.searchsorted(sub, ins)]
    seg_end = np.cumsum(lens)
    new_lens = np.diff(np.concatenate([[0], end[seg_end - 1]])) if n else \
        np.zeros_like(lens)
    return out, new_lens.astype(np.int64)


def pad(concat: np.ndarray, lens: np.ndarray, width: int) -> np.ndarray:
    """Rows of ``width`` holding the concatenated segments, zero-padded."""
    out = np.zeros((lens.shape[0], width), np.uint8)
    out[np.arange(width)[None, :] < lens[:, None]] = concat
    return out


def segments(src: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """``src[s:s+l]`` for every (s, l), concatenated."""
    offs = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                     lens)
    return src[np.arange(int(lens.sum())) + offs]


def truncate(concat, lens, cap):
    """Each segment cut to at most ``cap``."""
    if lens.max(initial=0) <= cap:
        return concat, lens
    kept = np.minimum(lens, cap)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return segments(concat, starts, kept), kept


def grid(n: int, lo: int, hi: int, dist: str) -> np.ndarray:
    """``n`` integer lengths in [lo, hi] at the quantiles (k + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    if dist == "uniform":
        v = lo + np.floor(u * (hi - lo + 1))
    elif dist == "loguniform":
        v = np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1)
                                                 - math.log(lo))))
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(v, lo, hi).astype(np.int64)


def blocks(qs, ql, rs, rl, traffic) -> list:
    batch = int(traffic["batch"])
    Q, R = (int(x) for x in traffic["bucket"])
    if ql.max() > Q or rl.max() > R:
        raise ValueError(f"a pair ({int(ql.max())}, {int(rl.max())}) "
                         f"exceeds the bucket {Q} x {R}")
    q_pad, r_pad = pad(qs, ql, Q), pad(rs, rl, R)
    return [Block(q_pad[b:b + batch], r_pad[b:b + batch],
                  ql[b:b + batch].astype(np.int32),
                  rl[b:b + batch].astype(np.int32))
            for b in range(0, ql.shape[0], batch)]


def make_pool(traffic: dict, seed: int, bench_dir: Path = BENCH) -> list:
    """The pool of distinct blocks a cell's window cycles through, made by
    the traffic's kind from the seed."""
    kind = load_module("traffic_kinds", traffic["kind"], bench_dir)
    return kind.make(traffic, np.random.default_rng(int(seed)))


def check_sample(traffic: dict, pool: list, seed: int):
    """The (block, row) pairs the reference checks, drawn from the seed
    (every pair of the pool where ``check_pairs`` is 0 or covers it)."""
    n_rows = [b.q_lens.shape[0] for b in pool]
    total = sum(n_rows)
    want = int(traffic.get("check_pairs", 0)) or total
    rng = np.random.default_rng([int(seed), 1])
    flat = np.sort(rng.choice(total, size=min(want, total), replace=False))
    edges = np.cumsum([0] + n_rows)
    blk = np.searchsorted(edges, flat, side="right") - 1
    return blk, flat - edges[blk]
