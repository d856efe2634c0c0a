"""Traffic kind ``windows``: reference windows cut from a random genome and
reads that are mutated copies of them (GASAL2's extension batches).

Keys: ``window`` is ``{"dist": "uniform" | "loguniform", "lo", "hi"}``,
``genome_bases`` the genome's length, ``edit_rate`` the share of bases
edited, ``read_max`` the longest read kept.  Reads are on the query axis.
"""
from __future__ import annotations

import numpy as np

from bench import traffic as t


def make(traffic: dict, rng) -> list:
    n = int(traffic["batch"]) * int(traffic["pool_blocks"])
    w = traffic["window"]
    lens = rng.permutation(t.grid(n, int(w["lo"]), int(w["hi"]), w["dist"]))
    genome = rng.integers(0, 4, int(traffic["genome_bases"])).astype(
        np.uint8)
    starts = rng.integers(0, genome.shape[0] - lens + 1)
    refs = t.segments(genome, starts, lens)
    reads, read_lens = t.mutate(rng, refs, lens, float(traffic["edit_rate"]))
    reads, read_lens = t.truncate(reads, read_lens, int(traffic["read_max"]))
    empty = read_lens == 0
    if empty.any():
        # an empty read keeps its window's first base, as the smoke's pairs do
        ref_starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        read_starts = np.concatenate([[0], np.cumsum(read_lens)[:-1]])
        reads = np.insert(reads, read_starts[empty], refs[ref_starts[empty]])
        read_lens = np.where(empty, 1, read_lens)
    return t.blocks(reads, read_lens, refs, lens, traffic)
