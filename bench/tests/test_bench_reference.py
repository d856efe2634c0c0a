"""The plain references against cases worked by hand and against a
cell-by-cell loop, and the program's plain path against them (CPU)."""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest

from bench import harness

BENCH = Path(__file__).resolve().parent.parent
CODES = {c: i for i, c in enumerate("ACGT")}


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _batch(pairs):
    """Padded codes and lengths of (query, reference) strings."""
    Q = max(len(q) for q, _ in pairs)
    R = max(len(r) for _, r in pairs)
    qs = np.zeros((len(pairs), Q), np.uint8)
    rs = np.zeros((len(pairs), R), np.uint8)
    for k, (q, r) in enumerate(pairs):
        qs[k, :len(q)] = [CODES[c] for c in q]
        rs[k, :len(r)] = [CODES[c] for c in r]
    return (qs, rs, np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(r) for _, r in pairs], np.int32))


SW = harness.load_module("reference", "local_affine")
HMM = harness.load_module("reference", "pairhmm_forward")


@pytest.mark.parametrize("q, r, score, end", [
    ("ACGT", "ACGT", 4, (4, 4)),
    # nothing matches: the best is 0 at the first live cell
    ("AAAA", "TTTT", 0, (1, 1)),
    # two copies in the reference score 3; the first in row-major order
    # (the smaller column in the same row) wins
    ("ACG", "ACGTTTACG", 3, (3, 3)),
    ("TTACG", "ACGTTACG", 5, (5, 8)),
    # one mismatch (19 - 4) beats skipping the C with a gap (20 - 7)
    ("A" * 20, "A" * 10 + "C" + "A" * 10, 15, (20, 20)),
    # a gap of two (-7 - 1) between two runs of twelve: 24 - 8
    ("ACGTACGTACGT" + "TTGCATGCATGC", "ACGTACGTACGT" + "GG"
     + "TTGCATGCATGC", 16, (24, 26)),
])
def test_local_affine_by_hand(q, r, score, end):
    out = SW.reference(_config("sw_affine_dna"), *_batch([(q, r)]))
    assert int(out["score"][0]) == score
    assert (int(out["end_i"][0]), int(out["end_j"][0])) == end


def _sw_loop(q, r, match, mismatch, go, ge):
    """Cell by cell, as the recurrence is written."""
    dead = -(1 << 30)
    n, m = len(q), len(r)
    H = np.zeros((n + 1, m + 1), np.int64)
    I = np.full((n + 1, m + 1), dead, np.int64)
    D = np.full((n + 1, m + 1), dead, np.int64)
    best, end = dead, (0, 0)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            I[i, j] = max(H[i, j - 1] + go, I[i, j - 1] + ge)
            D[i, j] = max(H[i - 1, j] + go, D[i - 1, j] + ge)
            s = match if q[i - 1] == r[j - 1] else mismatch
            H[i, j] = max(H[i - 1, j - 1] + s, I[i, j], D[i, j], 0)
            if H[i, j] > best:
                best, end = H[i, j], (i, j)
    return best, end


def test_local_affine_matches_the_loop():
    rng = np.random.default_rng(5)
    cfg = _config("sw_affine_dna")
    p = cfg["program"]["params"]
    pairs = []
    for _ in range(24):
        a = "".join(rng.choice(list("ACGT"), rng.integers(1, 30)))
        b = "".join(rng.choice(list("ACGT"), rng.integers(1, 30)))
        pairs.append((a, b))
    out = SW.reference(cfg, *_batch(pairs))
    for k, (a, b) in enumerate(pairs):
        best, end = _sw_loop(a, b, p["match"], p["mismatch"],
                             p["gap_open"], p["gap_extend"])
        assert out["score"][k] == best
        assert (out["end_i"][k], out["end_j"][k]) == end


def _hmm(cfg):
    p, m = cfg["program"]["params"], cfg["model"]
    mp = p["match_p"]
    return (math.log(mp), math.log((1 - mp) / m["mismatch_divisor"]),
            math.log(m["gap_emission"]), math.log(p["delta"]),
            math.log(p["eps"]), math.log(1 - 2 * p["delta"]),
            math.log(1 - p["eps"]))


def test_pairhmm_by_hand():
    cfg = _config("pairhmm_hc")
    em, mis, g, a, e, t_mm, t_gm = _hmm(cfg)
    out = HMM.reference(cfg, *_batch([("A", "A"), ("A", "AC"), ("AA", "A")]))
    # one base each: a match entered from the free start
    assert out["score"][0] == pytest.approx(em + t_gm, abs=1e-12)
    # the read's base matches column 1 or mismatches column 2
    assert out["score"][1] == pytest.approx(
        np.logaddexp(em + t_gm, mis + t_gm), abs=1e-12)
    # the second base of the read can only be an insertion after the match
    assert out["score"][2] == pytest.approx(em + t_gm + a + g, abs=1e-12)


def _hmm_loop(q, r, cfg):
    em, mis, g, a, e, t_mm, t_gm = _hmm(cfg)
    n, m = len(q), len(r)
    dead = -np.inf
    M = np.full((n + 1, m + 1), dead)
    X = np.full((n + 1, m + 1), dead)
    Y = np.full((n + 1, m + 1), dead)
    Y[0, :] = 0.0
    lae = np.logaddexp
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = em if q[i - 1] == r[j - 1] else mis
            M[i, j] = s + lae(M[i - 1, j - 1] + t_mm,
                              lae(X[i - 1, j - 1], Y[i - 1, j - 1]) + t_gm)
            X[i, j] = g + lae(M[i - 1, j] + a, X[i - 1, j] + e)
            Y[i, j] = g + lae(M[i, j - 1] + a, Y[i, j - 1] + e)
    return np.logaddexp.reduce(lae(M[n, 1:], X[n, 1:]))


def test_pairhmm_matches_the_loop():
    rng = np.random.default_rng(6)
    cfg = _config("pairhmm_hc")
    pairs = [("".join(rng.choice(list("ACGT"), rng.integers(1, 12))),
              "".join(rng.choice(list("ACGT"), rng.integers(1, 20))))
             for _ in range(16)]
    out = HMM.reference(cfg, *_batch(pairs))
    for k, (a, b) in enumerate(pairs):
        assert out["score"][k] == pytest.approx(_hmm_loop(a, b, cfg),
                                                abs=1e-9)


def test_references_import_nothing_of_the_program():
    import subprocess
    import sys
    code = (
        "import sys, json, numpy as np\n"
        "from bench import harness\n"
        "for name in ('local_affine', 'pairhmm_forward'):\n"
        "    ref = harness.load_module('reference', name)\n"
        "    cfg = {'local_affine': 'sw_affine_dna',\n"
        "           'pairhmm_forward': 'pairhmm_hc'}[name]\n"
        "    cfg = json.load(open('bench/configs/' + cfg + '.json'))\n"
        "    q = np.zeros((2, 5), np.uint8)\n"
        "    ref.reference(cfg, q, q, np.array([5, 3]), np.array([5, 4]))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n")
    root = BENCH.parent
    done = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(root), "PATH": "/usr/bin"})
    assert done.returncode == 0, done.stderr
