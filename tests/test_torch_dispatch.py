"""``run_pairs`` of the PyTorch port against the JAX package's on the CPU:
a mixed-length stream over two buckets, one kernel per PE family and
objective region, equal to JAX's ``reference`` engine on every field, the
moves and the CIGAR."""
from __future__ import annotations

import pytest

from repro.runtime import dispatch as jdispatch
from repro_torch.core import alphabets
from repro_torch.runtime import dispatch

from torch_parity import assert_same_alignment, kernel_pair, random_codes

STREAM_KERNELS = [1, 2, 4, 5, 6, 7, 12, 15]


def _stream(rng, spec, n=7):
    """Pairs of 9..60 codes: buckets 16, 32 and 64 on each side."""
    pairs = []
    for _ in range(n):
        q = random_codes(rng, spec, int(rng.integers(9, 61)))
        if spec.name == "protein_local":
            r = random_codes(rng, spec, int(rng.integers(9, 61)))
        else:
            r = alphabets.mutate(rng, q, 0.15)[:60]
            r = r if len(r) else q[:1]
        pairs.append((q, r))
    return pairs


@pytest.mark.parametrize("kid", STREAM_KERNELS)
def test_run_pairs_matches_reference_engine(kid, rng):
    jspec, jparams, spec, params = kernel_pair(kid)
    pairs = _stream(rng, spec)
    want = jdispatch.run_pairs(jspec, jparams, pairs,
                               engine_name="reference", block=4)
    got = dispatch.run_pairs(spec, params, pairs, block=4, device="cpu")
    assert len(got) == len(pairs)
    for w, g in zip(want, got):
        assert_same_alignment(w, g)


def test_run_pipelined_order_and_abandon():
    launched, harvested, abandoned = [], [], []

    def launch(x):
        launched.append(x)
        return x * 10

    def harvest(x, out):
        if x == 3:
            raise KeyError(x)
        harvested.append((x, out))
        return 1

    assert dispatch.run_pipelined([0, 1, 2], launch, harvest, depth=2) == 3
    assert harvested == [(0, 0), (1, 10), (2, 20)]
    with pytest.raises(KeyError):
        dispatch.run_pipelined([3, 4], launch, harvest, depth=3,
                               on_abandon=lambda x, o: abandoned.append(x))
    assert abandoned == [4]
    with pytest.raises(ValueError, match="depth"):
        dispatch.run_pipelined([], launch, harvest, depth=0)
