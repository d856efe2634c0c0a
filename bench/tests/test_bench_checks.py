"""The check that decides ``correct``, shown to fail (CPU, tiny sizes):
the control (the plain reference in the program's place at the precision
below the configuration's) and the faults a cell can have, planted under
the window's entry.  Also the traceback key of the traffic schema,
against the reference's own walk."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from bench import harness, traffic
from bench.tests.test_bench_harness import tiny_cell

SEEDS = (101, 2 ** 33 + 7, 31337)


def _control(cell, dtype=None):
    ref = harness.load_module("reference", cell.config["reference"])
    dev = torch.device("cpu")
    if dtype is None:
        return lambda inputs: harness.reference_answers(
            ref, cell.config, inputs, dev, "control")
    return lambda inputs: ref.reference(cell.config, *inputs, device=dev,
                                        dtype=dtype)


def _readings(cell, seed, answers):
    pool = traffic.make_pool(cell.traffic, seed)
    numbers, bad, n = harness.check(cell.config, cell.traffic, pool,
                                    answers, seed, torch.device("cpu"))
    checks = harness.limits_of(cell.config, numbers)
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def _sw_cell():
    """Windows long enough for scores past int8 (the cell's own bucket)."""
    cell = tiny_cell("short_b262144")
    cell.traffic.update({"batch": 16, "bucket": [256, 256], "read_max": 256,
                         "window": {"dist": "uniform", "lo": 128,
                                    "hi": 256},
                         "genome_bases": 65536})
    return cell


@pytest.mark.parametrize("seed", SEEDS)
def test_sw_control_int8_is_not_correct(seed):
    checks, ok = _readings(_sw_cell(), seed, _control(_sw_cell()))
    assert not ok and checks["mismatched_pairs"]["value"] > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_sw_int16_is_exact_at_these_scores(seed):
    """Not a fault: every score of the cells fits 16 bits."""
    checks, ok = _readings(_sw_cell(), seed,
                           _control(_sw_cell(), torch.int16))
    assert ok


@pytest.mark.parametrize("seed", SEEDS)
def test_pairhmm_control_bf16_is_not_correct(seed):
    cell = tiny_cell("sites_b32768")
    checks, ok = _readings(cell, seed, _control(cell))
    assert not ok


@pytest.mark.parametrize("seed", SEEDS)
def test_pairhmm_f32_reference_is_correct(seed):
    cell = tiny_cell("sites_b32768")
    checks, ok = _readings(cell, seed, _control(cell, torch.float32))
    assert ok


def _halved(align_batch):
    """Half of the batch left out: the second half's rows answered with
    the first half's."""
    def align(spec, params, q, r, ql, rl, **kw):
        n = q.shape[0] // 2
        out = align_batch(spec, params, q[:n], r[:n], ql[:n], rl[:n], **kw)
        return type(out)(**{f.name: (None if getattr(out, f.name) is None
                                     else torch.cat([getattr(out, f.name)] * 2)
                                     [:q.shape[0]])
                            for f in dataclasses.fields(out)})
    return align


def _altered(align_batch):
    """One answer of every call altered where it is produced."""
    def align(spec, params, q, r, ql, rl, **kw):
        out = align_batch(spec, params, q, r, ql, rl, **kw)
        out.score[0] += 1
        return out
    return align


@pytest.mark.parametrize("name", ["short_b262144", "sites_b32768"])
@pytest.mark.parametrize("fault", [_halved, _altered])
def test_planted_fault_is_not_correct(name, fault):
    from repro_torch.core.batch import align_batch
    res = harness.run_cell(tiny_cell(name), 77, 0.3, device="cpu",
                           call=fault(align_batch), log=lambda *a: None)
    assert res["correct"] is False
    assert res["failed"] > 0


def test_repeat_that_differs_is_not_correct():
    """An answer that changes between two calls of one block: set-up runs
    each of the two blocks once, so the fifth call is the window's second
    call of block 0."""
    from repro_torch.core.batch import align_batch
    calls = []

    def align(spec, params, q, r, ql, rl, **kw):
        out = align_batch(spec, params, q, r, ql, rl, **kw)
        calls.append(1)
        if len(calls) == 5:
            out.end_j[1] += 1
        return out
    res = harness.run_cell(tiny_cell("short_b262144"), 5, 3.0, device="cpu",
                           call=align, log=lambda *a: None)
    assert len(calls) > 5
    assert res["checks"]["repeat_mismatches"]["value"] == 1
    assert res["correct"] is False


def _tb_cell():
    cell = tiny_cell("short_b262144")
    cell.traffic["with_traceback"] = True
    return cell


def test_traceback_traffic_checks_paths():
    res = harness.run_cell(_tb_cell(), 8, 0.3, device="cpu",
                           log=lambda *a: None)
    assert res["correct"] is True
    assert res["checks"]["tb_bad_paths"] == {"value": 0, "limit": 0}


def test_program_paths_equal_the_reference_walk():
    from repro_torch.core.batch import align_batch
    cell = _tb_cell()
    spec, params = harness.load_module("programs", "zoo").make(
        cell.config["program"])
    ref = harness.load_module("reference", "local_affine")
    blk = traffic.make_pool(cell.traffic, 12)[0]
    out = align_batch(spec, params, torch.from_numpy(blk.queries),
                      torch.from_numpy(blk.refs), blk.q_lens, blk.r_lens,
                      with_traceback=True, device="cpu")
    want = ref.reference(cell.config, blk.queries, blk.refs, blk.q_lens,
                         blk.r_lens, walk=True)
    for k in range(blk.q_lens.shape[0]):
        n = int(out.n_moves[k])
        moves = out.moves[k, :n].numpy()[::-1]
        np.testing.assert_array_equal(moves, want["moves"][k])
        assert (int(out.start_i[k]), int(out.start_j[k])) == (
            want["start_i"][k], want["start_j"][k])
    # the reference's walk passes the check that judges a path
    got = {"score": want["score"], "end_i": want["end_i"],
           "end_j": want["end_j"], "start_i": want["start_i"],
           "start_j": want["start_j"],
           "n_moves": np.array([len(m) for m in want["moves"]]),
           "moves": [m[::-1] for m in want["moves"]]}
    inputs = (blk.queries, blk.refs, blk.q_lens, blk.r_lens)
    numbers, bad = ref.compare(cell.config, got, want, inputs)
    assert numbers == {"mismatched_pairs": 0, "tb_bad_paths": 0}


def test_a_path_that_does_not_score_the_best_is_bad():
    cell = _tb_cell()
    ref = harness.load_module("reference", "local_affine")
    blk = traffic.make_pool(cell.traffic, 13)[0]
    want = ref.reference(cell.config, blk.queries, blk.refs, blk.q_lens,
                         blk.r_lens, walk=True)
    moves = [m[::-1].copy() for m in want["moves"]]
    # turn one diagonal step into a gap pair: the path still ends at the
    # end cell but scores less
    k = int(np.argmax([len(m) for m in moves]))
    m = list(moves[k])
    at = m.index(1)
    m[at:at + 1] = [2, 3]
    moves[k] = np.array(m)
    got = {"score": want["score"], "end_i": want["end_i"],
           "end_j": want["end_j"], "start_i": want["start_i"],
           "start_j": want["start_j"],
           "n_moves": np.array([len(x) for x in moves]), "moves": moves}
    inputs = (blk.queries, blk.refs, blk.q_lens, blk.r_lens)
    numbers, bad = ref.compare(cell.config, got, want, inputs)
    assert numbers["tb_bad_paths"] == 1 and bad[k]
