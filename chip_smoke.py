#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's alignment main path (``run_pairs`` -> plan -> K1 fill
-> batched traceback -> harvest) on the card, holds every CUDA kernel
against its plain PyTorch version, times K1, and prints one JSON line per
kernel and, last, ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero without that last line, and so does a machine without CUDA
or a directory without the ``src/repro_torch`` package.

Phases:
  1. card identity (name, count, power limit, SM clock);
  2. build K1 with nvcc and report ptxas registers / spills;
  3. K1 vs its plain version, every ported zoo kernel and pointer packing,
     at buckets 64 (batch 16, mixed lengths), 256 (batch 64), 1024 (batch 4);
  4. main path: ``run_pairs`` with global affine (#2) on 8192 short DNA
     pairs (windows of 128-256 bases of a 1 Mb random reference, queries
     mutated at 8 %), block 1024, with traceback; checked against the CPU
     path on the first 64 pairs;
  5. long reads: local affine (#4) on 256 pairs of 700-1024 bases, block
     256; checked against the CPU path on the first 16;
  6. K1 vs its plain version on the fullest block of every bucket shape
     that phases 4 and 5 gave K1 (batch 1024 and 256), then K1 alone timed
     at the main path's largest shape, beside its plain version and its
     lower bound on this card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MEM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES_PER_SM = 64            # Hopper: 4 partitions x 16 INT32 lanes
# int32 ALU operations of one PE cell, counted from the functors in
# src/repro_torch/kernels/wavefront/csrc/wavefront.cu (adds, maxes,
# compares, selects, pointer bit packing; local adds the zero clamp)
PE_OPS = {("linear", False): 11, ("linear", True): 14,
          ("affine", False): 21, ("affine", True): 24,
          ("two_piece", False): 39}
PORTED = [1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 15]
FIELDS = ("score", "end_i", "end_j", "start_i", "start_j", "n_moves",
          "moves")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_time_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
def phase_identity():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[1] device: {name}, count {count}, {sms} SMs, max SM clock "
          f"{clock_mhz:.0f} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(smi, flush=True)
    return {"name": name, "count": count, "smi": smi,
            "int32_ops_per_s": sms * INT32_LANES_PER_SM * clock_mhz * 1e6}


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.wavefront import kernel as K
    built = build.load(K.SOURCE)
    log = built.ptxas_log
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    print(f"[2] built {built.path.name} in {built.seconds:.1f} s: "
          f"{len(regs)} kernel instantiations, registers "
          f"{min(regs) if regs else '?'}-{max(regs) if regs else '?'} per "
          f"thread, spill bytes {sum(spills)}", flush=True)
    check(regs, "ptxas reported no kernels")
    return built


def _fill_args(spec, params, qs, rs, ql, rl, dev):
    import torch
    from repro_torch.kernels.wavefront import ops
    q_lens = torch.as_tensor(ql, device=dev)
    r_lens = torch.as_tensor(rl, device=dev)
    row, col = ops.boundaries(spec, params, qs.shape[1], rs.shape[1],
                              q_lens, r_lens)
    return (torch.as_tensor(qs, device=dev), torch.as_tensor(rs, device=dev),
            row, col, torch.stack([q_lens, r_lens], dim=1).contiguous())


def phase_kernel_vs_plain(rng):
    import numpy as np
    import torch
    from repro_torch.core import kernels_zoo
    from repro_torch.kernels.wavefront import kernel as K
    max_err, n = 0, 0
    t0 = time.perf_counter()
    for kid in PORTED:
        spec, params = kernels_zoo.make(kid)
        hi = 20 if kid == 15 else 4
        for bucket, batch in ((64, 16), (256, 64), (1024, 4)):
            qs = rng.integers(0, hi, (batch, bucket)).astype(np.uint8)
            rs = rng.integers(0, hi, (batch, bucket)).astype(np.uint8)
            ql = rng.integers(bucket // 2, bucket + 1, batch).astype(np.int32)
            ql[0] = bucket
            if spec.band is not None:
                rl = np.clip(ql + rng.integers(-8, 9, batch), 1, bucket)
            else:
                rl = rng.integers(bucket // 2, bucket + 1, batch)
            rl = rl.astype(np.int32)
            args = _fill_args(spec, params, qs, rs, ql, rl, "cuda")
            for pack in sorted({spec.tb_pack, 1}):
                got = K.wavefront_fill(spec, params, *args, tb_pack=pack)
                want = K.wavefront_fill_plain(spec, params, *args,
                                              tb_pack=pack)
                torch.cuda.synchronize()
                err = max(int((g.long() - w.long()).abs().max())
                          for g, w in zip(got, want))
                max_err = max(max_err, err)
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                check(same, f"K1 != plain: kernel #{kid}, bucket {bucket}, "
                            f"batch {batch}, tb_pack {pack} (max |diff| "
                            f"{err})")
                n += 1
    print(f"[3] K1 == plain on {n} (kernel, bucket, tb_pack) cases "
          f"(tb, best, best_j bit-equal) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return max_err


def _read_pairs(rng, genome, n, lo, hi, rate, max_len):
    from repro_torch.core import alphabets
    pairs = []
    for _ in range(n):
        w = int(rng.integers(lo, hi + 1))
        s = int(rng.integers(0, len(genome) - w))
        ref = genome[s:s + w]
        q = alphabets.mutate(rng, ref, rate)[:max_len]
        pairs.append((q if len(q) else ref[:1], ref))
    return pairs


def _compare_results(got, want, what):
    import numpy as np
    from repro_torch.core import traceback as tb_mod
    for k, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            check(np.array_equal(np.asarray(getattr(g, f)),
                                 np.asarray(getattr(w, f))),
                  f"{what}: pair {k} field {f} differs from the CPU path")
        check(tb_mod.moves_to_cigar(g.moves, g.n_moves)
              == tb_mod.moves_to_cigar(w.moves, w.n_moves),
              f"{what}: pair {k} CIGAR differs from the CPU path")


def _blocks(pairs, block):
    """The padded blocks run_pairs forms: (bucket, qs, rs, ql, rl)."""
    import numpy as np
    from repro_torch.runtime import bucketing
    batches, _ = bucketing.pack_by_bucket(
        [(len(q), len(r)) for q, r in pairs], block=block)
    out = []
    for b in batches:
        bq, br = b.bucket
        qs = np.zeros((block, bq), np.uint8)
        rs = np.zeros((block, br), np.uint8)
        ql = np.ones((block,), np.int32)
        rl = np.ones((block,), np.int32)
        for row, idx in enumerate(b.indices):
            q, r = pairs[idx]
            ql[row], rl[row] = len(q), len(r)
            qs[row, :len(q)] = q
            rs[row, :len(r)] = r
        out.append((b.bucket, qs, rs, ql, rl))
    return out


def _split_times(spec, params, blocks):
    """Fill and traceback device time of each padded block, apart."""
    import torch
    from repro_torch.core import traceback as tb_mod
    from repro_torch.kernels.wavefront import ops
    fill_ms, tb_ms = [], []
    for (bq, br), qs, rs, ql, rl in blocks:
        q, r = torch.as_tensor(qs, device="cuda"), torch.as_tensor(
            rs, device="cuda")
        qlt, rlt = torch.as_tensor(ql, device="cuda"), torch.as_tensor(
            rl, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ops.run(spec, params, q, r, qlt, rlt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tb_mod.run_batched(spec, res, max_len=bq + br + 1,
                           step_bound=int((ql + rl).max()) + 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fill_ms.append((t1 - t0) * 1e3)
        tb_ms.append((t2 - t1) * 1e3)
    return fill_ms, tb_ms


def phase_main_path(rng, genome):
    import numpy as np
    import torch
    from repro_torch.core import kernels_zoo
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.runtime import dispatch
    spec, params = kernels_zoo.make(2)
    block = 1024
    pairs = _read_pairs(rng, genome, 8192, 128, 256, 0.08, 256)
    blocks = _blocks(pairs, block)
    live = sum(len(q) * len(r) for q, r in pairs)
    padded = sum(block * bq * br for (bq, br), *_ in blocks)

    dispatch.run_pairs(spec, params, pairs[:block], block=block)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    t0 = time.perf_counter()
    got = dispatch.run_pairs(spec, params, pairs, block=block)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == len(blocks),
          f"main path launched K1 {launches} times for {len(blocks)} blocks")
    check(all(np.isfinite(float(a.score)) for a in got), "non-finite score")

    want = dispatch.run_pairs(spec, params, pairs[:64], block=64,
                              device="cpu")
    _compare_results(got[:64], want, "main path")

    fill_ms, tb_ms = _split_times(spec, params, blocks)
    fill_s = sum(fill_ms) / 1e3
    print(f"[4] main path: run_pairs #2 global_affine, {len(pairs)} pairs "
          f"in {len(blocks)} blocks of {block}: {wall:.3f} s wall, "
          f"{len(pairs) / wall:.0f} pairs/s; K1 launches {launches}; first "
          f"64 equal to the CPU path (score, ends, starts, moves, CIGAR)",
          flush=True)
    print(f"    per block: fill {np.mean(fill_ms):.2f} ms, traceback "
          f"{np.mean(tb_ms):.2f} ms (host clock around synchronised "
          f"calls); fill GCUPS {live / fill_s / 1e9:.1f} live cells, "
          f"{padded / fill_s / 1e9:.1f} padded cells; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    return launches, blocks


def phase_long_reads(rng, genome):
    import torch
    from repro_torch.core import kernels_zoo
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.runtime import dispatch
    spec, params = kernels_zoo.make(4)
    pairs = _read_pairs(rng, genome, 256, 700, 1000, 0.08, 1024)
    before = K.launches
    t0 = time.perf_counter()
    got = dispatch.run_pairs(spec, params, pairs, block=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(K.launches > before, "long reads did not reach K1")
    want = dispatch.run_pairs(spec, params, pairs[:16], block=16,
                              device="cpu")
    _compare_results(got[:16], want, "long reads")
    print(f"[5] long reads: run_pairs #4 local_affine, {len(pairs)} pairs "
          f"of 700-1024 bases: {wall:.3f} s wall, "
          f"{len(pairs) / wall:.0f} pairs/s; first 16 equal to the CPU path",
          flush=True)
    return _blocks(pairs, 256)


def _live_cells(block):
    return int((block[3].astype("int64") * block[4]).sum())


def _fullest_per_bucket(blocks):
    """One block of each bucket shape: the one with the most live cells."""
    best = {}
    for b in blocks:
        if b[0] not in best or _live_cells(b) > _live_cells(best[b[0]]):
            best[b[0]] = b
    return [best[k] for k in sorted(best)]


def _hold_to_plain(spec, params, block, what):
    """K1 and its plain version on one padded block, as run_pairs hands it
    to K1 (spec-default tb_pack, with pointers); returns the fill
    arguments, the largest |difference| and the plain version's ms."""
    import torch
    from repro_torch.kernels.wavefront import kernel as K
    (bq, br), qs, rs, ql, rl = block
    args = _fill_args(spec, params, qs, rs, ql, rl, "cuda")
    got = K.wavefront_fill(spec, params, *args, tb_pack=spec.tb_pack)
    want = []
    plain_ms = cuda_time_ms(lambda: want.extend(K.wavefront_fill_plain(
        spec, params, *args, tb_pack=spec.tb_pack)), 1)
    check(all(g.shape == w.shape for g, w in zip(got, want)),
          f"K1 and plain shapes differ on the {what} block {bq}x{br}")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"K1 != plain on the {what} block {bq}x{br} (batch {qs.shape[0]}, "
          f"max |diff| {err})")
    return args, err, plain_ms


def phase_path_shapes(main_blocks, long_blocks, card):
    """K1 vs plain on one block of every bucket shape the main path and the
    long-read run gave K1, then K1 timed at the main path's largest one."""
    from repro_torch.core import kernels_zoo
    from repro_torch.kernels.wavefront import kernel as K
    launches0 = K.launches
    max_err, held = 0, []
    for kid, blocks, what in ((2, main_blocks, "main path"),
                              (4, long_blocks, "long-read")):
        spec, params = kernels_zoo.make(kid)
        for block in _fullest_per_bucket(blocks):
            args, err, plain_ms = _hold_to_plain(spec, params, block, what)
            max_err = max(max_err, err)
            held.append(f"#{kid} {block[0][0]}x{block[0][1]}")
            if kid == 2:
                timed = (block, args, plain_ms)   # last = largest bucket
    print(f"[6] K1 == plain (tb, best, best_j bit-equal) on the fullest block "
          f"of each path shape: {', '.join(held)}", flush=True)

    spec, params = kernels_zoo.make(2)
    pack = spec.tb_pack
    ((bq, br), qs, rs, ql, rl), args, plain_ms = timed
    for _ in range(3):
        K.wavefront_fill(spec, params, *args, tb_pack=pack)
    ms = cuda_time_ms(lambda: K.wavefront_fill(spec, params, *args,
                                               tb_pack=pack), 20)
    K.launches = launches0
    B, L = qs.shape[0], spec.n_layers
    C = bq // K.N_PE
    cells = int((ql.astype("int64") * rl).sum())
    ops = PE_OPS[(spec.family.family, spec.family.local)] * cells
    nbytes = (B * bq + B * br + B * (br + 1) * L * 4 + B * (bq + 1) * L * 4
              + B * 8                                        # inputs
              + B * C * (K.N_PE // pack) * (K.N_PE + br - 1)   # pointer store
              + 2 * B * C * K.N_PE * 4)                        # best, best_j
    ops_ms = ops / card["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"    K1 timed at batch {B}, {bq}x{br}, #2, tb_pack {pack}: "
          f"{ms:.4f} ms (CUDA events, mean of 20); plain {plain_ms:.1f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} (int32 ops {ops_ms:.4f} "
          f"ms for {cells} live cells, bytes {bytes_ms:.4f} ms for "
          f"{nbytes} B); {cells / ms / 1e6:.1f} GCUPS live", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": max_err}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import alphabets

    t0 = time.perf_counter()
    try:
        card = phase_identity()
        phase_build()
        rng = np.random.default_rng(SEED)
        max_err = phase_kernel_vs_plain(rng)
        genome = alphabets.random_dna(rng, 1_000_000)
        launches, blocks = phase_main_path(rng, genome)
        long_blocks = phase_long_reads(rng, genome)
        timing = phase_path_shapes(blocks, long_blocks, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": "wavefront_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/wavefront/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront/kernel.py:198",
        "launches": launches, "parity": "exact",
        "max_abs_err": max(max_err, timing["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
