#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It drives the port's main paths on the card: the alignment path
(``run_pairs`` -> plan -> K1 fill -> batched traceback -> harvest), the
read mapper (``ReadMapper.map_reads``: index, seed, chain, the screen on K2,
banded extension on K1, SAM), pair-HMM genotyping (``run_pairs`` on K1's
logsumexp instantiation, ``prob.call_genotype``, ``prob.call_site``), the
serving layer (the gateway's ``AlignmentService`` with K2's prefilter and
degrade path, ``GenotypingService``, ``ReadMappingService``; ``tiled_align``
and the ``banded`` engine), LM serving (``ServeSession``: per-slot
prefill on K3 for olmo-1b and K4 for rwkv6-3b, batched greedy decode) and
LM training (``launch.train.train_loop``: AdamW steps of olmo-1b on K3 and
rwkv6-3b on K4, forward and backward kernels).  It holds every CUDA kernel
against its plain PyTorch version at the shapes those paths give it, times
K1-K4 and the two backward kernels, and prints one JSON line listing the
kernels and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that last line, and so does a machine without CUDA or a directory without
the ``src/repro_torch`` package.

Phases:
  1. card identity (name, count, power limit, SM clock);
  2. build K1 (two sources: the gap-model families and the others), K2,
     K3, K4 and the backward kernels of K3 and K4 with nvcc, all at once,
     and report ptxas registers /
     spills (K1's instantiations for #2, #4, the mapper's extension and
     the pair-HMM forward at logsumexp, and every K2 instantiation, must
     not spill; every other-family instantiation is listed), and list the
     registers and spills of every entry of the two backward sources (also
     in the kernels line);
  3. K1 vs its plain version, every ported zoo kernel and pointer packing,
     at buckets 64 (batch 16, mixed lengths), 256 (batch 64), 1024 (batch 4),
     each output allocated on blocks the script left filled with 0xFF (one
     plain fill per kernel and bucket, packed for each packing by the
     plain version's own ``pack_store``; also in 3b);
  3b. K1 vs its plain version for #8, #9, #10, #14, the pair-HMM forward
     and backward at logsumexp and the forward at max-plus, at the same
     buckets, on 0xFF blocks: integers bit-equal, float best within rtol
     1e-5 (max/min) / 2e-5 (logsumexp), best_j and pointers exact
     wherever best is bit-equal;
  4. main path: ``run_pairs`` with global affine (#2) on 8192 short DNA
     pairs (windows of 128-256 bases of a 1 Mb random reference, queries
     mutated at 8 %), block 1024, with traceback; checked against the CPU
     path on the first 64 pairs;
  5. long reads: local affine (#4) on 256 pairs of 700-1024 bases, block
     256; checked against the CPU path on the first 16;
  6. K1 vs its plain version on the fullest block of every bucket shape
     that phases 4 and 5 gave K1 (batch 1024 and 256), then K1 alone timed
     at the main path's largest shape and at the fullest long-read block,
     beside its plain version and its lower bound on this card, and on
     the largest shape without the pointer store and at batch 132, 264
     and 528;
  T. the autotuner at the main paths' full shapes: #2 at batch 1024,
     256x256, #4 at batch 256, 1024x1024, and the pair-HMM forward at
     logsumexp at batch 1024, 256x512.  ``tune_point(mode="fill",
     top_k=4)`` into a temporary table (each candidate bit-equal to the
     default plan before it is timed), every measured candidate's K1 time
     alone (kernel_device_ms) beside its predicted time, the winner's
     speedup over the default; then ``get_plan`` with the table installed
     takes its options, explicit options win, and REPRO_TORCH_TUNE_TABLE=off
     restores the heuristic; and ``lint_all`` over the port's registry, with
     R401 reading the built libraries' ptxas reports, has no error;
  X. X-drop on the card: #4 and #2, 256 pairs of 200-400 bases each, at
     two xdrop values and strip 8, through ``run_pairs(engine_name=
     "wavefront", xdrop=...)``: the first 32 equal to the CPU path (score,
     ends, starts, moves, CIGAR), wall times, K1 not launched by an X-drop
     plan and launched by the same pairs without xdrop;
  7. K2 vs its plain version: #16 and #17, buckets 64, 256 and 1024 (1, 4
     and 16 words) at batch 64, random (64 and 256 only) and 8 %-mutated
     pairs with lengths below the bucket (q_len 1 included), k in {-1, 0,
     bucket / 10}, each output allocated on blocks left filled with 0xFF;
  8. the mapper at a real size: a 4,641,652-base random reference (the
     length of E. coli K-12 MG1655, NCBI RefSeq NC_000913.3) with 16 runs of
     200 N, 32,768 simulated 150-base reads at 5 % error plus 4,096 random
     junk reads, ``ReadMapper(ref, block=1024, screen_block=1024)``; checks
     the launch counts, the accuracy bars and 256 records against the CPU
     path, holds K1 and K2 to their plain versions on the path's blocks,
     times each stage, and times K1 alone on the fullest extension block
     (its bound counts the cells inside the band);
  9. K2 alone timed at the screen's fullest block, beside its plain version
     and its lower bound on this card, and at batch 128 and 8192 (the
     block's pairs repeated);
  G. genotyping at GATK HaplotypeCaller's shapes: 1,024 sites of
     ``sample_site`` (seeds 0-1023, 400-base haplotypes, 30 reads of 150
     at 1 % error, genotypes cycling (0,0), (0,1), (1,1), every 8th site
     three alternates and genotype (1, 3)); all 69,120 read x haplotype
     pairs through one ``run_pairs`` (block 1024, logsumexp, score-only),
     the calls per site; checks concordance >= 99 %, the first 64
     likelihoods against the CPU path (rtol 2e-5) and ``call_site`` on
     four sites; K1 held to its plain version (rtol 2e-5) and timed on the
     fullest block, beside its bound (the MUFU and f32 operations that
     the live cells and the last rows' cells need);
  P. ``forward_backward`` on four 150 x 400 pairs on the card's reference
     engine: log_z_backward within rel 1e-4 of log_z, rows summing to 1
     within 5e-4, the CPU path within 1e-4;
  S. the serving layer, data from SEED: ``AlignmentService(max_len=512,
     block=256, prefilter=0.1, pipeline_depth=2)`` under ``serve()`` with 2
     workers, 8192 requests alternating #2 and #4, windows of 100-300 bases
     of a random 1 Mb reference mutated at 8 % (GASAL2's extension regime),
     about 10 % of the #2 queries unrelated junk.  A clean cold run (K1 and
     K2 counted, their arguments recorded): every unfiltered result (score,
     end, CIGAR) == run_pairs on the card, every screen decision == plain
     K2's distance against the cut ceil(0.1 len(q)); at each shape the
     run gave them, K1 and K2 == their plain versions on the recorded
     inputs of the fullest launch (survivors, then length-1 dummy rows),
     bit for bit, and timed alone for their device share; requests/s,
     exact p50/p99 latency beside the gateway histogram's; a warm-started
     run on the first 2048 requests, over the clean run's channel grid
     (compile_s at boot and while serving, a Chrome trace under build/
     that passes validate_chrome_trace, the workers' span totals); the
     whole stream warm-started with 1, 2, 2 and 1 workers in turns, each
     == the clean run; the same stream under FaultPlan(seed=0, kill
     w0 at dispatch 1, launch failures p 0.1): bit-identical, no double
     completion, submitted == resolved + dead_lettered; the first 2048
     requests with degrade="myers" past a watermark: each degraded
     edit_distance == plain K2's.  Then 256 of phase G's sites through
     ``GenotypingService`` (each call == phase G's), 4096 of phase 8's reads
     through ``ReadMappingService`` (SAM lines == map_reads), ``tiled_align``
     of a 10 kb #2 pair (tile 256, overlap 64) on K1 == on the reference
     engine, and #11-13 on ``banded`` (256 pairs of 200-400 bases) == the
     reference engine, #12 with xdrop 10 == the CPU;
  (K1 and K2 are timed by kernel_device_ms: the device time of 20
  launches captured in a CUDA graph and replayed between CUDA events, 5
  rounds, median and range, with the CUDA-event ms of Python calls, the
  host us per call and the kernel records one torch.profiler round held)
 10. K3 vs its plain version, p rounded to the inputs' type on both
     sides: causal, causal with window 64, non-causal x G 1 and 4 x S 77,
     512, 1000 x hd 64 and 128 x f32, bf16 on integer q/k (exact scores)
     and bf16 on normal q/k (K3_PARITY; see _k3_hold), and, for
     information, bf16 K3 against plain with p kept in f32;
 11. K4 vs its plain version: decay scales 1 and 2 x S 1, 33, 77, 1000,
     1499 x r/k/v f32 and bf16, hd 64, H 4 (y and the final state within
     5e-4);
 12. olmo-1b at full width (1.18 B parameters, bf16, random from seed 0):
     ``ServeSession(batch_slots=8, max_len=2048)``, greedy, 16 requests of
     256-1536 random tokens, 32 new tokens each; wall time, time to first
     token, prefill and decode tokens/s, peak memory; K3 launches = 16 x 16
     over the serve run alone; K3 vs plain (K3_PARITY) on layer 0 of the
     longest prompt; prefill and first decode logits vs ``forward`` in bf16 (3x
     the measured bf16 rounding) and in f32 (2e-3 / 1e-3, and a decode
     from a cache with layer 0 zeroed must fail that check); K3's share of
     prefill, and a torch.profiler view of one prefill and three decode
     steps (device busy share, top kernels);
 13. rwkv6-3b at full width (3.10 B parameters with 48 padded heads), the
     same traffic and checks on K4 (launches = 16 x 32);
 14. card vs CPU: both reduced configs in f32, 5 requests on 2 slots, 6 new
     tokens: equal greedy tokens, every step's logits within 2e-3 / 1e-3;
 15. K3 at (1, 1536, 16, 128) bf16 causal and K4 at (1, 1536, 48, 64) timed
     alone over 5 rounds of 20 launches, K3 in turns with
     ``scaled_dot_product_attention`` (K3, SDPA, SDPA, K3: a yardstick the
     port never calls), medians and spread, beside their plain versions and
     their bounds on this card; then K3 forward + backward through autograd
     at (4, 2048, 16, 128) bf16 causal in turns with SDPA's forward +
     backward, K3's backward alone there in turns with SDPA's backward
     alone (``torch.autograd.grad`` on a retained SDPA graph), and K4's
     backward alone at (4, 2048, 48, 64), beside their plain versions and
     bounds and the card's name and power limit;
 16. K3's forward lse and backward kernel vs their plain versions
     (``flash_backward_plain``) over phase 10's sweep, dq, dk, dv and lse
     allocated on 0xFF blocks (K3_BWD_PARITY); f32 on the CUDA-core
     kernels, bf16 on the tensor-core ones; a second call on the same
     inputs gives the same bits;
 17. K4's backward kernel vs autograd through ``wkv6_plain`` over phase
     11's sweep, on the forward kernel's chunk states, dr, dk, dv, dlw
     and du on 0xFF blocks (K4_BWD_PARITY); a second call gives the same
     bits;
 18. olmo-1b at full width trains through ``train_loop(device="cuda")``:
     8 AdamW steps of 4 x 2048 tokens from ``LMBatcher(seed=0)``
     (``AdamWConfig(weight_decay=0.01)``, ``cosine_with_warmup(3e-4, 5,
     8)``, remat on): finite losses and grad norms, the mean loss of the
     last two steps below step 1's, K3 launched 2 x 16 times forward and 16
     backward every step; layer 0's recorded backward held against
     ``flash_backward_plain``; step time, tokens/s, peak memory and K3's
     share of a step;
 19. rwkv6-3b the same on K4 (2 x 32 forward, 32 backward a step; the
     recorded backward against autograd through ``wkv6_plain``);
 20. card vs CPU training: the reduced configs in f32 from one numpy-made
     state, 3 ``make_train_step`` steps on each device (losses and grad
     norms within TRAIN_CPU_TOL), and a checkpoint saved on the card after
     step 2 and restored by ``restore_latest`` gives a step-3 loss
     bit-equal to the unbroken run's.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"
# The card's bound model (HBM bytes/s, INT32 lanes per SM, K1's PE
# operations and byte count) lives in src/repro_torch/tune/cost.py, one copy
# shared with the autotuner; the phases import it once the checkout's src is
# on the path.
# int32 lane operations K2's work needs, counted from the word step in
# src/repro_torch/kernels/myers/csrc/myers.cu at the fewest Hopper
# instructions: LOP3 does any three-input logic per 32-bit half, IADD3 and
# IADD3.X the 64-bit add, LEA (low half, with the carry-in bit) and
# SHF.L.U64.HI (high half) a shift by one.  Per live word-column: xv,
# eq & vp, the add, xh, ph, mh, ph << 1, mh << 1, vp and vn at 2 each, and
# hin's -1 into eq's low half at 1.  Per word that hands hout to the word
# above: the top bits of ph and mh, 1 each.  Per column of the search the
# screen runs: the score's two bit extracts (a shift and a mask each), one
# IADD3, and the argmin (a compare and two selects).
K2_OPS_PER_WORD_COLUMN = 21
K2_OPS_PER_HANDOFF = 2
K2_OPS_PER_COLUMN = 8
PORTED = [1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 15]
# phase 3b: K1's other families (csrc/wavefront_ext.cu): the zoo's float and
# min-plus kernels and the pair-HMM at both semirings
EXT_CASES = [8, 9, 10, 14, ("forward", "logsumexp"), ("backward",
             "logsumexp"), ("forward", "max")]
# The pair-HMM forward's work, counted from PairHmmForwardPE in
# csrc/wavefront_ext.cu at the fewest Hopper instructions.  A logaddexp is
# one MUFU.EX2, one MUFU.LG2 and five f32 operations (max, a - b, the
# scale into ex2, 1 + e, the fused m + ln2 lg2).  Every live cell needs
# four (M's two, X, Y) and nine f32 adds of the transitions and emissions;
# F = M + X is read only by the fold over the last row, so a live cell of
# the last row needs two more (F and the fold) and nothing else does.
PAIRHMM_MUFU_PER_CELL = 4 * 2
PAIRHMM_F32_PER_CELL = 4 * 5 + 9
PAIRHMM_MUFU_PER_LAST_ROW_CELL = 2 * 2
PAIRHMM_F32_PER_LAST_ROW_CELL = 2 * 5
MUFU_PER_SM_CLOCK = 16              # Hopper: 4 partitions x 4 SFU lanes
F32_PER_SM_CLOCK = 128              # Hopper: 4 partitions x 32 FP32 lanes
# genotyping phase: GATK HaplotypeCaller shapes (2 x 150 Illumina reads, an
# assembly region of up to 300 bases plus 100 of padding, 30x depth)
GT_SITES, GT_HAP_LEN, GT_READ_LEN, GT_READS = 1024, 400, 150, 30
GT_BLOCK = 1024
E_COLI_LEN = 4_641_652             # E. coli K-12 MG1655, NC_000913.3
N_READS, N_JUNK, READ_LEN = 32768, 4096, 150
MAPPER_BLOCK = 1024
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
K3_SWEEP_S = (77, 512, 1000)
K4_SWEEP_S = (1, 33, 77, 1000, 1499)
# K3 against its plain version, p rounded to q's type on both sides (see
# _k3_hold)
K3_STRICT_SHARE = 1e-2
K3_PARITY = ("f32: 2e-5; bf16, p in bf16: 2e-5 plus one bf16 ulp of the "
             "output on exact scores, and on other scores plus one bf16 ulp "
             f"of each p, with at most {K3_STRICT_SHARE} of outputs beyond "
             "2e-5 plus one ulp")
# phase 15: rounds of ROUND_LAUNCHES launches, each kernel and its yardstick
# in turns
ROUNDS, ROUND_LAUNCHES = 5, 20
K3_TIMED = (1, 1536, 16, 128)      # olmo-1b's heads at the longest prompts
K4_TIMED = (1, 1536, 48, 64)       # rwkv6-3b's (padded) heads, the same
K3_TRAIN = (4, 2048, 16, 128)      # olmo-1b's heads at the training shape
K4_TRAIN = (4, 2048, 48, 64)       # rwkv6-3b's, the same
# training traffic of phases 18 and 19: 4 sequences of OLMo-1B's published
# context (2048 tokens) a step
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048
# phase 20: steps of the reduced configs on the card and on the CPU, and
# the relative tolerance of their losses and grad norms (f32 with TF32
# off on both; the CPU tests hold the port to JAX at 2e-4 / 1e-3)
TRAIN_CPU_STEPS, TRAIN_CPU_TOL = 3, (1e-4, 1e-3)
# the backward kernels against their plain versions (see _grad_err)
K3_BWD_TOL, K4_BWD_TOL = 1e-4, 1e-3
K3_BWD_PARITY = (f"dq, dk, dv within {K3_BWD_TOL} of the larger of the "
                 "tensor's largest |entry| and 1e-2 of its products' size, "
                 f"plus {K3_BWD_TOL} relative, bf16 plus one bf16 ulp; lse "
                 "within 2e-5")
K4_BWD_PARITY = (f"dr, dk, dv, dlw, du within {K4_BWD_TOL} of the tensor's "
                 "largest |entry|, bf16 dr/dk/dv plus one bf16 ulp")
# serving traffic of phases 12 and 13: OLMo-1B's published context is
# 2048 tokens
SERVE_REQUESTS, SERVE_SLOTS, SERVE_MAX_LEN = 16, 8, 2048
PROMPT_LENS, MAX_NEW = (256, 1536), 32
# bf16 prefill/decode logits vs forward: at most this many times the
# RMS bf16 rounding error of forward (see _decode_vs_forward)
LOGIT_FACTOR = 3.0
FIELDS = ("score", "end_i", "end_j", "start_i", "start_j", "n_moves",
          "moves")
# phase S, the serving layer: GASAL2's extension regime (PERF.md section 1),
# requests of 100-300 bases in two channels, #2 and #4
SV_KERNELS = ("global_affine", "local_affine")
SV_REQUESTS, SV_LENS, SV_RATE, SV_JUNK = 8192, (100, 300), 0.08, 0.1
SV_MAX_LEN, SV_BLOCK, SV_PREFILTER, SV_DEPTH = 512, 256, 0.1, 2
SV_WORKERS = 2
SV_WARM = 2048                   # the warm run takes the stream's first
SV_DEGRADE = 2048                # the degrade run takes the stream's first
SV_WATERMARK = SV_DEGRADE - 4 * SV_BLOCK  # ... and its first batches degrade
SV_SITES, SV_READS = 256, 4096
SV_TILE_LEN, SV_TILE, SV_OVERLAP = 10_000, 256, 64
SV_BANDED_PAIRS, SV_BANDED_LENS, SV_XDROP = 256, (200, 400), 10
# phase T: the autotuner's candidates kept by the cost model, timing
# repeats per candidate, and rounds x launches of each K1 time alone
TUNE_TOP_K, TUNE_ITERS, TUNE_ROUNDS, TUNE_LAUNCHES = 4, 20, 3, 10
# phase X: X-drop pairs per kernel, their lengths, block, budgets and strip
XD_PAIRS, XD_LENS, XD_BLOCK, XD_VALUES, XD_STRIP = 256, (200, 400), 256, \
    (4, 40), 8
XD_HELD = 32


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


def kernel_device_ms(fn, kernel, rounds=None, launches=None):
    """Time ``fn`` (one launch of a kernel whose name contains ``kernel``
    per call) over ``rounds`` rounds of ``launches`` calls, after a
    warm-up.  Each round gives three numbers per call: the device time,
    the CUDA-event ms around the round's calls made from Python, and the
    host us a call takes to return (its enqueue cost).  The device time is
    that of ``launches`` calls captured once in a CUDA graph and replayed
    between two CUDA events: the wrapper's host work stays out, and each
    launch counts its kernel and the short gap a graph leaves between two
    kernels.  It is not read from torch.profiler, whose CUDA activity on
    the card drops kernel records (0-100 % of a round's, while it holds
    every launch call) once the process has run the mapper; one profiler
    round still counts the records it holds and their mean, for
    comparison.  Returns the three lists, one entry per round, and
    (records held, their mean ms or None).  The capture counts in the
    wrapper's launch counter, so callers restore it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rounds = rounds or ROUNDS
    launches = launches or ROUND_LAUNCHES
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    dev, ev, host = [], [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(stop) / launches)
        ev.append(cuda_time_ms(fn, launches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host.append((time.perf_counter() - t0) / launches * 1e6)
        torch.cuda.synchronize()
    del graph
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    hits = [e.time_range.elapsed_us() for e in prof.events()
            if getattr(e, "device_type", None) == cuda and kernel in e.name]
    check(len(hits) <= launches, f"torch.profiler held {len(hits)} records "
          f"of {kernel} for {launches} calls")
    return dev, ev, host, (len(hits),
                           sum(hits) / len(hits) / 1e3 if hits else None)


# ---------------------------------------------------------------------------
def demangle(names):
    tool = shutil.which("cu++filt") or (
        "/usr/local/cuda/bin/cu++filt"
        if Path("/usr/local/cuda/bin/cu++filt").exists() else None) \
        or shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_table(log):
    """[kernel name, registers, spill bytes, stack frame bytes, mangled
    name] per entry function of an ``nvcc -Xptxas -v`` log."""
    from repro_torch.kernels import build
    rows = [[name, regs, spill, stack, name]
            for name, regs, spill, stack in build.ptxas_entries(log)]
    for row, name in zip(rows, demangle([r[0] for r in rows])):
        row[0] = normal_name(name)
    return rows


def normal_name(name):
    """One spelling for the two demanglers' (cu++filt, c++filt)."""
    name = name.replace("(anonymous namespace)", "<unnamed>")
    name = name.replace("(bool)0", "false").replace("(bool)1", "true")
    return re.sub(r"\(int\)(\d+)", r"\1", name)


def k1_instantiation(spec, mangled=False):
    """The substring of K1's demangled (or mangled) kernel name for
    ``spec``."""
    from repro_torch.core import types as T
    fam = spec.family
    pe = {T.FAMILY_LINEAR: "LinearPE", T.FAMILY_AFFINE: "AffinePE",
          T.FAMILY_TWO_PIECE: "TwoPiecePE"}[fam.family]
    sub = "MatrixSub" if fam.sub == T.SUB_MATRIX else "DnaSub"
    local = "" if fam.family == T.FAMILY_TWO_PIECE else \
        f", {str(bool(fam.local)).lower()}"
    region = {T.REGION_CORNER: 0, T.REGION_ALL: 1, T.REGION_LAST_ROW: 2,
              T.REGION_LAST_ROW_COL: 3}[spec.region]
    banded = str(spec.band is not None).lower()
    if mangled:
        loc = "" if not local else f"ELb{int(bool(fam.local))}"
        return (f"{len(pe)}{pe}INS_{len(sub)}{sub}{loc}EEELi{region}"
                f"ELb{int(spec.band is not None)}EE")
    return f"{pe}<<unnamed>::{sub}{local}>, {region}, {banded}>"


def phase_identity():
    import torch
    from repro_torch.tune.cost import INT32_LANES_PER_SM
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[1] device: {name}, count {count}, {sms} SMs, max SM clock "
          f"{clock_mhz:.0f} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off (matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32})", flush=True)
    print(smi, flush=True)
    return {"name": name, "count": count, "smi": smi, "sms": sms,
            "clock_hz": clock_mhz * 1e6,
            "int32_ops_per_s": sms * INT32_LANES_PER_SM * clock_mhz * 1e6}


def phase_build():
    """One nvcc per kernel source, all started together."""
    from repro_torch.core import kernels_zoo
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.kernels.wkv6 import kernel as K4
    from repro_torch.mapping import extend as extend_mod
    names = ("K1", "K1 ext", "K2", "K3", "K4", "K3 bwd", "K4 bwd")
    sources = (K1.SOURCE, K1.SOURCE_EXT, K2.SOURCE, K3.SOURCE, K4.SOURCE,
               K3.SOURCE_BWD, K4.SOURCE_BWD)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build.load, sources))
    tables = {}
    for name, b in zip(names, built):
        rows = ptxas_table(b.ptxas_log)
        tables[name] = rows
        regs = [r[1] for r in rows]
        print(f"[2] {name}: built {b.path.name} in {b.seconds:.1f} s: "
              f"{len(rows)} kernel instantiations, registers "
              f"{min(regs) if regs else '?'}-{max(regs) if regs else '?'} "
              f"per thread, spill bytes {sum(r[2] for r in rows)}",
              flush=True)
        check(rows, f"ptxas reported no {name} kernels")
    # the instantiations the main paths launch must not spill: K1 for #2
    # (run_pairs), #4 (long reads) and the mapper's extension; every K2
    main = [("#2", kernels_zoo.make(2)[0]), ("#4", kernels_zoo.make(4)[0]),
            ("mapper extension", extend_mod.extension_spec(64, "linear")[0])]
    for what, spec in main:
        key, mkey = k1_instantiation(spec), k1_instantiation(spec, True)
        hit = [r for r in tables["K1"] if key in r[0] or mkey in r[4]]
        check(len(hit) == 1, f"no K1 instantiation {key}")
        check(hit[0][2] == 0, f"K1 {what} spills {hit[0][2]} bytes")
        print(f"    K1 {what} ({key}): {hit[0][1]} registers, no spills",
              flush=True)
    # K1's other families, one row per instantiation; the genotyping
    # path's (pair-HMM forward, logsumexp, last row, unbanded) must not
    # spill
    for name, regs, spill, stack, _ in tables["K1 ext"]:
        print(f"    K1 ext {name}: {regs} registers, {spill} spill bytes, "
              f"{stack} stack bytes", flush=True)
    hit = [r for r in tables["K1 ext"]
           if "16PairHmmForwardPEILi2EEELi2ELb0EE" in r[4]]
    check(len(hit) == 1, "no K1 instantiation for the pair-HMM forward")
    check(hit[0][2] == 0, f"K1 pair-HMM forward spills {hit[0][2]} bytes")
    check(all(r[2] == 0 for r in tables["K2"]), "K2 spills registers")
    print(f"    all {len(sources)} builds: {time.perf_counter() - t0:.1f} s "
          f"wall", flush=True)
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


def _dirty_allocator(*like):
    """Fill blocks of the sizes of ``like``'s tensors with 0xFF and hand
    them back to the caching allocator, which gives them to the next
    allocations of those sizes: a kernel's output then starts as 0xFF.
    Returns the blocks' addresses."""
    import torch
    blocks = [torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                          device=DEVICE).fill_(0xFF) for t in like]
    ptrs = {b.data_ptr() for b in blocks}
    del blocks
    return ptrs


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
            plain = K.wavefront_fill_plain(spec, params, *args, tb_pack=1)
            for pack in sorted({spec.tb_pack, 1}):
                # one plain fill, packed for each tb_pack by the plain
                # version's own pack step
                want = (K.pack_store(plain[0], pack), *plain[1:])
                dirty = _dirty_allocator(*want)
                got = K.wavefront_fill(spec, params, *args, tb_pack=pack)
                torch.cuda.synchronize()
                check(got[0].data_ptr() in dirty, "K1's pointer store did "
                      "not land on the 0xFF block")
                err = max(int((g.long() - w.long()).abs().max())
                          for g, w in zip(got, want))
                max_err = max(max_err, err)
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                check(same, f"K1 != plain: kernel #{kid}, bucket {bucket}, "
                            f"batch {batch}, tb_pack {pack} (max |diff| "
                            f"{err})")
                n += 1
    print(f"[3] K1 == plain on {n} (kernel, bucket, tb_pack) cases "
          f"(tb, best, best_j bit-equal; every output allocated on blocks "
          f"left filled with 0xFF) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return max_err


def _ext_case(case):
    """(label, spec, params) of an EXT_CASES entry."""
    from repro_torch import prob
    from repro_torch.core import kernels_zoo
    if isinstance(case, int):
        spec, params = kernels_zoo.make(case)
        return f"#{case}", spec, params
    direction, objective = case
    mk = prob.pairhmm if direction == "forward" else prob.pairhmm_backward
    spec = mk(objective)
    return spec.name, spec, prob.default_params()


def _ext_codes(rng, spec, shape):
    """Random characters of a spec's alphabet: profile columns, complex
    samples, integer squiggles or DNA codes."""
    import numpy as np
    if spec.char_shape == (5,):
        counts = rng.multinomial(8, [0.22, 0.22, 0.22, 0.22, 0.12],
                                 size=shape)
        return (counts / 8).astype(np.float32)
    if spec.char_shape == (2,):
        return rng.normal(size=shape + (2,)).astype(np.float32)
    if str(spec.char_dtype) == "torch.int32":
        return rng.integers(0, 128, shape).astype(np.int32)
    return rng.integers(0, 4, shape).astype(np.uint8)


def _ext_rtol(spec):
    return 2e-5 if spec.is_sum else 1e-5


def _hold_ext(spec, got, want, what):
    """K1 against its plain version on one batch of a K1-ext family:
    integer outputs bit-equal; float best within the family's rtol (1e-5
    max/min, 2e-5 logsumexp) with the sentinel lanes equal; best_j and the
    pointer store exact for every pair whose best is bit-equal.  Returns
    (largest |diff| of best, its largest relative error, pairs whose best
    is bit-equal, pairs)."""
    import torch
    tb, best, best_j = got
    ptb, pbest, pbest_j = want
    B = best.shape[0]
    if not spec.score_dtype.is_floating_point:
        err = int((best.long() - pbest.long()).abs().max())
        check(all(torch.equal(g, w) for g, w in zip(got, want)
                  if g is not None),
              f"K1 != plain: {what} (max |diff| {err})")
        return err, 0.0, B, B
    sent = float(spec.sentinel())
    dead = pbest == sent
    check(torch.equal(dead, best == sent),
          f"K1 and plain differ on which lanes are dead: {what}")
    diff = (best.double() - pbest.double()).abs()
    rel = torch.where(dead, 0.0, diff / pbest.double().abs().clamp(
        min=1e-30))
    err, rerr = float(torch.where(dead, 0.0, diff).max()), float(rel.max())
    check(rerr <= _ext_rtol(spec), f"K1 != plain: {what} (largest relative "
          f"error {rerr:.3g} > {_ext_rtol(spec)})")
    same = (best == pbest).reshape(B, -1).all(dim=1)
    check(torch.equal(best_j[same], pbest_j[same]),
          f"K1 best_j != plain where best is bit-equal: {what}")
    if tb is not None:
        check(torch.equal(tb[same], ptb[same]),
              f"K1 pointer store != plain where best is bit-equal: {what}")
    return err, rerr, int(same.sum()), B


def phase_ext_vs_plain(rng):
    """3b: K1's f32 max-plus (#8, #10, pair-HMM Viterbi), min-plus (#9 f32,
    #14 int32) and logsumexp (pair-HMM forward and backward)
    instantiations against the plain version at the phase 3 buckets."""
    import numpy as np
    import torch
    from repro_torch.kernels.wavefront import kernel as K
    max_rel, n, equal, total = 0.0, 0, 0, 0
    t0 = time.perf_counter()
    for case in EXT_CASES:
        label, spec, params = _ext_case(case)
        for bucket, batch in ((64, 16), (256, 64), (1024, 4)):
            qs = _ext_codes(rng, spec, (batch, bucket))
            rs = _ext_codes(rng, spec, (batch, bucket))
            ql = rng.integers(bucket // 2, bucket + 1, batch).astype(np.int32)
            ql[0] = bucket
            rl = rng.integers(bucket // 2, bucket + 1, batch).astype(np.int32)
            args = _fill_args(spec, params, qs, rs, ql, rl, "cuda")
            plain = K.wavefront_fill_plain(spec, params, *args, tb_pack=1)
            for pack in sorted({spec.tb_pack, 1}):
                # one plain fill, packed for each tb_pack by the plain
                # version's own pack step
                want = (K.pack_store(plain[0], pack), *plain[1:])
                dirty = _dirty_allocator(*want)
                got = K.wavefront_fill(spec, params, *args, tb_pack=pack)
                torch.cuda.synchronize()
                check(got[0].data_ptr() in dirty and
                      got[1].data_ptr() in dirty, "K1's outputs did not land "
                      "on the 0xFF blocks")
                _, rerr, same, b = _hold_ext(
                    spec, got, want, f"{label}, bucket {bucket}, batch "
                    f"{batch}, tb_pack {pack}")
                max_rel = max(max_rel, rerr)
                equal, total, n = equal + same, total + b, n + 1
    print(f"[3b] K1 == plain on {n} (kernel, bucket, tb_pack) cases of "
          f"#8, #9, #10, #14 and the pair-HMM (forward and backward "
          f"logsumexp, forward max-plus): integers bit-equal, float best "
          f"within rtol 1e-5 (max/min) / 2e-5 (logsumexp), largest relative "
          f"error {max_rel:.3g}; best bit-equal on {equal} of {total} pairs, "
          f"best_j and pointers exact on those; every output allocated on "
          f"blocks left filled with 0xFF; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return max_rel


def _genotyping_sites():
    """GT_SITES sites from sample_site(seed=s), genotypes cycling (0,0),
    (0,1), (1,1); every 8th (s % 8 == 7) with three alternates and
    genotype (1, 3)."""
    from repro_torch.data.synthetic import sample_site
    cycle = [(0, 0), (0, 1), (1, 1)]
    sites = []
    for s in range(GT_SITES):
        multi = s % 8 == 7
        sites.append(sample_site(
            seed=s, hap_len=GT_HAP_LEN, read_len=GT_READ_LEN,
            n_reads=GT_READS, error_rate=0.01,
            genotype=(1, 3) if multi else cycle[s % 3],
            n_alts=3 if multi else 1))
    return sites


def _pairhmm_bound_ms(block, card):
    """The least time the pair-HMM forward takes on one block on this
    card: its MUFU operations at MUFU_PER_SM_CLOCK per SM per clock, or its
    f32 operations at F32_PER_SM_CLOCK, whichever is longer (the bytes a
    block moves are a few MB at 3.35 TB/s, far less).  Counts the live
    cells and the live cells of each pair's last row."""
    cells = _live_cells(block)
    last_row = int(block[4][block[3] > 0].astype("int64").sum())
    mufu = (cells * PAIRHMM_MUFU_PER_CELL
            + last_row * PAIRHMM_MUFU_PER_LAST_ROW_CELL)
    f32 = (cells * PAIRHMM_F32_PER_CELL
           + last_row * PAIRHMM_F32_PER_LAST_ROW_CELL)
    rate = card["sms"] * card["clock_hz"]
    mufu_ms = mufu / (MUFU_PER_SM_CLOCK * rate) * 1e3
    f32_ms = f32 / (F32_PER_SM_CLOCK * rate) * 1e3
    return max(mufu_ms, f32_ms), mufu_ms, f32_ms


def phase_genotyping(card):
    """Pair-HMM genotyping at GATK's shapes: every read x haplotype pair of
    GT_SITES sites through one run_pairs on K1's logsumexp instantiation,
    the calls per site, call_site on a few sites, and K1 held and timed on
    the path's fullest block."""
    import numpy as np
    import torch
    from repro_torch import prob
    from repro_torch.core.spec_utils import params_on_device
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.runtime import dispatch
    t0 = time.perf_counter()
    sites = _genotyping_sites()
    pairs, spans = [], []
    for site in sites:
        spans.append((len(pairs), len(site.reads), len(site.haplotypes)))
        pairs.extend((r, h) for r in site.reads for h in site.haplotypes)
    setup_s = time.perf_counter() - t0
    cells = sum(len(q) * len(r) for q, r in pairs)
    spec, params = prob.cached_pairhmm(), prob.default_params()
    blocks = _blocks(pairs, GT_BLOCK)

    dispatch.run_pairs(spec, params, pairs[:GT_BLOCK], block=GT_BLOCK,
                       with_traceback=False)                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    t1 = time.perf_counter()
    outs = dispatch.run_pairs(spec, params, pairs, block=GT_BLOCK,
                              with_traceback=False)
    scores = np.asarray([float(o.score) for o in outs], np.float64)
    wall = time.perf_counter() - t1
    launches = K.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == len(blocks), f"genotyping launched K1 {launches} "
          f"times for {len(blocks)} blocks")
    check(np.isfinite(scores).all() and (scores < 0).all(),
          "genotyping: a likelihood is not a finite log-probability")

    t2 = time.perf_counter()
    calls, gq, site_calls = [], [], []
    for site, (start, n_r, n_h) in zip(sites, spans):
        ll = scores[start:start + n_r * n_h].reshape(n_r, n_h)
        ll = ll - np.log([max(len(h), 1) for h in site.haplotypes])[None, :]
        out = prob.call_genotype(ll)
        calls.append(out["GT"] == tuple(site.genotype))
        gq.append(out["GQ"])
        if len(site_calls) < SV_SITES:       # phase S holds its service
            out["ll"] = ll                    # to these calls
            site_calls.append(out)
    call_s = time.perf_counter() - t2
    concord = sum(calls) / len(calls)
    check(concord >= 0.99, f"genotype concordance {concord:.4f} < 0.99")

    # the entry point itself on the card, on a few sites
    K.launches = 0
    for site in sites[:3] + sites[7:8]:
        out = prob.call_site(site.reads, site.haplotypes, block=64)
        check(out["GT"] == tuple(site.genotype),
              f"call_site called {out['GT']} for {site.genotype}")
    check(K.launches > 0, "call_site did not reach K1")
    site_launches = K.launches

    # the first 64 pairs against the CPU path
    cpu = dispatch.run_pairs(spec, params, pairs[:64], block=64,
                             with_traceback=False, device="cpu")
    cpu = np.asarray([float(o.score) for o in cpu])
    rel64 = float(np.max(np.abs(scores[:64] - cpu) / np.abs(cpu)))
    check(rel64 <= 2e-5, f"genotyping: the first 64 likelihoods differ from "
          f"the CPU path by {rel64:.3g} (> 2e-5)")
    print(f"[G] genotyping: {len(sites)} sites ({GT_HAP_LEN}-base "
          f"haplotypes, {GT_READS} reads of {GT_READ_LEN}, 1 % error; every "
          f"8th site 3 alternates), {len(pairs)} read x haplotype pairs, "
          f"{cells} cells, made in {setup_s:.1f} s; run_pairs (block "
          f"{GT_BLOCK}, {len(blocks)} blocks, K1 logsumexp): {wall:.3f} s "
          f"wall to the host read, {len(pairs) / wall:.0f} pairs/s, "
          f"{len(sites) / wall:.1f} sites/s (calls {call_s:.3f} s more), "
          f"{cells / wall / 1e9:.2f} GCUPS; K1 launches {launches}; "
          f"concordance {concord:.4f} ({sum(calls)} of {len(calls)}); mean "
          f"GQ {np.mean(gq):.1f}; peak device memory {peak / 2**20:.1f} MiB; "
          f"call_site on 4 sites: right, {site_launches} K1 launches; first "
          f"64 likelihoods within {rel64:.3g} of the CPU path", flush=True)

    # K1 against its plain version, and timed, on the fullest block, with
    # the parameters on the card as run_pairs holds them
    block = max(blocks, key=_live_cells)
    (bq, br), qs, rs, ql, rl = block
    params = params_on_device(params, DEVICE)
    args = _fill_args(spec, params, qs, rs, ql, rl, DEVICE)
    before = K.launches
    got = K.wavefront_fill(spec, params, *args, with_tb=False)
    want = []
    plain_ms = cuda_time_ms(lambda: want.extend(K.wavefront_fill_plain(
        spec, params, *args, with_tb=False)), 1)
    _, rerr, same, B = _hold_ext(spec, got, want,
                                 f"genotyping block {bq}x{br}")
    dev, ev, host, prof = kernel_device_ms(
        lambda: K.wavefront_fill(spec, params, *args, with_tb=False),
        "wavefront")
    K.launches = before
    ms = statistics.median(dev)
    live = _live_cells(block)
    bound_ms, mufu_ms, f32_ms = _pairhmm_bound_ms(block, card)
    print(f"    K1 logsumexp timed at batch {B}, {bq}x{br} (the fullest "
          f"block, {live} live cells): {_spread_line(dev, ev, host, prof)}; "
          f"plain {plain_ms:.1f} ms; bound {bound_ms:.4f} ms by operations "
          f"(MUFU {mufu_ms:.4f} ms at {PAIRHMM_MUFU_PER_CELL} a cell and "
          f"{PAIRHMM_MUFU_PER_LAST_ROW_CELL} more on the last row, f32 "
          f"{f32_ms:.4f} ms at {PAIRHMM_F32_PER_CELL} and "
          f"{PAIRHMM_F32_PER_LAST_ROW_CELL}); "
          f"{100 * bound_ms / ms:.1f} % of the bound; "
          f"{live / ms / 1e6:.1f} GCUPS live; largest relative error vs "
          f"plain {rerr:.3g} (best bit-equal on {same} of {B} pairs); "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "ms": ms, "ms_range": [min(dev), max(dev)],
            "event_ms": statistics.median(ev),
            "host_us": statistics.median(host), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            "max_rel_err": max(rerr, rel64), "pairs_per_s": len(pairs) / wall,
            "sites_per_s": len(sites) / wall, "gcups": cells / wall / 1e9,
            "concordance": concord, "profiler_records": prof[0],
            "sites": sites, "calls": site_calls}


def phase_posterior(sites):
    """forward_backward on four 150 x 400 pairs of the genotyping sites on
    the card's reference engine, against its identities and the CPU
    path."""
    import numpy as np
    import torch
    from repro_torch import prob
    params = prob.default_params()
    worst = [0.0, 0.0, 0.0]
    t0 = time.perf_counter()
    dims = []
    for site in sites[:4]:
        read, hap = site.reads[0], site.haplotypes[0]
        dims.append(f"{len(read)}x{len(hap)}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = prob.forward_backward(params, read, hap)
        ms = (time.perf_counter() - t1) * 1e3
        cpu = prob.forward_backward(params, read, hap, device="cpu")
        z = abs(got.log_z_backward - got.log_z) / abs(got.log_z)
        rows = got.post_match.sum(axis=1) + got.post_ins.sum(axis=1)
        row_err = float(np.abs(rows - 1.0).max())
        cpu_err = max(float(np.abs(got.post_match - cpu.post_match).max()),
                      float(np.abs(got.post_ins - cpu.post_ins).max()),
                      abs(got.log_z - cpu.log_z) / abs(cpu.log_z))
        check(z <= 1e-4, f"posterior: log_z_backward differs from log_z by "
              f"rel {z:.3g}")
        check(row_err <= 5e-4, f"posterior: a row sums to 1 +- {row_err:.3g}")
        check(cpu_err <= 1e-4, f"posterior: card and CPU differ by "
              f"{cpu_err:.3g}")
        worst = [max(worst[0], z), max(worst[1], row_err),
                 max(worst[2], cpu_err)]
        dims[-1] += f" {ms:.0f} ms"
    print(f"[P] posterior on the card's reference engine, pairs "
          f"{', '.join(dims)} (forward and backward fill each): "
          f"log_z_backward within rel {worst[0]:.3g} of log_z, rows sum to "
          f"1 within {worst[1]:.3g}, CPU path within {worst[2]:.3g}; "
          f"{time.perf_counter() - t0:.1f} s with the CPU path", flush=True)


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
    (bq, br), qs, rs, ql, rl = block
    args = _fill_args(spec, params, qs, rs, ql, rl, DEVICE)
    err, plain_ms = _hold_args(spec, params, args,
                               {"tb_pack": spec.tb_pack}, what)
    return args, err, plain_ms


def _hold_args(spec, params, args, kw, what):
    """K1 and its plain version on the same fill arguments (query, ref,
    boundaries, lens on the card) and keywords: every output bit-equal
    (the pointer store, when there is one, best, best_j); returns the
    largest |difference| and the plain version's ms."""
    import torch
    from repro_torch.kernels.wavefront import kernel as K
    B, bq, br = args[0].shape[0], args[0].shape[1], args[1].shape[1]
    got = K.wavefront_fill(spec, params, *args, **kw)
    want = []
    plain_ms = cuda_time_ms(lambda: want.extend(K.wavefront_fill_plain(
        spec, params, *args, **kw)), 1)
    pairs = [(g, w) for g, w in zip(got, want) if g is not None or
             w is not None]
    check(all(g is not None and w is not None and g.shape == w.shape
              for g, w in pairs),
          f"K1 and plain outputs differ in shape on the {what} block "
          f"{bq}x{br}")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in pairs)
    check(all(torch.equal(g, w) for g, w in pairs),
          f"K1 != plain on the {what} block {bq}x{br} (batch {B}, "
          f"max |diff| {err})")
    return err, plain_ms


def _live_in_band(ql, rl, band):
    """Cells (i, j) with i <= q_len, j <= r_len and |i - j| <= band, summed
    over the pairs (all of q_len x r_len when band is None)."""
    import numpy as np
    ql, rl = ql.astype("int64"), rl.astype("int64")
    if band is None:
        return int((ql * rl).sum())
    total = 0
    for q, r in zip(ql, rl):
        i = np.arange(1, q + 1)
        total += int((np.minimum(r, i + band)
                      - np.maximum(1, i - band) + 1).clip(min=0).sum())
    return total


def _spread_line(dev, ev, host, prof):
    held, mean = prof
    seen = (f"torch.profiler held {held} of {ROUND_LAUNCHES} kernel records"
            + (f", mean {mean:.4f} ms" if mean is not None else ""))
    return (f"device {_spread(dev)} (CUDA graph of the launches between "
            f"events); events {statistics.median(ev):.4f} ms/call; host "
            f"{statistics.median(host):.1f} us/call; {seen}")


def time_k1(spec, params, block, card, what, plain_ms=None):
    """K1 alone on one padded block: device time over ROUNDS rounds of
    ROUND_LAUNCHES launches (kernel_device_ms) and its bound on this card,
    which counts the live cells inside the band only."""
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.tune.cost import MEM_BYTES_PER_S, PE_OPS, k1_bytes
    (bq, br), qs, rs, ql, rl = block
    args = _fill_args(spec, params, qs, rs, ql, rl, DEVICE)
    pack = spec.tb_pack
    before = K.launches
    dev, ev, host, prof = kernel_device_ms(
        lambda: K.wavefront_fill(spec, params, *args, tb_pack=pack),
        "wavefront")
    K.launches = before
    ms = statistics.median(dev)
    B = qs.shape[0]
    cells = _live_in_band(ql, rl, spec.band)
    ops = PE_OPS[(spec.family.family, spec.family.local)] * cells
    nbytes = k1_bytes(spec, B, bq, br, pack)
    ops_ms = ops / card["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    plain = f"plain {plain_ms:.1f} ms; " if plain_ms is not None else ""
    print(f"    K1 timed at batch {B}, {bq}x{br}, {what}, tb_pack {pack}: "
          f"{_spread_line(dev, ev, host, prof)}; {plain}bound "
          f"{bound_ms:.4f} ms "
          f"by {bound_by} (int32 ops {ops_ms:.4f} ms for {cells} live "
          f"cells{'' if spec.band is None else ' in the band'}, bytes "
          f"{bytes_ms:.4f} ms for {nbytes} B); {100 * bound_ms / ms:.1f} % "
          f"of the bound; {cells / ms / 1e6:.1f} GCUPS live", flush=True)
    return {"ms": ms, "ms_range": [min(dev), max(dev)],
            "event_ms": statistics.median(ev),
            "host_us": statistics.median(host), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "profiler_records": prof[0]}


def k1_experiments(spec, params, block):
    """K1 on its timed block without the pointer store, and on the block's
    first 132, 264 and 528 pairs (one pair per SM and more): what the store
    costs, and whether the time follows the warps in flight."""
    from repro_torch.kernels.wavefront import kernel as K
    (bq, br), qs, rs, ql, rl = block
    before = K.launches
    for rows, with_tb in ((None, False), (132, True), (264, True),
                          (528, True)):
        args = _fill_args(spec, params, qs[:rows], rs[:rows], ql[:rows],
                          rl[:rows], DEVICE)
        dev, ev, host, prof = kernel_device_ms(
            lambda: K.wavefront_fill(spec, params, *args,
                                     tb_pack=spec.tb_pack, with_tb=with_tb),
            "wavefront")
        print(f"    K1 at batch {len(ql[:rows])}, {bq}x{br}, pointer store "
              f"{'on' if with_tb else 'off'}: "
              f"{_spread_line(dev, ev, host, prof)}", flush=True)
    K.launches = before


def phase_path_shapes(main_blocks, long_blocks, card):
    """K1 vs plain on one block of every bucket shape the main path and the
    long-read run gave K1, then K1 timed at the main path's largest one and
    at the fullest long-read block."""
    from repro_torch.core import kernels_zoo
    max_err, held, timed = 0, [], {}
    for kid, blocks, what in ((2, main_blocks, "main path"),
                              (4, long_blocks, "long-read")):
        spec, params = kernels_zoo.make(kid)
        for block in _fullest_per_bucket(blocks):
            _, err, plain_ms = _hold_to_plain(spec, params, block, what)
            max_err = max(max_err, err)
            held.append(f"#{kid} {block[0][0]}x{block[0][1]}")
            timed[kid] = (spec, params, block, plain_ms)   # the largest
    print(f"[6] K1 == plain (tb, best, best_j bit-equal) on the fullest block "
          f"of each path shape: {', '.join(held)}", flush=True)
    out = time_k1(*timed[2][:3], card, "#2", timed[2][3])
    k1_experiments(*timed[2][:3])
    out["long_read"] = time_k1(*timed[4][:3], card, "#4", timed[4][3])
    out["max_abs_err"] = max_err
    return out


def _tune_points():
    """Phase T's points: (label, spec, params, bucket, batch) at the shapes
    the main path, the long reads and genotyping give K1."""
    from repro_torch import prob
    from repro_torch.core import kernels_zoo
    return [("#2", *kernels_zoo.make(2), (256, 256), 1024),
            ("#4", *kernels_zoo.make(4), (1024, 1024), 256),
            ("pair-HMM forward", prob.cached_pairhmm(), prob.default_params(),
             (256, 512), GT_BLOCK)]


def _tuned_plan_checks(table, points):
    """With ``table`` installed, ``get_plan`` given no option takes the
    table's; an explicit option wins; REPRO_TORCH_TUNE_TABLE=off restores
    the hand-picked defaults (K1's heuristic warps)."""
    import os
    from repro_torch import tune
    from repro_torch.runtime import plan as plan_mod
    tune.set_table(table)
    try:
        for what, spec, _, bucket, batch in points:
            char = tuple(spec.char_shape)
            shapes = ((bucket[0],) + char, (bucket[1],) + char)

            def key(**kw):
                return plan_mod.get_plan(spec, "wavefront", *shapes,
                                         batch_size=batch, mode="fill",
                                         device=DEVICE, **kw).key
            want = table.lookup_options(spec.name, "wavefront", bucket,
                                        batch, device=DEVICE)
            check(want is not None, f"phase T: {what}: no table entry")
            got = key()
            check({k: getattr(got, k) for k in want} == want,
                  f"phase T: {what}: get_plan took {got} for the table's "
                  f"{want}")
            got = key(tb_pack=spec.tb_pack)
            check(got.strip_warps is None,
                  f"phase T: {what}: an explicit option lost to the table")
            os.environ[tune.ENV_VAR] = "off"
            try:
                got = key()
            finally:
                del os.environ[tune.ENV_VAR]
            check((got.strip_warps, got.tb_pack) == (None, spec.tb_pack),
                  f"phase T: {what}: {tune.ENV_VAR}=off gave {got}")
    finally:
        tune.set_table(None)


def phase_tune(card):
    """The autotuner at the main paths' full shapes (phase T), then the
    plan linter over the port's registry on the card."""
    import numpy as np
    from repro_torch import analyze, tune
    from repro_torch.core.spec_utils import params_on_device
    from repro_torch.kernels.wavefront import kernel as K
    t0 = time.perf_counter()
    points = _tune_points()
    table = tune.TuningTable()
    out, launches = [], 0
    for what, spec, params, bucket, batch in points:
        K.launches = 0
        try:
            res = tune.tune_point(spec, params, "wavefront", bucket, batch,
                                  mode="fill", top_k=TUNE_TOP_K,
                                  iters=TUNE_ITERS, seed=SEED, device=DEVICE)
        except AssertionError as e:
            raise SmokeFailure(f"phase T: {what}: a candidate differs from "
                               f"the default plan: {e}")
        launches += K.launches
        check(K.launches > 0, f"phase T: {what}: the tuner launched no K1")
        table.record(spec.name, "wavefront", bucket, batch, res["options"],
                     device=DEVICE,
                     speedup_vs_default=res["speedup_vs_default"])
        # the same inputs tune_point drew, each candidate's K1 alone
        data = tune.make_batch(np.random.default_rng(SEED), spec, bucket,
                               batch, DEVICE)
        args = _fill_args(spec, params, *data, DEVICE)
        # tables on the card before the graph capture: a capture may not
        # copy from pageable host memory
        params = params_on_device(params, DEVICE)
        heuristic = K.strip_warps(bucket[0], batch, card["sms"])
        rows = []
        before = K.launches
        for m in res["measurements"]:
            o = m["options"]
            dev, _, _, _ = kernel_device_ms(
                lambda: K.wavefront_fill(spec, params, *args,
                                         tb_pack=o["tb_pack"],
                                         warps=o["strip_warps"]),
                "wavefront", rounds=TUNE_ROUNDS, launches=TUNE_LAUNCHES)
            rows.append({"options": o, "k1_ms": statistics.median(dev),
                         "k1_ms_range": [min(dev), max(dev)],
                         "plan_ms": m["seconds"] * 1e3,
                         "predicted_ms": m["predicted_s"] * 1e3})
        K.launches = before
        default = next(r for r in rows
                       if r["options"] == res["default_options"])
        winner = next(r for r in rows if r["options"] == res["options"])
        fastest = min(rows, key=lambda r: r["k1_ms"])
        print(f"[T] {what}: batch {batch}, {bucket[0]}x{bucket[1]}, "
              f"{len(rows)} candidates timed of "
              f"{len(rows) + res['n_pruned']} (the model pruned "
              f"{res['n_pruned']}), each bit-equal to the default plan "
              f"(heuristic: {heuristic} warps a pair, tb_pack "
              f"{spec.tb_pack}):", flush=True)
        for r in rows:
            o = r["options"]
            warps = o["strip_warps"] or f"None ({heuristic})"
            print(f"    strip_warps {warps}, tb_pack {o['tb_pack']}: K1 "
                  f"{r['k1_ms']:.4f} ms "
                  f"({r['k1_ms_range'][0]:.4f}-{r['k1_ms_range'][1]:.4f}, "
                  f"{TUNE_ROUNDS} rounds of {TUNE_LAUNCHES}), fill plan "
                  f"{r['plan_ms']:.4f} ms, predicted {r['predicted_ms']:.4f}"
                  f" ms", flush=True)
        print(f"    winner (fill plan time) {res['options']}: "
              f"{res['speedup_vs_default']:.3f}x the default's plan, K1 "
              f"{default['k1_ms'] / winner['k1_ms']:.3f}x; fastest K1 alone "
              f"{fastest['options']} at "
              f"{default['k1_ms'] / fastest['k1_ms']:.3f}x the default",
              flush=True)
        out.append({"point": what, "batch": batch, "bucket": list(bucket),
                    "heuristic_warps": heuristic, "winner": res["options"],
                    "plan_speedup": res["speedup_vs_default"],
                    "k1_speedup": default["k1_ms"] / winner["k1_ms"],
                    "candidates": rows})
    _tuned_plan_checks(table, points)
    print(f"    get_plan takes the table's options with none passed, "
          f"explicit options win, {tune.ENV_VAR}=off restores the "
          f"heuristic; table: {json.dumps(table.entries, sort_keys=True)}",
          flush=True)
    report = analyze.lint_all()
    ptxas = sorted({f.message for f in report.findings
                    if f.rule == "R401" and "registers" in f.message})
    print(f"    lint_all on the card: {report.points} plan points, "
          f"{len(report.errors)} errors, "
          f"{len(report.by_severity(analyze.WARNING))} warnings; "
          f"{'; '.join(ptxas)}", flush=True)
    check(report.ok, "phase T: lint_all found errors:\n"
          + report.format_text())
    print(f"    phase T: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"points": out, "launches": launches,
            "lint": {"points": report.points,
                     "warnings": len(report.by_severity(analyze.WARNING))}}


def phase_xdrop(genome):
    """X-drop on the card (phase X): run_pairs through the wavefront engine
    with xdrop set runs the eager engine, never K1, and equals the CPU
    path; the same pairs without xdrop launch K1."""
    import numpy as np
    import torch
    from repro_torch.core import kernels_zoo
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.runtime import dispatch
    from repro_torch.runtime import plan as plan_mod
    from repro_torch.runtime import registry
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for kid in (4, 2):
        spec, params = kernels_zoo.make(kid)
        pairs = _read_pairs(rng, genome, XD_PAIRS, *XD_LENS, 0.08,
                            XD_LENS[1])
        K.launches = 0
        t0 = time.perf_counter()
        exact = dispatch.run_pairs(spec, params, pairs, block=XD_BLOCK,
                                   strip=XD_STRIP)
        torch.cuda.synchronize()
        k1_wall = time.perf_counter() - t0
        k1_launches = K.launches
        check(k1_launches == len(_blocks(pairs, XD_BLOCK)),
              f"phase X: #{kid} without xdrop launched K1 {k1_launches} "
              f"times")
        walls = {}
        for xdrop in XD_VALUES:
            K.launches = 0
            t0 = time.perf_counter()
            got = dispatch.run_pairs(spec, params, pairs, block=XD_BLOCK,
                                     xdrop=xdrop, strip=XD_STRIP)
            torch.cuda.synchronize()
            walls[xdrop] = time.perf_counter() - t0
            check(K.launches == 0, f"phase X: #{kid} xdrop {xdrop} "
                  f"launched K1 {K.launches} times")
            want = dispatch.run_pairs(spec, params, pairs[:XD_HELD],
                                      block=XD_HELD, device="cpu",
                                      xdrop=xdrop, strip=XD_STRIP)
            _compare_results(got[:XD_HELD], want, f"phase X #{kid} xdrop "
                             f"{xdrop}")
            changed = sum(int(g.score) != int(e.score)
                          for g, e in zip(got, exact))
            print(f"[X] #{kid} {spec.name}, {len(pairs)} pairs of "
                  f"{XD_LENS[0]}-{XD_LENS[1]} bases, xdrop {xdrop}, strip "
                  f"{XD_STRIP}: {walls[xdrop]:.3f} s wall on the eager "
                  f"engine, K1 launches 0; first {XD_HELD} equal to the CPU "
                  f"path; {changed} scores differ from the exact fill",
                  flush=True)
        fills = {p["key"].xdrop: p["fill"]
                 for p in plan_mod.plan_cache_info()["plans"]
                 if p["key"].kernel == spec.name
                 and p["key"].engine == "wavefront"}
        check(all(fills[x] == registry.ENGINE_FILL for x in XD_VALUES)
              and fills[None] == registry.K1_FILL,
              f"phase X: plan_cache_info names the fills {fills}")
        print(f"    the same pairs without xdrop: {k1_wall:.3f} s wall, "
              f"K1 launches {k1_launches}; plan_cache_info fills {fills}",
              flush=True)
        out[f"#{kid}"] = {"xdrop_wall_s": walls, "k1_wall_s": k1_wall,
                          "k1_launches": k1_launches}
    return out


def _k2_args(qs, rs, ql, rl):
    import numpy as np
    import torch
    lens = np.stack([ql, rl], axis=1).astype(np.int32)
    return (torch.as_tensor(qs, device=DEVICE),
            torch.as_tensor(rs, device=DEVICE),
            torch.as_tensor(lens, device=DEVICE))


def _k2_hold(q, r, lens, glob, k, what):
    """K2 and its plain version on one batch (the plain sweep, which also
    reports the columns each pair ran): those columns, the largest
    |difference| and the plain version's ms."""
    import torch
    from repro_torch.core import myers as M
    from repro_torch.kernels.myers import kernel as K2
    got = K2.myers_fill(q, r, lens, glob=glob, k=k)
    want = []
    plain_ms = cuda_time_ms(lambda: want.extend(
        M.sweep(q, r, lens, glob=glob, k=k)), 1)
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want[:3])),
          f"K2 != plain: {what} (max |diff| {err})")
    return want[3], err, plain_ms


def _k_exit_rows(trail, lens, glob, k):
    """The rows the provable-k exit stops, from the plain version's k = -1
    score trail: a row stops at the first column j <= r_len where
    min(best before j, score after column j - 1 - columns left) > k."""
    import numpy as np
    from repro_torch.core import types as T
    if k < 0:
        return np.zeros(len(lens), bool)
    s = trail.astype(np.int64)
    B, n_cols = s.shape[0], s.shape[1] - 1
    r_len = lens[:, 1].astype(np.int64)[:, None]
    j = np.arange(1, n_cols + 1)[None, :]
    sent = np.full((B, 1), T.INT_SENTINEL, np.int64)
    best = (np.broadcast_to(sent, (B, n_cols)) if glob else
            np.minimum.accumulate(np.concatenate([sent, s[:, 1:-1]], 1), 1))
    reach = np.minimum(best, s[:, :-1] - (r_len - (j - 1)))
    return ((reach > k) & (j <= r_len)).any(1)


def phase_k2_vs_plain(rng):
    """K2 at k -1, 0 and bucket / 10 against one plain sweep per case at
    k = -1: a row the exit rule stops on the plain version's score trail
    expects the sentinel, every other row the plain answer."""
    import numpy as np
    import torch
    from repro_torch.core import alphabets
    from repro_torch.core import myers as M
    from repro_torch.core import types as T
    from repro_torch.kernels.myers import kernel as K2
    t0 = time.perf_counter()
    max_err, n = 0, 0
    for kid in (16, 17):
        for bucket in (64, 256, 1024):
            B = 64
            # at 1024 (16 words) the plain sweep takes most of the phase:
            # mutated pairs only there
            for kind in ("random", "mutated")[bucket == 1024:]:
                qs = rng.integers(0, 4, (B, bucket)).astype(np.uint8)
                ql = rng.integers(bucket // 2, bucket + 1, B).astype(np.int32)
                ql[0], ql[1] = 1, bucket
                rs = rng.integers(0, 4, (B, bucket)).astype(np.uint8)
                rl = rng.integers(bucket // 2, bucket + 1, B).astype(np.int32)
                if kind == "mutated":
                    for b in range(B):
                        m = alphabets.mutate(rng, qs[b, :ql[b]], 0.08)[:bucket]
                        m = m if len(m) else qs[b, :1]
                        rs[b, :len(m)] = m
                        rl[b] = len(m)
                args = _k2_args(qs, rs, ql, rl)
                glob = kid == 16
                *plain, _, trail = M.sweep(*args, glob=glob, k=-1, trace=True)
                lens = args[2].cpu().numpy()
                for k in (-1, 0, bucket // 10):
                    stop = torch.as_tensor(
                        _k_exit_rows(trail.cpu().numpy(), lens, glob, k),
                        device=DEVICE)
                    want = [torch.where(stop, fill, p) for p, fill in
                            zip(plain, (T.INT_SENTINEL, T.INT_SENTINEL, 0))]
                    dirty = _dirty_allocator(*want)
                    got = K2.myers_fill(*args, glob=glob, k=k)
                    check(got[0].data_ptr() in dirty, "K2's score did not "
                          "land on the 0xFF block")
                    err = max(int((g.long() - w.long()).abs().max())
                              for g, w in zip(got, want))
                    max_err = max(max_err, err)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"K2 != plain: #{kid}, bucket {bucket}, {kind}, "
                          f"k {k} (max |diff| {err})")
                    n += 1
    print(f"[7] K2 == plain on {n} cases (#16/#17 x buckets 64/256 x "
          f"random/mutated and 1024 x mutated, x k -1/0/bucket/10; score, "
          f"best, best_j "
          f"bit-equal on blocks left filled with 0xFF; k >= 0 from the "
          f"k = -1 sweep's score trail) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return max_err


def _mapper_inputs():
    """The reference, the simulated reads with their truth, and the reads
    the mapper gets (simulated first, then junk), all from SEED."""
    import numpy as np
    from repro_torch.core import alphabets
    from repro_torch.data.synthetic import sample_reads
    rng = np.random.default_rng(SEED)
    ref = alphabets.random_dna(rng, E_COLI_LEN)
    for s in rng.integers(0, E_COLI_LEN - 200, 16):
        ref[s:s + 200] = 4
    rs = sample_reads(ref, N_READS, READ_LEN, error_rate=0.05, seed=SEED)
    reads = [rs.reads[i, :rs.lens[i]] for i in range(N_READS)]
    reads += [alphabets.random_dna(rng, READ_LEN) for _ in range(N_JUNK)]
    return ref, rs, reads


def _staged_run(mapper, ref, reads, names):
    """map_reads again, one stage at a time in its order, each stage's time
    on the host clock between synchronisations; returns the records, the
    stage times, the screened and the extended jobs."""
    import torch
    from repro_torch.mapping import index as index_mod
    sync = torch.cuda.synchronize
    t = {}
    t0 = time.perf_counter()
    index_mod.build_index(ref, k=mapper.index.k, w=mapper.index.w,
                          device=DEVICE)
    sync()
    t1 = time.perf_counter()
    t["index build"] = t1 - t0
    read_list = mapper._as_read_list(reads, None)
    fwd, rc = mapper._chain_reads(read_list)
    sync()
    t2 = time.perf_counter()
    t["seed+chain"] = t2 - t1
    jobs, meta, recs = mapper._plan_jobs(read_list, names, fwd, rc)
    t3 = time.perf_counter()
    screened = jobs
    jobs, meta = mapper._screen(jobs, meta, recs, read_list, names)
    sync()
    t4 = time.perf_counter()
    t["screen (K2)"] = t4 - t3
    ext = mapper._extend(jobs)
    sync()
    t5 = time.perf_counter()
    t["extension (K1 + walk)"] = t5 - t4
    recs = mapper._emit(ext, meta, recs, read_list, names)
    t["host/SAM"] = (t3 - t2) + (time.perf_counter() - t5)
    return recs, t, screened, jobs


def phase_mapper(card):
    """The read mapper at a real size on the card, its checks, and the K1
    and K2 holds on its own blocks."""
    import math
    import torch
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.mapping import ReadMapper
    from repro_torch.mapping import extend as extend_mod
    t_in = time.perf_counter()
    ref, rs, reads = _mapper_inputs()
    names = [f"read{i}" for i in range(len(reads))]
    t_in = time.perf_counter() - t_in
    mapper = ReadMapper(ref, block=MAPPER_BLOCK, screen_block=MAPPER_BLOCK,
                        device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = K2.launches = 0
    t0 = time.perf_counter()
    records = mapper.map_reads(reads, names=names)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_runs, k2_runs = K1.launches, K2.launches
    peak = torch.cuda.max_memory_allocated()

    hits = sum(rec.is_mapped and abs(rec.pos - 1 - int(p)) <= 5
               and rec.is_reverse == bool(s)
               for rec, p, s in zip(records, rs.pos, rs.strand))
    junk = sum(rec.is_mapped for rec in records[N_READS:])
    check(hits >= 0.95 * N_READS, f"mapper: {hits} of {N_READS} simulated "
          f"reads within 5 bases on the right strand (< 95 %)")
    check(junk <= 0.01 * N_JUNK, f"mapper: {junk} of {N_JUNK} junk reads "
          f"mapped (> 1 %)")

    staged, stages, screened, extended = _staged_run(mapper, ref, reads,
                                                     names)
    check([r.to_line() for r in staged] == [r.to_line() for r in records],
          "mapper: the staged run differs from map_reads")
    screen_blocks = _blocks([(j.read, j.window) for j in screened],
                            MAPPER_BLOCK)
    by_band = {}
    for j in extended:
        by_band.setdefault(j.band, []).append((j.read, j.window))
    ext_blocks = {band: _blocks(pairs, MAPPER_BLOCK)
                  for band, pairs in sorted(by_band.items())}
    n_ext = sum(len(b) for b in ext_blocks.values())
    check(k2_runs == len(screen_blocks), f"mapper launched K2 {k2_runs} "
          f"times for {len(screen_blocks)} screen blocks")
    check(k1_runs == n_ext, f"mapper launched K1 {k1_runs} times for "
          f"{n_ext} extension blocks")

    pick = list(range(224)) + list(range(N_READS, N_READS + 32))
    cpu = ReadMapper(ref, device="cpu")
    want = cpu.map_reads([reads[i] for i in pick],
                         names=[names[i] for i in pick])
    for i, w in zip(pick, want):
        check(records[i].to_line() == w.to_line(),
              f"mapper: read {i} differs from the CPU path")

    print(f"[8] mapper: {len(reads)} reads ({N_READS} simulated, {N_JUNK} "
          f"junk) on a {E_COLI_LEN}-base reference: map_reads {wall:.3f} s "
          f"wall, {len(reads) / wall:.0f} reads/s; {hits} simulated reads "
          f"({100 * hits / N_READS:.2f} %) within 5 bases on the right "
          f"strand, {junk} junk reads mapped; input simulation {t_in:.1f} "
          f"s", flush=True)
    print(f"    launches: K2 {k2_runs} (= screen blocks), K1 {k1_runs} (= "
          f"extension blocks over bands {sorted(ext_blocks)}); screen "
          f"rejected {len(screened) - len(extended)} of {len(screened)} "
          f"jobs; peak device memory {peak / 2**20:.1f} MiB; 256 records "
          f"equal to the CPU path", flush=True)
    print("    stages (staged run, host clock between synchronisations): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()),
          flush=True)

    k1_before, k2_before = K1.launches, K2.launches
    k1_err, held, fullest = 0, [], None
    for band, blocks in ext_blocks.items():
        spec, params = extend_mod.extension_spec(band, mapper.gap_mode)
        for block in _fullest_per_bucket(blocks):
            _, err, plain_ms = _hold_to_plain(spec, params, block,
                                              f"mapper band-{band}")
            k1_err = max(k1_err, err)
            held.append(f"band {band} {block[0][0]}x{block[0][1]}")
            cells = _live_in_band(block[3], block[4], band)
            if fullest is None or cells > fullest[0]:
                fullest = (cells, spec, params, block, plain_ms, band)
    print(f"    K1 == plain (tb, best, best_j bit-equal) on the fullest "
          f"extension block of each shape: {', '.join(held)}", flush=True)
    _, spec, params, block, plain_ms, band = fullest
    k1_ext = time_k1(spec, params, block, card,
                     f"band-{band} semiglobal {mapper.gap_mode} (the "
                     f"fullest extension block)", plain_ms)
    k = max(math.ceil(mapper.filter_k_frac * len(j.read)) for j in screened)
    sblock = max(screen_blocks, key=_live_cells)
    (bq, br), qs, rs_, ql, rl = sblock
    args = _k2_args(qs, rs_, ql, rl)
    cols, k2_err, plain_ms = _k2_hold(*args, False, k,
                                      f"mapper screen block {bq}x{br}")
    print(f"    K2 == plain (score, best, best_j bit-equal) on the fullest "
          f"screen block {bq}x{br}, batch {qs.shape[0]}, k {k}", flush=True)
    K1.launches, K2.launches = k1_before, k2_before
    return {"k1_launches": k1_runs, "k2_launches": k2_runs,
            "k1_err": k1_err, "k2_err": k2_err, "k1_extension": k1_ext,
            "screen": (sblock, args, k, cols, plain_ms),
            "mapper": mapper, "reads": reads}


def phase_k2_timing(screen, card):
    """K2 alone at the screen's fullest block: device time over ROUNDS
    rounds of ROUND_LAUNCHES launches (kernel_device_ms), beside its plain
    version and its bound, then at fewer and more pairs."""
    import numpy as np
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.tune.cost import MEM_BYTES_PER_S
    ((bq, br), qs, rs, ql, rl), (q, r, lens), k, cols, plain_ms = screen
    before = K2.launches
    dev, ev, host, prof = kernel_device_ms(
        lambda: K2.myers_fill(q, r, lens, glob=False, k=k), "myers")
    ms = statistics.median(dev)
    K2.launches = before
    B = qs.shape[0]
    cols = cols.cpu().numpy().astype("int64")
    words = (ql.astype("int64") - 1).clip(min=0) // 64 + 1
    word_cols = int((cols * words).sum())
    n_cols = int(cols.sum())
    ops = (K2_OPS_PER_WORD_COLUMN * word_cols
           + K2_OPS_PER_HANDOFF * (word_cols - n_cols)
           + K2_OPS_PER_COLUMN * n_cols)
    nbytes = B * bq + B * br + B * 8 + 3 * B * 4
    ops_ms = ops / card["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[9] K2 timed at batch {B}, {bq}x{br}, #17, k {k}: "
          f"{_spread_line(dev, ev, host, prof)}; plain {plain_ms:.1f} ms; "
          f"bound "
          f"{bound_ms:.4f} ms by {bound_by} (int32 ops {ops_ms:.4f} ms for "
          f"{word_cols} live 64-bit word-columns, bytes {bytes_ms:.4f} ms "
          f"for {nbytes} B); {100 * bound_ms / ms:.1f} % of the bound",
          flush=True)
    for n in (128, 8 * B):
        rows = np.arange(n) % B
        args = _k2_args(qs[rows], rs[rows], ql[rows], rl[rows])
        d, e, h, pr = kernel_device_ms(
            lambda: K2.myers_fill(*args, glob=False, k=k), "myers")
        print(f"    K2 at batch {n} (the block's pairs, repeated): "
              f"{_spread_line(d, e, h, pr)}", flush=True)
    K2.launches = before
    return {"ms": ms, "ms_range": [min(dev), max(dev)],
            "event_ms": statistics.median(ev),
            "host_us": statistics.median(host), "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "profiler_records": prof[0]}


# ---------------------------------------------------------------------------
# The LM serving path: K3 (flash attention) and K4 (WKV6)
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase S: the serving layer
def _sv_stream(rng, genome):
    """SV_REQUESTS (rid, kernel, query, ref, junk): the channels alternate
    #2 and #4; windows of SV_LENS bases of the genome, queries mutated at
    SV_RATE; about SV_JUNK of the #2 queries are unrelated random
    sequences."""
    from repro_torch.core import alphabets
    out = []
    for rid in range(SV_REQUESTS):
        kernel = SV_KERNELS[rid % 2]
        w = int(rng.integers(SV_LENS[0], SV_LENS[1] + 1))
        s = int(rng.integers(0, len(genome) - w))
        ref = genome[s:s + w]
        junk = kernel == SV_KERNELS[0] and rng.random() < SV_JUNK
        if junk:
            q = alphabets.random_dna(
                rng, int(rng.integers(SV_LENS[0], SV_LENS[1] + 1)))
        else:
            q = alphabets.mutate(rng, ref, SV_RATE)[:SV_MAX_LEN]
        out.append((rid, kernel, q if len(q) else ref[:1], ref, junk))
    return out


def _plan_totals():
    from repro_torch.runtime import plan as plan_mod
    return plan_mod.plan_cache_info()["totals"]


def _sv_run(stream, n_workers=SV_WORKERS, **kw):
    """One service over the whole stream, driven by serve(); returns the
    results in rid order, the service, serve()'s stats, the compile
    seconds stamped at boot and while serving, and each completed
    request's submit-to-result seconds."""
    import torch
    from repro_torch.runtime import plan as plan_mod
    from repro_torch.serve import AlignRequest, AlignmentService
    plan_mod.clear_plan_cache(keep_stats=True)      # every run starts cold
    c0 = _plan_totals()["compile_s"]
    svc = AlignmentService(max_len=SV_MAX_LEN, block=SV_BLOCK,
                           prefilter=SV_PREFILTER, pipeline_depth=SV_DEPTH,
                           **kw)
    c1 = _plan_totals()["compile_s"]
    reqs = [AlignRequest(rid=rid, kernel=k, query=q, ref=r)
            for rid, k, q, r, _ in stream]
    for r in reqs:
        svc.submit(r)
    stats = svc.serve(n_workers=n_workers, timeout_s=900.0)
    torch.cuda.synchronize()
    c2 = _plan_totals()["compile_s"]
    check(all(r.result is not None for r in reqs),
          "service: a request has no result")
    lat = [r._t_resolve - r._t_submit for r in reqs
           if not r.result.get("filtered") and not r.result.get("degraded")]
    return [r.result for r in reqs], svc, stats, (c1 - c0, c2 - c1), lat


def _sv_plain_k2(stream):
    """Plain K2's semiglobal edit distance (edit_search, no threshold) of
    every request on the card: the distance the prefilter and the degrade
    path must see."""
    import numpy as np
    import torch
    from repro_torch.kernels.myers import kernel as K2
    out = []
    for lo in range(0, len(stream), 2048):
        part = stream[lo:lo + 2048]
        B = len(part)
        qs = np.zeros((B, SV_MAX_LEN), np.uint8)
        rs = np.zeros((B, SV_MAX_LEN), np.uint8)
        lens = np.zeros((B, 2), np.int32)
        for row, (_, _, q, r, _) in enumerate(part):
            qs[row, :len(q)], rs[row, :len(r)] = q, r
            lens[row] = len(q), len(r)
        _, best, _ = K2.myers_fill_plain(
            torch.as_tensor(qs, device=DEVICE),
            torch.as_tensor(rs, device=DEVICE),
            torch.as_tensor(lens, device=DEVICE), glob=False, k=-1)
        out.extend(int(d) for d in best.cpu())
    return out


def _sv_latency(svc, lat):
    """Exact p50/p99 of the completed requests' submit-to-result seconds,
    and the gateway histogram's (a bucket's geometric midpoint, buckets
    sqrt(2) wide)."""
    import numpy as np
    hist = svc.metrics()["metrics"]["histograms"]
    h = hist.get("gw_latency_s{outcome=completed}", {})
    p50, p99 = (float(v) for v in np.percentile(lat, [50, 99]))
    return {"p50_s": p50, "p99_s": p99,
            "p50_bucket_s": h.get("p50", float("nan")),
            "p99_bucket_s": h.get("p99", float("nan"))}


@contextlib.contextmanager
def _recording(mod, name, calls):
    """Within the block, every call of ``mod.name`` appends its arguments
    to ``calls`` before it runs (the service's launches, replayed after
    the run against the plain version)."""
    orig = getattr(mod, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    setattr(mod, name, record)
    try:
        yield calls
    finally:
        setattr(mod, name, orig)


def _fullest_launches(calls, key):
    """The recorded launch with the most live cells for each ``key`` of
    its arguments, and how many launches had that key."""
    groups = {}
    for args, kw in calls:
        lens = args[-1].long()
        cells = int((lens[:, 0] * lens[:, 1]).sum())
        k = key(args)
        n, best = groups.get(k, (0, None))
        if best is None or cells > best[0]:
            best = (cells, args, kw)
        groups[k] = (n + 1, best)
    return {k: (n, args, kw) for k, (n, (_, args, kw)) in groups.items()}


def _latency_text(lat):
    return (f"p50 {lat['p50_s']:.3f} s, p99 {lat['p99_s']:.3f} s (the "
            f"gateway histogram's buckets: {lat['p50_bucket_s']:.3f} s, "
            f"{lat['p99_bucket_s']:.3f} s)")


def _sv_hold_launches(k1_calls, k2_calls, wall):
    """K1 and K2 against their plain versions on the very inputs the clean
    run launched them with (batches of SV_BLOCK rows: the survivors, then
    length-1 dummy rows): at each (kernel, shape) the launch with the most
    live cells, every output bit-equal, then timed alone
    (kernel_device_ms, 3 rounds).  Returns K1's and K2's largest
    |difference|, their device time over the wall (each launch at its
    shape's timed ms), and the shapes held."""
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    b1, b2 = K1.launches, K2.launches
    err1 = err2 = 0
    k1_ms = k2_ms = 0.0
    k1 = _fullest_launches(k1_calls, lambda a: (a[0].name,) + tuple(
        a[2].shape[:2]) + (a[3].shape[1],))
    for (name, B, bq, br), (n, args, kw) in sorted(k1.items()):
        spec, params, *fill = args
        err, _ = _hold_args(spec, params, fill, kw,
                            f"service {name} (batch {B})")
        err1 = max(err1, err)
        dev = kernel_device_ms(lambda: K1.wavefront_fill(
            spec, params, *fill, **kw), "wavefront", rounds=3)[0]
        k1_ms += n * statistics.median(dev)
    k2 = _fullest_launches(k2_calls, lambda a: tuple(a[0].shape)
                           + (a[1].shape[1],))
    for (B, bq, br), (n, (q, r, lens), kw) in sorted(k2.items()):
        _, err, _ = _k2_hold(q, r, lens, kw["glob"], kw["k"],
                             f"service screen {bq}x{br} (batch {B})")
        err2 = max(err2, err)
        dev = kernel_device_ms(lambda: K2.myers_fill(q, r, lens, **kw),
                               "myers", rounds=3)[0]
        k2_ms += n * statistics.median(dev)
    K1.launches, K2.launches = b1, b2
    return {"k1_err": err1, "k2_err": err2,
            "k1_share": k1_ms / 1e3 / wall, "k2_share": k2_ms / 1e3 / wall,
            "k1_shapes": [f"{name} {B}x{bq}x{br}"
                          for name, B, bq, br in sorted(k1)],
            "k2_shapes": len(k2)}


def phase_service(geno, mapping):
    """The serving layer on the card: the alignment service under serve()
    (clean and cold, with K1 and K2 held to their plain versions on the
    inputs it launched them with; warm-started and traced; one worker
    against two in turns; under a fault plan; degrading to K2), the
    genotyping and mapping services against their direct paths,
    tiled_align on K1 against the reference engine, and the banded engine
    against the reference engine."""
    import numpy as np
    import torch
    from repro_torch.core import alphabets, kernels_zoo
    from repro_torch.core import traceback as tb_mod
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import trace as obs_trace
    from repro_torch.runtime import dispatch
    from repro_torch.serve import FaultPlan
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    genome = alphabets.random_dna(rng, 1_000_000)
    stream = _sv_stream(rng, genome)
    n = len(stream)
    setup_s = time.perf_counter() - t_phase

    # A: the clean run, cold: the main path of this phase, its launches'
    # arguments recorded to be held against the plain versions below
    K1.launches = K2.launches = 0
    with _recording(K1, "wavefront_fill", []) as k1_calls, \
            _recording(K2, "myers_fill", []) as k2_calls:
        clean, svc, stats, (_, cold_compile), lat = _sv_run(stream)
    k1_runs, k2_runs = K1.launches, K2.launches
    wall = stats["wall_s"]
    check(k1_runs > 0 and k2_runs > 0, f"service: K1 {k1_runs} and K2 "
          f"{k2_runs} launches (each must be > 0)")
    disp = list(svc.dispatches)
    check(k2_runs == len(disp), f"service: K2 launched {k2_runs} times for "
          f"{len(disp)} screened batches")
    check(k1_runs == sum(d["n"] > 0 for d in disp), f"service: K1 launched "
          f"{k1_runs} times for {sum(d['n'] > 0 for d in disp)} batches "
          f"with survivors")
    check(len(k1_calls) == k1_runs and len(k2_calls) == k2_runs,
          f"service: {len(k1_calls)} K1 and {len(k2_calls)} K2 launches "
          f"recorded for {k1_runs} and {k2_runs} counted")
    rec = svc.metrics()["reconcile"]
    check(rec["ok"] and rec["dead_lettered"] == 0, f"service: {rec}")
    lat_clean = _sv_latency(svc, lat)
    filtered = [k for k, res in enumerate(clean) if res.get("filtered")]
    junk = [k for k, s in enumerate(stream) if s[4]]

    # exactness: unfiltered == run_pairs on the card; filtered iff plain
    # K2's distance exceeds the cut
    t0 = time.perf_counter()
    for kernel in SV_KERNELS:
        idx = [k for k, s in enumerate(stream) if s[1] == kernel
               and not clean[k].get("filtered")]
        spec, params = kernels_zoo.make(kernel)
        outs = dispatch.run_pairs(spec, params, [stream[k][2:4] for k in idx],
                                  block=1024)
        for k, a in zip(idx, outs):
            want = {"score": float(a.score),
                    "end": (int(a.end_i), int(a.end_j)),
                    "cigar": tb_mod.moves_to_cigar(a.moves, a.n_moves)}
            check(clean[k] == want, f"service: request {k} ({kernel}) "
                  f"{clean[k]} != run_pairs {want}")
    dist = _sv_plain_k2(stream)
    for k, (_, _, q, _, _) in enumerate(stream):
        cut = int(np.ceil(SV_PREFILTER * len(q)))
        check(bool(clean[k].get("filtered")) == (dist[k] > cut),
              f"service: request {k} filtered={clean[k].get('filtered')} "
              f"but plain K2's distance is {dist[k]} against cut {cut}")
    held = _sv_hold_launches(k1_calls, k2_calls, wall)
    del k1_calls[:], k2_calls[:]
    check_s = time.perf_counter() - t0

    # B: warm-started over run A's channel grid, traced
    grid = sorted({(d["kernel"], tuple(d["bucket"])) for d in disp})
    obs_trace.clear()
    obs_trace.enable()
    warm, wsvc, wstats, (boot_compile, warm_compile), wlat = _sv_run(
        stream[:SV_WARM], warm_start=grid)
    obs_trace.disable()
    trace_path = ROOT / "build" / "service_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    obj = wsvc.dump_trace(str(trace_path))
    problems = obs_export.validate_chrome_trace(obj)
    check(not problems, f"service trace: {problems[:3]}")
    names = {e["name"] for e in obj["traceEvents"]}
    check({"gw.launch", "gw.harvest", "dispatch.launch", "plan.compile"}
          <= names, f"service trace lacks spans: {sorted(names)[:12]}")
    spent = {}
    for sp in obs_trace.spans():
        if sp.t1 is not None and sp.name.startswith("gw."):
            t, c = spent.get(sp.name, (0.0, 0))
            spent[sp.name] = (t + sp.t1 - sp.t0, c + 1)
    obs_trace.clear()
    check(warm == clean[:SV_WARM], "service: the warm run's results differ")
    lat_warm = _sv_latency(wsvc, wlat)

    # E: one worker against two on the whole stream, warm-started over the
    # same grid, in turns (1, 2, 2, 1) in one process state
    turns = {1: [], 2: []}
    for w in (1, 2, 2, 1):
        res, asvc, astats, _, alat = _sv_run(stream, n_workers=w,
                                             warm_start=grid)
        check(res == clean, f"service with {w} workers: results differ "
              f"from the clean run")
        turns[w].append({"wall_s": astats["wall_s"],
                         **_sv_latency(asvc, alat)})

    # C: chaos, the invariants of bench_faults.py and scripts/chaos.py
    chaos, csvc, cstats, _, _ = _sv_run(
        stream, fault_plan=FaultPlan(seed=0, kill={"w0": 1},
                                     fail_launch_p=0.1),
        redispatch_after=5.0, max_retries=8)
    crec = csvc.metrics()["reconcile"]
    check(chaos == clean, "chaos: results differ from the clean run")
    check(cstats["killed"] == [{"worker": "w0", "seq": 1}],
          f"chaos: kill schedule {cstats['killed']}")
    check(cstats["completed"] + cstats["filtered"] == n, f"chaos: "
          f"{cstats['completed']} completed + {cstats['filtered']} "
          f"filtered != {n} requests (a double or lost completion)")
    check(crec["ok"] and crec["submitted"] == crec["resolved"]
          + crec["dead_lettered"] and crec["dead_lettered"] == 0,
          f"chaos: reconcile {crec}")

    # D: overload past the watermark degrades to K2
    degr, dsvc, dstats, _, _ = _sv_run(stream[:SV_DEGRADE], degrade="myers",
                                    degrade_watermark=SV_WATERMARK)
    nd = 0
    for k, res in enumerate(degr):
        if res.get("degraded"):
            nd += 1
            check(res["edit_distance"] == dist[k]
                  and res["score"] == -float(dist[k]),
                  f"degrade: request {k} {res} != plain K2 {dist[k]}")
        else:
            check(res == clean[k], f"degrade: request {k} differs from the "
                  f"clean run")
    check(0 < nd < SV_DEGRADE, f"degrade: {nd} of {SV_DEGRADE} requests "
          f"degraded")
    check(dsvc.metrics()["reconcile"]["ok"], "degrade: reconcile")

    junk_hit = len(set(filtered) & set(junk))
    print(f"[S] alignment service (#2 and #4, {n} requests of "
          f"{SV_LENS[0]}-{SV_LENS[1]} bases, {SV_RATE:.0%} mutated, "
          f"{len(junk)} junk; max_len {SV_MAX_LEN}, block {SV_BLOCK}, "
          f"prefilter {SV_PREFILTER}, depth {SV_DEPTH}, serve() with "
          f"{SV_WORKERS} workers; made in {setup_s:.1f} s)", flush=True)
    print(f"    clean, cold: {wall:.3f} s wall, {n / wall:.0f} requests/s; "
          f"latency (submit to result, all submitted at once) "
          f"{_latency_text(lat_clean)}; K1 launches {k1_runs}, K2 launches "
          f"{k2_runs} ({len(disp)} batches); filtered {len(filtered)} "
          f"({junk_hit} of the {len(junk)} junk); every unfiltered result "
          f"== run_pairs, every screen decision == plain K2", flush=True)
    print(f"    the clean run's launches replayed from their recorded "
          f"inputs ({SV_BLOCK} rows: survivors, then length-1 dummies), "
          f"the fullest at each shape: K1 == plain (tb, best, best_j "
          f"bit-equal, max |diff| {held['k1_err']}) at "
          f"{', '.join(held['k1_shapes'])}; K2 == plain (score, best, "
          f"best_j bit-equal, max |diff| {held['k2_err']}) at "
          f"{held['k2_shapes']} shapes; each timed alone: K1 device time "
          f"{100 * held['k1_share']:.3f} % of the wall, K2 "
          f"{100 * held['k2_share']:.4f} % ({check_s:.1f} s)", flush=True)
    print(f"    compile_s: cold run {cold_compile:.4f} s stamped while "
          f"serving (the first dispatch of each plan: a full batch with its "
          f"walk, the kernel libraries loaded since phase 2); warm run "
          f"{boot_compile:.4f} s at boot ({len(grid)} channels, "
          f"{2 * len(grid)} plans, length-1 dummies) and {warm_compile:.4f} "
          f"s while serving; warm run (the first {SV_WARM} requests) "
          f"{wstats['wall_s']:.3f} s wall, "
          f"{SV_WARM / wstats['wall_s']:.0f} requests/s, latency "
          f"{_latency_text(lat_warm)} (traced: "
          f"{trace_path.relative_to(ROOT)}, {len(obj['traceEvents'])} "
          f"events, valid)", flush=True)
    print("    workers, warm-started, the whole stream, in turns 1, 2, 2, 1: "
          + "; ".join(
              f"{w} worker{'s' * (w > 1)} "
              + ", ".join(f"{t['wall_s']:.3f} s ({n / t['wall_s']:.0f} "
                          f"requests/s, p50 {t['p50_s']:.3f} s, p99 "
                          f"{t['p99_s']:.3f} s)" for t in turns[w])
              for w in (1, 2)) + "; every result == the clean run",
          flush=True)
    print("    warm run's worker spans (seconds summed over both workers, "
          "count): " + ", ".join(f"{k} {t:.3f} s ({c})" for k, (t, c)
                                 in sorted(spent.items())), flush=True)
    print(f"    chaos (kill w0 at dispatch 1, launch failures p 0.1): "
          f"{cstats['wall_s']:.3f} s wall, bit-identical; faults "
          f"{cstats['faults']}, retries {cstats['retries']}, redispatched "
          f"{cstats['redispatched']}, dead letters 0, {crec}", flush=True)
    print(f"    degrade (the first {SV_DEGRADE} requests, watermark "
          f"{SV_WATERMARK}): {nd} answered by K2, each == plain K2, the rest "
          f"== the clean run; {dstats['wall_s']:.3f} s wall", flush=True)
    k1_geno, gt_s = _sv_genotyping(geno)
    k1_map, k2_map, map_s = _sv_mapping(mapping)
    k1_tile = _sv_tiling(rng)
    _sv_banded(rng, genome)
    print(f"    phase S {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"k1_launches": k1_runs, "k2_launches": k2_runs,
            "k1_err": held["k1_err"], "k2_err": held["k2_err"],
            "requests_per_s": n / wall, **lat_clean,
            "k1_share": held["k1_share"], "k2_share": held["k2_share"],
            "cold_first_batch_compile_s": cold_compile,
            "warm_boot_dummy_compile_s": boot_compile,
            "warm_serve_compile_s": warm_compile,
            "workers_in_turns": {
                str(w): [n / t["wall_s"] for t in turns[w]] for w in (1, 2)},
            "k1_genotyping": k1_geno, "k1_mapping": k1_map,
            "k2_mapping": k2_map, "k1_tiling": k1_tile}


def _sv_genotyping(geno):
    """SV_SITES of phase G's sites through GenotypingService: each call
    equals phase G's for the site."""
    import numpy as np
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.serve import GenotypeRequest, GenotypingService
    sites, calls = geno["sites"][:SV_SITES], geno["calls"]
    svc = GenotypingService(max_len=SV_MAX_LEN, block=GT_BLOCK)
    K1.launches = 0
    t0 = time.perf_counter()
    futs = [svc.submit(GenotypeRequest(rid=k, reads=s.reads,
                                       haplotypes=s.haplotypes))
            for k, s in enumerate(sites)]
    svc.serve(n_workers=SV_WORKERS, timeout_s=600.0)
    wall = time.perf_counter() - t0
    launches = K1.launches
    check(launches > 0, "genotyping service did not reach K1")
    worst = 0.0
    for k, (f, want) in enumerate(zip(futs, calls)):
        got = f.result()
        check((got["GT"], got["GQ"], got["PL"]) == (want["GT"], want["GQ"],
                                                     want["PL"]),
              f"genotyping service: site {k} called {got['GT']} "
              f"{got['PL']}, phase G {want['GT']} {want['PL']}")
        worst = max(worst, float(np.max(np.abs(got["ll"] - want["ll"])
                                        / np.abs(want["ll"]))))
    check(worst <= 2e-5, f"genotyping service: likelihoods differ from "
          f"phase G's by rel {worst:.3g}")
    pairs = sum(len(s.reads) * len(s.haplotypes) for s in sites)
    print(f"    genotyping service: {len(sites)} of phase G's sites "
          f"({pairs} pairs), block {GT_BLOCK}: {wall:.3f} s, "
          f"{len(sites) / wall:.1f} sites/s; K1 launches {launches}; every "
          f"call (GT, GQ, PL) == phase G's, likelihoods within rel "
          f"{worst:.3g}", flush=True)
    return launches, wall


def _sv_mapping(mapping):
    """SV_READS of phase 8's reads (the last 256 of them junk) through
    ReadMappingService: its SAM lines equal map_reads on the same reads."""
    import torch
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.serve import MapRequest, ReadMappingService
    mapper, reads = mapping["mapper"], mapping["reads"]
    pick = reads[:SV_READS - 256] + reads[N_READS:N_READS + 256]
    svc = ReadMappingService(mapper.ref, mapper=mapper, max_batch=1024)
    reqs = [MapRequest(rid=i, read=r) for i, r in enumerate(pick)]
    K1.launches = K2.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        svc.submit(r)
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = K1.launches, K2.launches
    check(k1 > 0 and k2 > 0, f"mapping service: K1 {k1}, K2 {k2} launches")
    direct = mapper.map_reads(pick, names=[f"r{i}" for i in range(len(pick))])
    for i, (r, d) in enumerate(zip(reqs, direct)):
        check(r.result["sam"] == d.to_line(),
              f"mapping service: read {i} differs from map_reads")
    mapped = sum(r.result["mapped"] for r in reqs)
    print(f"    mapping service: {len(pick)} of phase 8's reads (256 junk), "
          f"max_batch 1024: {wall:.3f} s, {len(pick) / wall:.0f} reads/s; "
          f"{mapped} mapped; K1 launches {k1}, K2 {k2}; every SAM line == "
          f"map_reads on the same reads", flush=True)
    return k1, k2, wall


def _sv_tiling(rng):
    """tiled_align of one SV_TILE_LEN-base #2 pair on K1 against the
    reference engine on the card: the same moves, tiles and end cell."""
    from repro_torch.core import alphabets, kernels_zoo, tiling
    from repro_torch.kernels.wavefront import kernel as K1
    ref = alphabets.random_dna(rng, SV_TILE_LEN)
    q = alphabets.mutate(rng, ref, SV_RATE)
    spec, params = kernels_zoo.make(2)
    K1.launches = 0
    t0 = time.perf_counter()
    got = tiling.tiled_align(spec, params, q, ref, tile=SV_TILE,
                             overlap=SV_OVERLAP)
    wall = time.perf_counter() - t0
    launches = K1.launches
    t1 = time.perf_counter()
    want = tiling.tiled_align(spec, params, q, ref, tile=SV_TILE,
                              overlap=SV_OVERLAP, engine_name="reference")
    ref_s = time.perf_counter() - t1
    check(launches == got.n_tiles, f"tiling: K1 launched {launches} times "
          f"for {got.n_tiles} tiles")
    check(got.moves.tobytes() == want.moves.tobytes()
          and (got.n_tiles, got.end_i, got.end_j)
          == (want.n_tiles, want.end_i, want.end_j),
          "tiling: K1 and the reference engine differ")
    check((got.end_i, got.end_j) == (len(q), len(ref)),
          f"tiling: ends at {(got.end_i, got.end_j)}")
    print(f"    tiling: #2, {len(q)} x {len(ref)} bases, tile {SV_TILE}, "
          f"overlap {SV_OVERLAP}: {got.n_tiles} tiles, {wall:.2f} s on K1 "
          f"({launches} launches), {ref_s:.2f} s on the reference engine; "
          f"the same {len(got.moves)} moves and end cell", flush=True)
    return launches


def _sv_banded(rng, genome):
    """#11-13 on the banded engine against the reference engine on the
    card, and #12 with xdrop on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import banded, kernels_zoo
    from repro_torch.runtime import bucketing, dispatch
    out = []
    for kid in (11, 12, 13):
        spec, params = kernels_zoo.make(kid)
        pairs = _read_pairs(rng, genome, SV_BANDED_PAIRS, *SV_BANDED_LENS,
                            SV_RATE, SV_MAX_LEN)
        t0 = time.perf_counter()
        got = dispatch.run_pairs(spec, params, pairs, engine_name="banded",
                                 with_traceback=False, block=SV_BANDED_PAIRS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = dispatch.run_pairs(spec, params, pairs,
                                  engine_name="reference",
                                  with_traceback=False,
                                  block=SV_BANDED_PAIRS)
        scores = [float(a.score) for a in got]
        check(scores == [float(a.score) for a in want],
              f"banded #{kid}: scores differ from the reference engine")
        live = sum(x != spec.sentinel() for x in scores)
        out.append(f"#{kid} {ms:.0f} ms ({live} live)")
    # #12 (the last spec) again with xdrop, on its pairs' blocks
    batches, _ = bucketing.pack_by_bucket(
        [(len(q), len(r)) for q, r in pairs], block=SV_BANDED_PAIRS)
    pruned = 0
    for b in batches:
        bq, br = b.bucket
        qs = np.zeros((len(b.indices), bq), np.uint8)
        rs = np.zeros((len(b.indices), br), np.uint8)
        lens = np.zeros((2, len(b.indices)), np.int32)
        for row, idx in enumerate(b.indices):
            q, r = pairs[idx]
            qs[row, :len(q)], rs[row, :len(r)] = q, r
            lens[:, row] = len(q), len(r)
        args = [torch.as_tensor(x) for x in (qs, rs, *lens)]
        card = banded.run(spec, params, *[a.to(DEVICE) for a in args],
                          xdrop=SV_XDROP)
        cpu = banded.run(spec, params, *[a[:16] for a in args],
                         xdrop=SV_XDROP)
        check(torch.equal(card.score[:16].cpu(), cpu.score)
              and torch.equal(card.end_i[:16].cpu(), cpu.end_i)
              and torch.equal(card.end_j[:16].cpu(), cpu.end_j),
              f"banded #12 xdrop {SV_XDROP}: the card differs from the CPU")
        full = torch.as_tensor([scores[i] for i in b.indices])
        check(bool((card.score.cpu().float() <= full).all()),
              "banded #12: xdrop raised a score")
        pruned += int((card.score.cpu().float() < full).sum())
    check(pruned > 0, f"banded #12: xdrop {SV_XDROP} lowered no score")
    print(f"    banded == reference engine on {SV_BANDED_PAIRS} pairs of "
          f"{SV_BANDED_LENS[0]}-{SV_BANDED_LENS[1]} bases: "
          f"{', '.join(out)}; #12 with xdrop {SV_XDROP}: {pruned} of "
          f"{len(pairs)} scores lowered, the first 16 of each block == the "
          f"CPU", flush=True)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), elementwise, f32."""
    import torch
    x = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def _k3_hold(q, k, v, what, exact=False, **mask):
    """K3 and its plain version on one input, p rounded to q's type on both
    sides (f32: kept in f32); checks K3_PARITY and returns the largest
    |difference|, the share of outputs beyond the first bound, and the
    largest |difference| from the plain version with p in f32.

    The first bound is atol/rtol 2e-5 (the repo's K3 tests), in bf16 plus
    one bf16 ulp of the output: two f32 results within 2e-5 can round to
    bf16 values one ulp apart.  It holds wherever both sides compute the
    same f32 scores, which integer q and k guarantee (``exact``).  Other
    scores sum in another order in the kernel's mma than in the plain
    version's matmul, and an f32 p lying next to a bf16 rounding boundary
    then rounds to the neighbour on one side: one bf16 ulp of p, up to
    2^-7 p, which can move an output by far more than 2e-5 (measured: about
    1e-4 of the outputs at S = 1536).  Those cases are held to the first
    bound plus one ulp of every p carried through p v,
    2^-7 sum_j p_j |v_j| / l (the plain attention of |v|), and at most
    K3_STRICT_SHARE of their outputs may lie beyond the first bound."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    p_dtype = q.dtype
    got = K3.flash_fill(q, k, v, p_dtype=p_dtype, **mask).float()
    want = K3.flash_attention_plain(q, k, v, p_dtype=p_dtype,
                                    **mask).float()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    tol = 2e-5 + 2e-5 * want.abs()
    if p_dtype != torch.float32:
        tol = tol + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    share = float((diff > tol).float().mean()) if diff.numel() else 0.0
    if p_dtype == torch.float32 or exact:
        check(share == 0.0, f"K3 != plain: {what} (max |diff| {err}, "
              f"{share:.3g} of outputs beyond 2e-5 plus one ulp)")
    else:
        pv = K3.flash_attention_plain(q.float(), k.float(), v.abs().float(),
                                      **mask)
        check(bool((diff <= tol + 2.0 ** -7 * pv).all())
              and share <= K3_STRICT_SHARE,
              f"K3 != plain: {what} (max |diff| {err}; {share:.3g} of "
              f"outputs beyond 2e-5 plus one ulp, at most {K3_STRICT_SHARE}"
              f" allowed, all within one ulp of each p)")
    err32 = err
    if p_dtype != torch.float32 and diff.numel():
        want32 = K3.flash_attention_plain(q, k, v, **mask).float()
        err32 = float((got - want32).abs().max())
    return err, share, err32


def phase_k3_vs_plain(rng):
    """K3 against its plain version: causal, causal with window 64 and
    non-causal; G = 1 and 4; S in {77, 512, 1000}; hd in {64, 128}; f32,
    and bf16 on integer q/k (exact scores) and on normal q/k."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    max_err, max_share, max_err32, n = 0.0, 0.0, 0.0, 0
    kinds = ((torch.float32, False), (torch.bfloat16, True),
             (torch.bfloat16, False))
    for causal, window in ((True, None), (True, 64), (False, None)):
        for G in (1, 4):
            for S in K3_SWEEP_S:
                for (dtype, exact), hd in itertools.product(kinds, (64, 128)):
                    B, H = 2, 8
                    q = rng.normal(size=(B, S, H, hd))
                    k, v = (rng.normal(size=(B, S, H // G, hd))
                            for _ in range(2))
                    if exact:
                        q, k = (np.round(t * 1.5).clip(-3, 3) for t in (q, k))
                    q, k, v = (torch.as_tensor(t, dtype=dtype, device=DEVICE)
                               for t in (q, k, v))
                    err, share, err32 = _k3_hold(
                        q, k, v, f"causal {causal}, window {window}, G {G}, "
                        f"S {S}, {dtype}, {'exact' if exact else 'normal'}"
                        f" scores, hd {hd}", exact, causal=causal,
                        window=window)
                    max_err = max(max_err, err)
                    max_share = max(max_share, share)
                    if dtype != torch.float32:
                        max_err32 = max(max_err32, err32)
                    n += 1
    print(f"[10] K3 == plain on {n} cases (causal / window 64 / non-causal "
          f"x G 1, 4 x S {K3_SWEEP_S} x f32, bf16 on exact and on normal "
          f"scores x hd 64, 128; {K3_PARITY}; max |diff| {max_err:.3g}, "
          f"largest share beyond 2e-5 plus one ulp {max_share:.3g}) in "
          f"{time.perf_counter() - t0:.1f} s; for information, bf16 K3 "
          f"against plain with p kept in f32: max |diff| {max_err32:.3g}",
          flush=True)
    return max_err


def _k4_inputs(rng, B, S, H, hd, scale, dtype=None):
    import numpy as np
    import torch
    r, k, v = (torch.as_tensor(rng.normal(size=(B, S, H, hd)),
                               dtype=dtype or torch.float32, device=DEVICE)
               for _ in range(3))
    lw = torch.as_tensor(-np.exp(rng.normal(size=(B, S, H, hd)) * scale),
                         dtype=torch.float32, device=DEVICE)
    u = torch.as_tensor(rng.normal(size=(H, hd)), dtype=torch.float32,
                        device=DEVICE)
    return r, k, v, lw, u


def _k4_hold(args, what):
    """K4 and its plain version on one input: y and the final state
    within rtol/atol 5e-4 (the repo's strong-decay tolerance); returns the
    largest |difference|."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as K4
    got = K4.wkv6_fill(*args)
    want = K4.wkv6_plain(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(torch.allclose(g, w, rtol=5e-4, atol=5e-4)
              for g, w in zip(got, want)),
          f"K4 != plain: {what} (max |diff| {err})")
    return err


def phase_k4_vs_plain(rng):
    """K4 against its plain version: decay scales 1 and 2, S in
    K4_SWEEP_S, r/k/v f32 and bf16, hd 64, H 4, batch 2."""
    import torch
    t0 = time.perf_counter()
    max_err, n = 0.0, 0
    for scale, S, dtype in itertools.product(
            (1.0, 2.0), K4_SWEEP_S, (torch.float32, torch.bfloat16)):
        err = _k4_hold(_k4_inputs(rng, 2, S, 4, 64, scale, dtype),
                       f"decay scale {scale}, S {S}, {dtype}")
        max_err = max(max_err, err)
        n += 1
    print(f"[11] K4 == plain on {n} cases (decay scale 1, 2 x S "
          f"{K4_SWEEP_S} x r/k/v f32, bf16; hd 64, H 4; y and final state "
          f"within 5e-4; max |diff| {max_err:.3g}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return max_err


def _reset_counts():
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.kernels.wkv6 import kernel as K4
    mods = (K1, K2, K3, K4)
    for m in mods:
        m.launches = 0
    K3.bwd_launches = K4.bwd_launches = 0
    return mods


def _serve_requests(cfg):
    """SERVE_REQUESTS random prompts, lengths uniform in PROMPT_LENS, from
    numpy seed SEED."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, SERVE_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(lens)]


def _serve(cfg, params):
    """Warm up, then serve the phase's traffic with every launch count at
    0; returns the finished requests, the session, its wall time, the peak
    device memory and the launch counts of K1-K4 over the run."""
    import torch
    from repro_torch.serve import Request, ServeSession
    warm = ServeSession(cfg, params, batch_slots=1, max_len=64,
                        device=DEVICE)
    warm.run([Request(rid=-1, prompt=_serve_requests(cfg)[0].prompt[:32],
                      max_new=2)])
    del warm
    sess = ServeSession(cfg, params, batch_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, device=DEVICE)
    reqs = _serve_requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = _reset_counts()
    t0 = time.perf_counter()
    done = sess.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [m.launches for m in mods]
    peak = torch.cuda.max_memory_allocated()
    check(len(done) == len(reqs) and all(len(r.out) == MAX_NEW
                                         for r in done),
          f"{cfg.name}: {len(done)} of {len(reqs)} requests finished")
    ttft = [r.t_first - t0 for r in done]
    st = sess.stats
    print(f"    {cfg.name} serving {len(reqs)} requests (prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, {MAX_NEW} new tokens each) "
          f"on {SERVE_SLOTS} slots x {SERVE_MAX_LEN}: {wall:.3f} s wall; "
          f"time to first token mean {sum(ttft) / len(ttft):.3f} s, max "
          f"{max(ttft):.3f} s; prefill {st['prefill_tokens']} tokens in "
          f"{st['prefill_s']:.3f} s "
          f"({st['prefill_tokens'] / st['prefill_s']:.0f} tokens/s); decode "
          f"{st['decode_tokens']} tokens in "
          f"{st['steps']} steps, {st['decode_s']:.3f} s "
          f"({st['decode_tokens'] / st['decode_s']:.1f} tokens/s); peak "
          f"device memory {peak / 2**20:.1f} MiB; launches K1-K4 {counts}",
          flush=True)
    return {"done": done, "wall": wall, "peak": peak, "counts": counts,
            "stats": dict(st), "ttft": ttft, "session": sess}


def _device_profile(fn, what):
    """Run ``fn`` under torch.profiler and report the device (CUDA kernel)
    time it took, the host wall time of the profiled window, and the five
    kernels with the most device time.  A measurement, not a check: when
    the profiler sees no device activity it says so and the run goes on."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        cuda = torch.autograd.DeviceType.CUDA
        by_name = {}
        for ev in prof.events():
            if getattr(ev, "device_type", None) == cuda:
                us = ev.time_range.elapsed_us()
                by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    except Exception as e:   # the profiler is a measurement aid only
        print(f"    profile of {what}: torch.profiler failed ({e!r})",
              flush=True)
        return None
    dev_ms = sum(by_name.values()) / 1e3
    if not by_name:
        print(f"    profile of {what}: torch.profiler saw no device time",
              flush=True)
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"    profile of {what}: device kernels {dev_ms:.3f} ms in a "
          f"{wall_ms:.3f} ms window ({100 * dev_ms / wall_ms:.1f} % busy "
          f"under the profiler); top: " + "; ".join(
              f"{n[:60]} {us / 1e3:.3f} ms ({100 * us / 1e3 / dev_ms:.1f} %)"
              for n, us in top), flush=True)
    return {"device_ms": dev_ms, "wall_ms": wall_ms, "top": top}


def _profile_serving(cfg, params, sess, longest):
    """Profile one prefill of the longest prompt and three decode steps of
    the session's cache (all 8 slots, at their final lengths)."""
    import torch
    from repro_torch.models import lm
    toks = torch.as_tensor(longest, dtype=torch.int64, device=DEVICE)[None]
    _device_profile(lambda: lm.prefill(cfg, params, {"tokens": toks}),
                    f"one prefill ({toks.shape[1]} tokens)")
    last = torch.as_tensor(sess.last_tok, device=DEVICE)
    k_len = torch.as_tensor(sess.k_len, device=DEVICE)

    def steps():
        for i in range(3):
            lm.decode_step(cfg, params, sess.cache, last, k_len + i)
    prof = _device_profile(steps, f"3 decode steps ({sess.B} slots)")
    if prof:
        step_ms = 1e3 * sess.stats["decode_s"] / sess.stats["steps"]
        print(f"    decode: {prof['device_ms'] / 3:.3f} ms of device kernels "
              f"per step against {step_ms:.3f} ms per step in the serve "
              f"run: the device is busy "
              f"{100 * prof['device_ms'] / 3 / step_ms:.1f} % of a step",
              flush=True)


def _full_params(cfg):
    import torch
    from repro_torch.models.params import count_params, init_params
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    n = count_params(cfg)
    print(f"    {cfg.name}: {n:,} parameters ({n / 1e9:.2f} B), "
          f"{cfg.param_dtype}, random from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def _layer0_input(cfg, params, prompt):
    """Layer 0's parameters and normed input for one prompt."""
    import torch
    from repro_torch.models import layers, lm
    from repro_torch.models.params import tree_map
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
    x = lm._embed(cfg, params, toks)
    p0 = tree_map(lambda t: t[0], params["groups"][0])["sub0"]
    return p0, layers.norm_apply(cfg, p0["norm1"], x)


def _kernel_share(fn_for_len, lens, n_layers):
    """Device time of one kernel over a serve run's prefills: each prompt
    length's launch timed alone (CUDA events, mean of 3 after one warm-up)
    times the layers that launch it."""
    total = 0.0
    for n in lens:
        fn = fn_for_len(int(n))
        fn()
        total += cuda_time_ms(fn, 3) * n_layers
    return total / 1e3


def _rms(x):
    return float(x.float().pow(2).mean().sqrt())


def _prefill_decode(cfg, params, toks, nxt=None, spoil=False):
    """Prefill logits of ``toks``, and the decode logits of ``nxt`` (by
    default the greedy token) at the next position, and ``nxt``; ``spoil``
    zeroes layer 0's first mixer cache leaf (the attention keys, or the
    WKV state) before the decode step."""
    import torch
    from repro_torch.models import lm
    Lp = toks.shape[1]
    logits_p, cache, k_len = lm.prefill(cfg, params, {"tokens": toks})
    if nxt is None:
        nxt = torch.argmax(logits_p, -1)
    cache = lm.grow_cache(cfg, cache, 1, Lp + 1)
    if spoil:
        leaves = cache[0]["sub0"]["mixer"]
        leaves[next(iter(leaves))][0].zero_()
    logits_d, _ = lm.decode_step(cfg, params, cache, nxt, k_len)
    return logits_p[0], logits_d[0], nxt


def _decode_vs_forward(cfg, params, prompt):
    """Prefill ``prompt``, decode its greedy next token at position Lp, and
    hold the prefill and decode logits against ``forward`` on prompt +
    token at the same positions, twice.

    In bf16 both sides round at other places (other matmul shapes; decode
    attention casts p to bf16), so that tolerance is measured, not guessed:
    the same ``forward`` in f32 (the weights upcast) gives each logit's bf16
    rounding error, and the two bf16 paths may differ by at most
    LOGIT_FACTOR times the RMS of that error.  That rounding is a large
    share of the logits at full width, so the bf16 check catches only gross
    faults.  The tight check runs the same prefill and decode in f32 (TF32
    off) against the f32 ``forward``, within atol 2e-3, rtol 1e-3 (the
    decode tolerance of tests/test_models.py), and shows that it can fail:
    a decode from a cache whose layer-0 keys or WKV state are zeroed must
    miss it."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    from repro_torch.models.params import tree_map
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
    Lp = toks.shape[1]
    logits_p, logits_d, nxt = _prefill_decode(cfg, params, toks)
    batch = {"tokens": torch.cat([toks, nxt[:, None]], 1)}
    full = lm.forward(cfg, params, batch)["logits"][0, Lp - 1:]
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), params)
    ref = lm.forward(cfg32, params32, batch)["logits"][0, Lp - 1:]
    out = []
    for i, got in enumerate((logits_p, logits_d)):
        want, exact = full[i], ref[i]
        d, e = _rms(got - want), _rms(want - exact)
        check(d <= LOGIT_FACTOR * e, f"{cfg.name}: bf16 logits at position "
              f"{Lp - 1 + i} differ from forward by RMS {d:.4f}, more than "
              f"{LOGIT_FACTOR} x the bf16 rounding RMS {e:.4f} (logit RMS "
              f"{_rms(exact):.3f})")
        out.append(f"position {Lp - 1 + i}: RMS {d:.4f} (max "
                   f"{float((got - want).abs().max()):.4f}) against "
                   f"{LOGIT_FACTOR} x {e:.4f}")
    top = int(torch.argmax(logits_d)) == int(torch.argmax(full[1]))
    print(f"    bf16 prefill and first decode logits vs forward (prompt "
          f"{Lp}; bound from forward in f32, logit RMS {_rms(ref[1]):.3f}): "
          f"{'; '.join(out)}; same top token: {top}", flush=True)

    del logits_p, logits_d, full
    got32 = _prefill_decode(cfg32, params32, toks, nxt)[:2]
    errs = []
    for i, got in enumerate(got32):
        diff = float((got - ref[i]).abs().max())
        check(torch.allclose(got, ref[i], atol=2e-3, rtol=1e-3),
              f"{cfg.name}: f32 logits at position {Lp - 1 + i} differ from "
              f"the f32 forward by up to {diff:.3g}")
        errs.append(diff)
    spoiled = _prefill_decode(cfg32, params32, toks, nxt, spoil=True)[1]
    miss = float((spoiled - ref[1]).abs().max())
    check(not torch.allclose(spoiled, ref[1], atol=2e-3, rtol=1e-3),
          f"{cfg.name}: a decode from a spoiled cache passes the f32 check")
    del params32, got32, spoiled
    torch.cuda.empty_cache()
    print(f"    f32 prefill and first decode logits vs the f32 forward "
          f"(TF32 off; within 2e-3 / 1e-3): max |diff| {errs[0]:.3g} and "
          f"{errs[1]:.3g}; a decode with layer 0's cache zeroed misses by "
          f"{miss:.3g} and fails the check", flush=True)


def phase_olmo():
    """olmo-1b at full width serves the traffic on K3, then K3 is held to
    its plain version on layer 0 of the longest prompt and the first
    decode logits to ``forward``."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.models import mixers
    cfg = configs.get("olmo-1b")
    print("[12] olmo-1b at full width", flush=True)
    params = _full_params(cfg)
    run = _serve(cfg, params)
    want = SERVE_REQUESTS * cfg.n_layers
    check(run["counts"][2] == want, f"olmo-1b serving launched K3 "
          f"{run['counts'][2]} times, not {want}")
    check(run["counts"][3] == 0, "olmo-1b serving launched K4")

    before = K3.launches
    longest = max(run["done"], key=lambda r: len(r.prompt)).prompt
    p0, h = _layer0_input(cfg, params, longest)
    pos = torch.arange(len(longest), dtype=torch.int32, device=DEVICE)[None]
    q, k, v = mixers.attn_qkv(cfg, p0["mixer"], h, pos)
    err, share, err32 = _k3_hold(q, k, v, "olmo-1b layer 0", causal=True)
    print(f"    K3 == plain ({K3_PARITY}) on layer 0's q/k/v of the longest "
          f"prompt {tuple(q.shape)}, {q.dtype}: max |diff| {err:.3g}; "
          f"{share:.3g} of outputs beyond 2e-5 plus one ulp; against plain "
          f"with p kept in f32: max |diff| {err32:.3g}", flush=True)
    _decode_vs_forward(cfg, params, longest)

    H, hd = cfg.n_heads_eff, cfg.head_dim

    def k3_at(n):
        qkv = [torch.randn((1, n, H, hd), device=DEVICE,
                           dtype=torch.bfloat16) for _ in range(3)]
        return lambda: K3.flash_fill(*qkv, causal=True,
                                     p_dtype=torch.bfloat16)
    k3_s = _kernel_share(k3_at, [len(r.prompt) for r in run["done"]],
                         cfg.n_layers)
    _profile_serving(cfg, params, run["session"], longest)
    K3.launches = before
    st = run["stats"]
    print(f"    where the time goes: prefill {st['prefill_s']:.3f} s "
          f"({100 * st['prefill_s'] / run['wall']:.1f} % of wall; K3 "
          f"{k3_s:.3f} s of it, {100 * k3_s / st['prefill_s']:.1f} %, from "
          f"each prompt's K3 timed alone x {cfg.n_layers} layers), decode "
          f"{st['decode_s']:.3f} s "
          f"({100 * st['decode_s'] / run['wall']:.1f} %)", flush=True)
    launches = run["counts"][2]
    del params, run
    torch.cuda.empty_cache()
    return {"k3_launches": launches, "k3_err": err}


def phase_rwkv():
    """rwkv6-3b at full width serves the traffic on K4, then K4 is held to
    its plain version on layer 0 of the longest prompt."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.wkv6 import kernel as K4
    from repro_torch.models import mixers
    cfg = configs.get("rwkv6-3b")
    print("[13] rwkv6-3b at full width", flush=True)
    params = _full_params(cfg)
    run = _serve(cfg, params)
    want = SERVE_REQUESTS * cfg.n_layers
    check(run["counts"][3] == want, f"rwkv6-3b serving launched K4 "
          f"{run['counts'][3]} times, not {want}")
    check(run["counts"][2] == 0, "rwkv6-3b serving launched K3")

    before = K4.launches
    longest = max(run["done"], key=lambda r: len(r.prompt)).prompt
    p0, h = _layer0_input(cfg, params, longest)
    r, k, v, _, lw, u = mixers.rwkv6_inputs(cfg, p0["mixer"], h,
                                            mixers._shifted(h))
    err = _k4_hold((r, k, v, lw, u), "rwkv6-3b layer 0")
    print(f"    K4 == plain (y and state within 5e-4) on layer 0's "
          f"r/k/v/lw/u of the longest prompt {tuple(r.shape)}, r/k/v "
          f"{r.dtype}: max |diff| {err:.3g}", flush=True)
    _decode_vs_forward(cfg, params, longest)

    H, hd = cfg.rwkv_heads, cfg.head_dim

    def k4_at(n):
        args = (*(torch.randn((1, n, H, hd), device=DEVICE,
                              dtype=torch.bfloat16) for _ in range(3)),
                -torch.rand((1, n, H, hd), device=DEVICE),
                torch.randn((H, hd), device=DEVICE))
        return lambda: K4.wkv6_fill(*args)
    k4_s = _kernel_share(k4_at, [len(x.prompt) for x in run["done"]],
                         cfg.n_layers)
    _profile_serving(cfg, params, run["session"], longest)
    K4.launches = before
    st = run["stats"]
    print(f"    where the time goes: prefill {st['prefill_s']:.3f} s "
          f"({100 * st['prefill_s'] / run['wall']:.1f} % of wall; K4 "
          f"{k4_s:.3f} s of it, {100 * k4_s / st['prefill_s']:.1f} %, from "
          f"each prompt's K4 timed alone x {cfg.n_layers} layers), decode "
          f"{st['decode_s']:.3f} s "
          f"({100 * st['decode_s'] / run['wall']:.1f} %)", flush=True)
    launches = run["counts"][3]
    del params, run
    torch.cuda.empty_cache()
    return {"k4_launches": launches, "k4_err": err}


def phase_card_vs_cpu():
    """Both reduced configs in f32 (TF32 off) served on the card and on the
    CPU from the same weights: 5 requests on 2 slots, 6 new tokens; every
    step's logits within atol 2e-3, rtol 1e-3 (the decode tolerance of
    tests/test_models.py) and the greedy tokens equal."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serve import Request, ServeSession
    t0 = time.perf_counter()
    worst = {}
    for arch in ("olmo-1b", "rwkv6-3b"):
        cfg = configs.get(arch, reduced=True)
        cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        dev = tree_map(lambda t: t.to(DEVICE), cpu)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(4, 17, 5)]
        outs = []
        for where, params in ((DEVICE, dev), ("cpu", cpu)):
            sess = ServeSession(cfg, params, batch_slots=2, max_len=48,
                                device=where, record_logits=True)
            done = sess.run([Request(rid=i, prompt=p, max_new=6)
                             for i, p in enumerate(prompts)])
            outs.append(([r.out for r in done], sess.logits_log))
        (card_toks, card_log), (cpu_toks, cpu_log) = outs
        check(card_toks == cpu_toks,
              f"{arch}: greedy tokens on the card differ from the CPU's")
        err = 0.0
        for (slot_g, g), (slot_w, w) in zip(card_log, cpu_log):
            check(slot_g == slot_w and g.shape == w.shape,
                  f"{arch}: the card's and the CPU's steps differ")
            check(np.allclose(g, w, atol=2e-3, rtol=1e-3),
                  f"{arch}: logits differ from the CPU's by "
                  f"{np.abs(g - w).max()}")
            err = max(err, float(np.abs(g - w).max()))
        worst[arch] = (err, len(card_log))
    print(f"[14] card == CPU on the reduced configs in f32 (5 requests, 2 "
          f"slots, 6 new tokens; greedy tokens equal; every step's logits "
          f"within 2e-3 / 1e-3): " + ", ".join(
              f"{a} max |diff| {e:.3g} over {n} calls"
              for a, (e, n) in worst.items())
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)


def k3_pairs(S, causal, window, k_len):
    """Unmasked (query, key) pairs of one head of K3's function, each 4 hd
    operations of work (q . k and p v, an fma counting 2)."""
    import numpy as np
    q = np.arange(S)
    hi = np.full(S, S if k_len is None else min(int(k_len), S))
    if causal:
        hi = np.minimum(hi, q + 1)
    lo = np.zeros(S, np.int64) if window is None else np.maximum(
        q - int(window) + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def k4_ops_per_step(hd):
    """f32 operations of one step of one head of the WKV6 recurrence as the
    function defines it, one step at a time (an fma counts 2, an exp 1):
    y = r . state, hd^2 fmas; the u bonus (r * u) . k, a mul and an fma per
    d, and y += bonus * v, an fma per d; the decay exp(lw), 1 per d; the
    state w * state + k v^T, a mul and an fma per entry."""
    return 5 * hd * hd + 6 * hd


def _in_turns(a, b=None):
    """Per-launch ms of ``a`` and ``b`` over ROUNDS rounds of
    ROUND_LAUNCHES launches each (CUDA events), in turns a, b, b, a, after
    a warm-up; two samples of each per round."""
    ta, tb = [], []
    for fn in (a, b):
        for _ in range(3 if fn else 0):
            fn()
    for _ in range(ROUNDS):
        ta.append(cuda_time_ms(a, ROUND_LAUNCHES))
        if b:
            tb += [cuda_time_ms(b, ROUND_LAUNCHES) for _ in range(2)]
        ta.append(cuda_time_ms(a, ROUND_LAUNCHES))
    return ta, tb


def _spread(ts):
    return f"median {statistics.median(ts):.4f} ms ({min(ts):.4f}-" \
           f"{max(ts):.4f} over {len(ts)} rounds of {ROUND_LAUNCHES})"


def phase_timing_k3_k4():
    """K3 and K4 alone at the serving path's largest shapes, CUDA events
    over rounds of launches (K3 in turns with
    scaled_dot_product_attention, a yardstick the port never calls),
    beside the plain versions and the bounds on this card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.wkv6 import kernel as K4
    from repro_torch.tune.cost import MEM_BYTES_PER_S
    before = (K3.launches, K4.launches)
    B, S, H, hd = K3_TIMED
    q, k, v = (torch.randn((B, S, H, hd), device=DEVICE,
                           dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t3, tlib = _in_turns(
        lambda: K3.flash_fill(q, k, v, causal=True, p_dtype=torch.bfloat16),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    ms, lib_ms = statistics.median(t3), statistics.median(tlib)
    K3.flash_attention_plain(q, k, v, causal=True, p_dtype=torch.bfloat16)
    plain_ms = cuda_time_ms(lambda: K3.flash_attention_plain(
        q, k, v, causal=True, p_dtype=torch.bfloat16), 3)
    pairs = k3_pairs(S, True, None, None)
    flops = pairs * 4 * hd * B * H
    nbytes = 4 * B * S * H * hd * 2
    ops_ms = flops / BF16_FLOPS * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    k3 = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "ms_range": [min(t3), max(t3)],
          "library_ms_range": [min(tlib), max(tlib)],
          "bound_ms": max(ops_ms, bytes_ms),
          "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print(f"[15] K3 timed at {K3_TIMED}, bf16, causal, in turns with "
          f"scaled_dot_product_attention: K3 {_spread(t3)}; "
          f"scaled_dot_product_attention {_spread(tlib)}; K3 / SDPA "
          f"{ms / lib_ms:.2f}x (medians); plain {plain_ms:.2f} ms; "
          f"bound {k3['bound_ms']:.4f} ms by {k3['bound_by']} "
          f"({pairs} causal query-key pairs x {B * H} heads x 4 x {hd}: "
          f"{flops / 1e9:.3f} GFLOP at 989 TFLOP/s bf16 = {ops_ms:.4f} ms; "
          f"{nbytes} B of "
          f"q/k/v/o = {bytes_ms:.4f} ms); {flops / ms / 1e9:.1f} TFLOP/s",
          flush=True)

    B, S, H, hd = K4_TIMED
    args = (*(torch.randn((B, S, H, hd), device=DEVICE, dtype=torch.bfloat16)
              for _ in range(3)),
            -torch.rand((B, S, H, hd), device=DEVICE),
            torch.randn((H, hd), device=DEVICE))
    t4 = _in_turns(lambda: K4.wkv6_fill(*args))[0]
    ms4 = statistics.median(t4)
    K4.wkv6_plain(*args)
    plain4 = cuda_time_ms(lambda: K4.wkv6_plain(*args), 3)
    ops = k4_ops_per_step(hd) * S * B * H
    nbytes4 = (3 * B * S * H * hd * 2 + 2 * B * S * H * hd * 4 + H * hd * 4
               + B * H * hd * hd * 4)
    ops_ms4 = ops / F32_FLOPS * 1e3
    bytes_ms4 = nbytes4 / MEM_BYTES_PER_S * 1e3
    k4 = {"ms": ms4, "plain_ms": plain4, "library_ms": None,
          "ms_range": [min(t4), max(t4)],
          "bound_ms": max(ops_ms4, bytes_ms4),
          "bound_by": "operations" if ops_ms4 >= bytes_ms4 else "bytes"}
    print(f"     K4 timed at {K4_TIMED}, r/k/v bf16: {_spread(t4)}; plain "
          f"{plain4:.2f} ms; no single-call "
          f"library equivalent; bound {k4['bound_ms']:.4f} ms by "
          f"{k4['bound_by']} ({S} steps x {B * H} heads x "
          f"{k4_ops_per_step(hd)} f32 operations = "
          f"{ops / 1e9:.3f} G at 67 TFLOP/s = {ops_ms4:.4f} ms; {nbytes4} B "
          f"of r/k/v/lw/u in, y/state out = {bytes_ms4:.4f} ms); "
          f"{B * H * -(-S // K4.CHUNK)} thread blocks in its increment and "
          f"output stages", flush=True)
    _device_profile(lambda: [K4.wkv6_fill(*args)
                             for _ in range(ROUND_LAUNCHES)],
                    f"{ROUND_LAUNCHES} K4 calls (three launches each)")
    K3.launches, K4.launches = before
    return k3, k4


# ---------------------------------------------------------------------------
# Training: K3's and K4's backward kernels, full-width AdamW steps
# ---------------------------------------------------------------------------
def _grad_err(got, want, tol, terms=0.0):
    """(max |got - want|, whether every entry lies within ``tol`` of the
    larger of the tensor's largest |entry| and 1e-2 ``terms`` (the size of
    the products the gradient sums: one that cancels to 0, as dq and dk of
    a row with a single live key do, is rounding noise of that size), plus
    ``tol`` relative, and in bf16 plus one bf16 ulp of the output)."""
    import torch
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not diff.numel():
        return 0.0, True
    scale = max(float(want.abs().max()), 1e-2 * terms)
    bound = tol * scale + tol * want.abs()
    if bf16:
        bound = bound + _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return float(diff.max()), bool((diff <= bound).all())


def _hold_k3_bwd(args, kw, what):
    """K3's backward kernel and ``flash_backward_plain`` on one recorded
    input; checks K3_BWD_PARITY and returns the largest |difference|."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    got = K3.flash_backward(*args, **kw)
    want = K3.flash_backward_plain(*args, **kw)
    torch.cuda.synchronize()
    q, k, v, _, _, do = (float(t.abs().max()) for t in args)
    scale = kw.get("scale") or 1.0 / args[0].shape[-1] ** 0.5
    terms = (do * v * k * scale, do * v * q * scale, do)
    err = 0.0
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, terms):
        e, ok = _grad_err(g, w, K3_BWD_TOL, t)
        check(ok, f"K3 backward != plain: {name}, {what} (max |diff| {e})")
        err = max(err, e)
    return err


def phase_k3_bwd_vs_plain(rng):
    """K3's forward lse and its backward kernel against the plain
    versions over phase 10's sweep, every output allocated on blocks left
    filled with 0xFF."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    t0 = time.perf_counter()
    before = (K3.launches, K3.bwd_launches)
    max_err, max_lse, n = 0.0, 0.0, 0
    for causal, window in ((True, None), (True, 64), (False, None)):
        for G, S, dtype, hd in itertools.product(
                (1, 4), K3_SWEEP_S, (torch.float32, torch.bfloat16),
                (64, 128)):
            B, H = 2, 8
            q = torch.as_tensor(rng.normal(size=(B, S, H, hd)),
                                dtype=dtype, device=DEVICE)
            k, v = (torch.as_tensor(rng.normal(size=(B, S, H // G, hd)),
                                    dtype=dtype, device=DEVICE)
                    for _ in range(2))
            mask = dict(causal=causal, window=window)
            what = (f"causal {causal}, window {window}, G {G}, S {S}, "
                    f"{dtype}, hd {hd}")
            lse_like = torch.empty((B, S, H), device=DEVICE)
            dirty = _dirty_allocator(q, lse_like)
            out, lse = K3.flash_fill(q, k, v, p_dtype=dtype,
                                     return_lse=True, **mask)
            torch.cuda.synchronize()
            check(lse.data_ptr() in dirty, "K3's lse did not land on the "
                  "0xFF block")
            _, want_lse = K3.flash_attention_plain(q, k, v, return_lse=True,
                                                   **mask)
            lse_err = float((lse - want_lse).abs().max())
            check(torch.allclose(lse, want_lse, rtol=2e-5, atol=2e-5),
                  f"K3 lse != plain: {what} (max |diff| {lse_err})")
            do = torch.as_tensor(rng.normal(size=out.shape), dtype=dtype,
                                 device=DEVICE)
            dirty = _dirty_allocator(q, k, v)
            got = K3.flash_backward(q, k, v, out, lse, do, **mask)
            torch.cuda.synchronize()
            check(all(g.data_ptr() in dirty for g in got),
                  "K3's dq, dk, dv did not land on the 0xFF blocks")
            again = K3.flash_backward(q, k, v, out, lse, do, **mask)
            check(all(torch.equal(g, a) for g, a in zip(got, again)),
                  f"K3 backward: a second call differs, {what}")
            del got, again
            max_err = max(max_err, _hold_k3_bwd((q, k, v, out, lse, do),
                                                mask, what))
            max_lse = max(max_lse, lse_err)
            n += 1
    K3.launches, K3.bwd_launches = before
    print(f"[16] K3 backward == flash_backward_plain and K3's lse == plain "
          f"on {n} cases (causal / window 64 / non-causal x G 1, 4 x S "
          f"{K3_SWEEP_S} x f32, bf16 x hd 64, 128; {K3_BWD_PARITY}; dq, dk, "
          f"dv and lse on 0xFF blocks; a second call bit-equal; max |diff| "
          f"{max_err:.3g}, lse "
          f"{max_lse:.3g}) in {time.perf_counter() - t0:.1f} s", flush=True)
    return max_err


def _hold_k4_bwd(args, kw, what):
    """K4's backward kernel and autograd through ``wkv6_plain`` on one
    input; checks K4_BWD_PARITY and returns the largest |difference|."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as K4
    got = K4.wkv6_backward(*args, **kw)
    want = K4.wkv6_backward_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du"), got, want):
        check(g.dtype == w.dtype, f"K4 backward {name} is {g.dtype}")
        e, ok = _grad_err(g, w, K4_BWD_TOL)
        check(ok, f"K4 backward != plain: {name}, {what} (max |diff| {e})")
        err = max(err, e)
    return err


def phase_k4_bwd_vs_plain(rng):
    """K4's backward kernel against autograd through ``wkv6_plain`` over
    phase 11's sweep, on the forward kernel's own chunk states, dr, dk,
    dv, dlw and du allocated on blocks left filled with 0xFF."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as K4
    t0 = time.perf_counter()
    before = (K4.launches, K4.bwd_launches)
    max_err, n = 0.0, 0
    for scale, S, dtype in itertools.product(
            (1.0, 2.0), K4_SWEEP_S, (torch.float32, torch.bfloat16)):
        args = _k4_inputs(rng, 2, S, 4, 64, scale, dtype)
        _, _, states = K4.wkv6_fill(*args, return_states=True)
        dy = torch.as_tensor(rng.normal(size=args[0].shape),
                             dtype=torch.float32, device=DEVICE)
        # r, k, v, lw and u have the sizes of dr, dk, dv, dlw and du (f32),
        # in the order the launcher allocates them
        dirty = _dirty_allocator(*args)
        got = K4.wkv6_backward(*args, dy, states=states)
        torch.cuda.synchronize()
        check(all(g.data_ptr() in dirty for g in got),
              "K4's dr, dk, dv, dlw, du did not land on the 0xFF blocks")
        again = K4.wkv6_backward(*args, dy, states=states)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"K4 backward: a second call differs, decay scale {scale}, "
              f"S {S}, {dtype}")
        del got, again
        max_err = max(max_err, _hold_k4_bwd(
            (*args, dy), dict(states=states),
            f"decay scale {scale}, S {S}, {dtype}"))
        n += 1
    K4.launches, K4.bwd_launches = before
    print(f"[17] K4 backward == autograd through wkv6_plain on {n} cases "
          f"(decay scale 1, 2 x S {K4_SWEEP_S} x r/k/v f32, bf16; hd 64, "
          f"H 4; {K4_BWD_PARITY}; dr, dk, dv, dlw, du on 0xFF blocks; a "
          f"second call bit-equal; max |diff| {max_err:.3g}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return max_err


@contextlib.contextmanager
def _last_call(mod, name, slot):
    """Within the block, each call of ``mod.name`` keeps its arguments in
    ``slot`` (the last call's remain)."""
    orig = getattr(mod, name)

    def record(*args, **kw):
        slot["args"], slot["kw"] = args, kw
        return orig(*args, **kw)
    setattr(mod, name, record)
    try:
        yield slot
    finally:
        setattr(mod, name, orig)


def _detached(slot):
    """A recorded call's (args, kw), its tensors out of the graph."""
    import torch
    return ([t.detach() if isinstance(t, torch.Tensor) else t
             for t in slot["args"]],
            {k: t.detach() if isinstance(t, torch.Tensor) else t
             for k, t in slot["kw"].items()})


def _lm_batch_s(cfg):
    """Host seconds of one LMBatcher batch of the training traffic."""
    from repro_torch.data import LMBatcher
    it = iter(LMBatcher(vocab=cfg.vocab_size, batch=TRAIN_BATCH,
                        seq=TRAIN_SEQ, seed=SEED))
    t0 = time.perf_counter()
    next(it)
    return time.perf_counter() - t0


def _train_full(arch, mod, bwd_name, n_fwd, n_bwd, phase):
    """``train_loop(device="cuda")`` on ``arch`` at full width: TRAIN_STEPS
    steps of TRAIN_BATCH x TRAIN_SEQ tokens from LMBatcher(seed=SEED),
    AdamWConfig(weight_decay=0.01) under cosine_with_warmup(3e-4, 5,
    TRAIN_STEPS) (train_loop's own choices), every launch count at 0 just
    before.  Checks finite losses and grad norms, a falling loss and the
    launches of ``mod`` per step; returns the run's numbers and the last
    backward call's arguments (layer 0 of the last step)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train_loop
    from repro_torch.models.params import count_params
    cfg = configs.get(arch)
    n = count_params(cfg)
    print(f"[{phase}] {arch} trains at full width ({n:,} parameters, "
          f"{cfg.param_dtype}, remat {cfg.remat}): {TRAIN_STEPS} AdamW steps "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens through train_loop",
          flush=True)
    batch_s = _lm_batch_s(cfg)
    mods = _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, counts, losses, gns = [time.perf_counter()], [], [], []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        gns.append(float(metrics["grad_norm"]))
        stamps.append(time.perf_counter())
        counts.append((mod.launches, mod.bwd_launches))

    slot = {}
    with _last_call(mod, bwd_name, slot):
        state, _ = train_loop(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                              seq=TRAIN_SEQ, log_every=1, device=DEVICE,
                              on_metrics=on_metrics)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    others = [(m.__name__.split(".")[-2], m.launches) for m in mods
              if m is not mod and m.launches]
    check(not others, f"{arch} training launched {others}")
    check(len(losses) == TRAIN_STEPS, f"{arch}: {len(losses)} steps logged")
    check(all(np.isfinite(losses)) and all(np.isfinite(gns)),
          f"{arch}: loss or grad norm not finite: {losses}, {gns}")
    check(np.mean(losses[-2:]) < losses[0], f"{arch}: the loss did not "
          f"fall: {losses}")
    per_step = [(b[0] - a[0], b[1] - a[1])
                for a, b in zip([(0, 0)] + counts, counts)]
    check(all(c == (n_fwd, n_bwd) for c in per_step),
          f"{arch}: launches per step {per_step}, want ({n_fwd}, {n_bwd})")
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(steps[1:])
    prof = _profile_train_step(cfg, state)
    del state
    torch.cuda.empty_cache()
    print(f"    losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{', '.join(f'{x:.3f}' for x in gns)}", flush=True)
    print(f"    step time median {step_s:.3f} s over steps 2-{TRAIN_STEPS} "
          f"({min(steps[1:]):.3f}-{max(steps[1:]):.3f}; step 1 "
          f"{steps[0]:.3f} s with the state's set-up), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, including one "
          f"LMBatcher batch on the host ({batch_s:.3f} s alone); peak "
          f"device memory {peak / 2**30:.2f} GiB; launches per step "
          f"{per_step[0]} (forward under remat, backward)", flush=True)
    return {"losses": losses, "grad_norms": gns, "step_s": step_s,
            "profile_busy": prof and prof["device_ms"] / prof["wall_ms"],
            "steps_s": steps, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
            / step_s, "peak_bytes": peak, "batch_s": batch_s,
            "fwd_launches": counts[-1][0], "bwd_launches": counts[-1][1],
            "last": slot}


def _profile_train_step(cfg, state):
    """torch.profiler over one more step of the trained state (after the
    run's counts are read): device busy share and the top kernels."""
    import torch
    from repro_torch.data import LMBatcher
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, AdamWConfig(weight_decay=0.01),
                           constant(1e-4))
    toks = next(iter(LMBatcher(vocab=cfg.vocab_size, batch=TRAIN_BATCH,
                               seq=TRAIN_SEQ, seed=SEED)))["tokens"]
    batch = {"tokens": torch.as_tensor(toks, device=DEVICE)}
    return _device_profile(lambda: step(state, batch),
                           f"one {cfg.name} training step")


def phase_train_olmo():
    """olmo-1b at full width trains through train_loop on K3; layer 0's
    recorded backward is held against flash_backward_plain; K3's forward
    and backward share of a step."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    run = _train_full("olmo-1b", K3, "flash_backward", 2 * 16, 16, 18)
    args, kw = _detached(run.pop("last"))
    before = (K3.launches, K3.bwd_launches)
    err = _hold_k3_bwd(args, kw, "olmo-1b layer 0, last step")
    q, k, v = args[:3]
    fwd_ms = cuda_time_ms(lambda: K3.flash_fill(
        q, k, v, causal=True, p_dtype=q.dtype, return_lse=True), 5)
    bwd_ms = cuda_time_ms(lambda: K3.flash_backward(*args, **kw), 3)
    K3.launches, K3.bwd_launches = before
    share = (32 * fwd_ms + 16 * bwd_ms) / 1e3 / run["step_s"]
    print(f"    K3 backward == plain ({K3_BWD_PARITY}) on layer 0's recorded "
          f"q/k/v/o/lse/dO {tuple(q.shape)}, {q.dtype}: max |diff| "
          f"{err:.3g}; K3 forward (with lse) {fwd_ms:.3f} ms x 32 and "
          f"backward {bwd_ms:.3f} ms x 16 a step: {100 * share:.1f} % of the "
          f"step", flush=True)
    del args, kw
    torch.cuda.empty_cache()
    return dict(run, k3_err=err, k3_fwd_ms=fwd_ms, k3_bwd_ms=bwd_ms,
                k3_share=share)


def phase_train_rwkv():
    """rwkv6-3b at full width trains through train_loop on K4; layer 0's
    recorded backward is held against autograd through wkv6_plain; K4's
    forward and backward share of a step."""
    import torch
    from repro_torch.kernels.wkv6 import kernel as K4
    run = _train_full("rwkv6-3b", K4, "wkv6_backward", 2 * 32, 32, 19)
    args, kw = _detached(run.pop("last"))
    before = (K4.launches, K4.bwd_launches)
    err = _hold_k4_bwd(args[:6], kw, "rwkv6-3b layer 0, last step")
    ins = args[:5]
    fwd_ms = cuda_time_ms(lambda: K4.wkv6_fill(*ins, return_states=True), 5)
    bwd_ms = cuda_time_ms(lambda: K4.wkv6_backward(*args, **kw), 3)
    K4.launches, K4.bwd_launches = before
    share = (64 * fwd_ms + 32 * bwd_ms) / 1e3 / run["step_s"]
    print(f"    K4 backward == autograd through wkv6_plain ({K4_BWD_PARITY}) "
          f"on layer 0's recorded r/k/v/lw/u/dy {tuple(ins[0].shape)}, "
          f"{ins[0].dtype}: max |diff| {err:.3g}; K4 forward {fwd_ms:.3f} ms "
          f"x 64 and backward {bwd_ms:.3f} ms x 32 a step: "
          f"{100 * share:.1f} % of the step", flush=True)
    del args, kw, ins
    torch.cuda.empty_cache()
    return dict(run, k4_err=err, k4_fwd_ms=fwd_ms, k4_bwd_ms=bwd_ms,
                k4_share=share)


def _numpy_state(cfg, seed):
    """A train state of ``cfg`` made with numpy (parameters as
    ``init_params`` draws them, zero moments), in the layout
    ``state_from_jax`` carries."""
    import math
    import numpy as np
    from repro_torch.models.params import _defs, tree_map
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init in ("zeros", "ones"):
            return getattr(np, d.init)(d.shape, np.float32)
        x = rng.normal(size=d.shape).astype(np.float32)
        if d.init == "fan_in":
            fan = d.shape[d.lead] if len(d.shape) > d.lead else 1
            return x / np.float32(math.sqrt(max(fan, 1)))
        return x * np.float32(d.scale)
    params = tree_map(one, _defs(cfg))
    mu = tree_map(lambda a: {"m": np.zeros_like(a), "v": np.zeros_like(a)},
                  params)
    return {"params": params, "opt": {"mu": mu, "count": np.int32(0)},
            "step": np.int32(0)}


def phase_train_card_vs_cpu():
    """The reduced configs in f32 (TF32 off) train on the card and on the
    CPU from one numpy-made state: TRAIN_CPU_STEPS steps of make_train_step
    on the same LMBatcher batches, every loss and grad norm within
    TRAIN_CPU_TOL; then a checkpoint saved on the card after step 2 and
    restored by restore_latest gives a step-3 loss bit-equal to the
    unbroken run's."""
    import numpy as np
    import torch
    from repro_torch import checkpoint, configs
    from repro_torch import train as train_mod
    from repro_torch.data import LMBatcher
    from repro_torch.optim import AdamWConfig, constant
    t0 = time.perf_counter()
    ckdir = ROOT / "build" / "smoke_ckpt"
    out = []
    for arch in ("olmo-1b", "rwkv6-3b"):
        cfg = configs.get(arch, reduced=True)
        opt = AdamWConfig(weight_decay=0.01)
        tree = _numpy_state(cfg, SEED)
        it = iter(LMBatcher(vocab=cfg.vocab_size, batch=4, seq=64,
                            seed=SEED))
        batches = [next(it)["tokens"] for _ in range(TRAIN_CPU_STEPS)]
        step = train_mod.make_train_step(cfg, opt, constant(1e-3))
        runs = {}
        shutil.rmtree(ckdir, ignore_errors=True)
        for dev in (DEVICE, "cpu"):
            state = train_mod.state_from_jax(cfg, opt, tree, dev)
            rec = []
            for i, b in enumerate(batches):
                state, m = step(state, {"tokens": torch.as_tensor(
                    b, device=dev)})
                rec.append((float(m["loss"]), float(m["grad_norm"])))
                if dev == DEVICE and i == 1:
                    checkpoint.save(str(ckdir), 2, state)
            runs[dev] = rec
        (card, cpu) = runs[DEVICE], runs["cpu"]
        for i, ((lc, gc), (lp, gp)) in enumerate(zip(card, cpu)):
            check(abs(lc - lp) <= TRAIN_CPU_TOL[0] * abs(lp)
                  and abs(gc - gp) <= TRAIN_CPU_TOL[1] * abs(gp),
                  f"{arch} step {i + 1}: card loss {lc}, grad norm {gc}; "
                  f"CPU {lp}, {gp}")
        like = train_mod.state_from_jax(cfg, opt, tree, DEVICE)
        restored, at = checkpoint.restore_latest(str(ckdir), like, DEVICE)
        check(at == 2, f"{arch}: restore_latest found step {at}")
        restored, m = step(restored, {"tokens": torch.as_tensor(
            batches[2], device=DEVICE)})
        resumed = (float(m["loss"]), float(m["grad_norm"]))
        check(resumed[0] == card[2][0], f"{arch}: the step-3 loss after "
              f"restore_latest is {resumed[0]!r}, the unbroken run's "
              f"{card[2][0]!r}")
        shutil.rmtree(ckdir, ignore_errors=True)
        rel = max(abs(c[0] - p[0]) / abs(p[0]) for c, p in zip(card, cpu))
        relg = max(abs(c[1] - p[1]) / abs(p[1]) for c, p in zip(card, cpu))
        out.append(f"{arch}: losses {', '.join(f'{c[0]:.6f}' for c in card)}"
                   f" (largest relative difference from the CPU {rel:.2g}, "
                   f"grad norms {relg:.2g}); resumed step 3 loss bit-equal "
                   f"{resumed[0]!r}, grad norm "
                   f"{'bit-equal' if resumed[1] == card[2][1] else 'differs'}"
                   f" ({resumed[1]!r} / {card[2][1]!r})")
    print(f"[20] card == CPU training on the reduced configs in f32 "
          f"({TRAIN_CPU_STEPS} steps of 4 x 64 tokens from one numpy-made "
          f"state; loss within {TRAIN_CPU_TOL[0]}, grad norm within "
          f"{TRAIN_CPU_TOL[1]} relative): " + "; ".join(out)
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)


def k4_bwd_ops_per_chunk(hd, C=32):
    """f32 operations K4's backward needs per (chunk, head), counted from
    the work of csrc/wkv6_bwd.cu and not from what one design recomputes
    (an fma counts 2, an exp, a min or a compare 1).  Increments: the
    cumulative sum, r exp(Lq), exp(Lc), R~^T dy.  Scan: one fma per state
    entry.  Gradients: the cumulative sums, R~ and K~, dA over j <= i; per
    pair j < i and column: W once (difference, min, exp), A's two
    multiplies and add, and dr's and dk's multiply and two fmas each (16);
    A on the diagonal; per (i, d): dR~, dK~ and K~ G (an fma per n each),
    A^T dy over i' >= i and the combination (24); per column: G . S, dLc,
    du's partial and the reverse sum."""
    inc = 3 * C * hd + hd + 2 * C * hd * hd
    scan = 2 * hd * hd
    grad = (2 * C * hd + 2 * C * hd + 3 * C * hd + C * (C + 1) * hd
            + 8 * C * (C - 1) * hd + 3 * C * hd
            + C * hd * 6 * hd + hd * C * (C + 1)
            + 24 * C * hd + hd * (2 * hd + 4 * C + 2))
    return inc + scan + grad


def bwd_ptxas():
    """{kernel line name: [{entry, registers, spill_bytes, stack_bytes}]}
    for every entry function of the two backward sources, from the
    ``-Xptxas -v`` reports their builds kept; printed."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.wkv6 import kernel as K4
    out = {}
    for key, src in (("flash_backward", K3.SOURCE_BWD),
                     ("wkv6_backward", K4.SOURCE_BWD)):
        log = build.kept_report(src)
        check(log is not None, f"no ptxas report kept for {src.name}")
        out[key] = []
        for name, regs, spill, stack, _ in ptxas_table(log):
            entry = name.split("(")[0].removeprefix("void ")
            print(f"    {src.name} {entry}: {regs} registers, {spill} spill "
                  f"bytes, {stack} stack bytes", flush=True)
            out[key].append({"entry": entry, "registers": regs,
                             "spill_bytes": spill, "stack_bytes": stack})
    return out


def _k3_bwd_bound(B, S, H, hd, card_flops):
    """Least time of K3's backward at (B, S, H, hd) causal, bf16 inputs:
    10 hd FLOP per live (query, key) pair (s, dp, dv, dk, dq) at
    ``card_flops``, or q, k, v, O, dO and lse read once and dq, dk, dv
    written once at the card's memory rate."""
    from repro_torch.tune.cost import MEM_BYTES_PER_S
    pairs = k3_pairs(S, True, None, None)
    flops = pairs * 10 * hd * B * H
    nbytes = 8 * B * S * H * hd * 2 + B * S * H * 4
    ops_ms, bytes_ms = flops / card_flops * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def timing_backward():
    """Phase 15's training timings: K3 forward + backward at K3_TRAIN bf16
    causal through autograd, in turns with scaled_dot_product_attention's
    forward + backward (a yardstick the port never calls); K3's backward
    alone in turns with SDPA's backward alone (autograd.grad on a retained
    SDPA graph, the same function: q, k, v, O, lse and dO in, dq, dk, dv
    out); K4's backward at K4_TRAIN alone; each beside its plain version
    and its bound on this card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.wkv6 import kernel as K4
    from repro_torch.tune.cost import MEM_BYTES_PER_S
    before = (K3.launches, K3.bwd_launches, K4.launches, K4.bwd_launches)
    B, S, H, hd = K3_TRAIN
    bf = dict(device=DEVICE, dtype=torch.bfloat16)
    q, k, v, do = (torch.randn((B, S, H, hd), **bf) for _ in range(4))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))

    def k3_fb():
        out = K3.FlashAttnFunction.apply(ql, kl, vl, True, None, None, None,
                                         torch.bfloat16)
        return torch.autograd.grad(out, (ql, kl, vl), do)

    def sdpa_fb():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(out, (qt, kt, vt), dot)
    tfb, tlib = _in_turns(k3_fb, sdpa_fb)
    out, lse = K3.flash_fill(q, k, v, causal=True, p_dtype=torch.bfloat16,
                             return_lse=True)
    out_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    tb, tlib_b = _in_turns(
        lambda: K3.flash_backward(q, k, v, out, lse, do, causal=True),
        lambda: torch.autograd.grad(out_lib, (qt, kt, vt), dot,
                                    retain_graph=True))
    K3.flash_backward_plain(q, k, v, out, lse, do, causal=True)
    plain_b = cuda_time_ms(lambda: K3.flash_backward_plain(
        q, k, v, out, lse, do, causal=True), 2)
    bound, by, flops, nbytes = _k3_bwd_bound(B, S, H, hd, BF16_FLOPS)
    bound32 = _k3_bwd_bound(B, S, H, hd, F32_FLOPS)[0]
    ms = statistics.median(tb)
    k3b = {"ms": ms, "ms_range": [min(tb), max(tb)], "plain_ms": plain_b,
           "library_ms": statistics.median(tlib_b),
           "library_ms_range": [min(tlib_b), max(tlib_b)],
           "bound_ms": bound, "bound_by": by, "bound_f32_ms": bound32,
           "fwd_bwd_ms": statistics.median(tfb),
           "fwd_bwd_ms_range": [min(tfb), max(tfb)],
           "library_fwd_bwd_ms": statistics.median(tlib),
           "library_fwd_bwd_ms_range": [min(tlib), max(tlib)]}
    smi = nvidia_smi("name,power.limit")
    print(f"     ({smi}) K3 forward + backward through autograd at "
          f"{K3_TRAIN}, bf16, "
          f"causal, in turns with scaled_dot_product_attention's: K3 "
          f"{_spread(tfb)}; SDPA {_spread(tlib)}; K3 / SDPA "
          f"{k3b['fwd_bwd_ms'] / k3b['library_fwd_bwd_ms']:.2f}x (medians). "
          f"K3 backward alone {_spread(tb)}, in turns with SDPA's backward "
          f"alone (autograd.grad on a retained graph) {_spread(tlib_b)}: "
          f"K3 / SDPA {ms / k3b['library_ms']:.2f}x (medians); plain "
          f"{plain_b:.2f} ms; bound "
          f"{bound:.4f} ms by {by} ({flops / 1e9:.3f} GFLOP, 10 x {hd} a "
          f"live pair, at 989 TFLOP/s bf16; {bound32:.4f} ms at 67 TFLOP/s "
          f"f32; {nbytes} B); {flops / ms / 1e9:.1f} TFLOP/s of the 10 x "
          f"{hd} needed, {2 * flops / ms / 1e9:.1f} of the 20 x {hd} the "
          f"tensor-core kernels issue", flush=True)
    del ql, kl, vl, qt, kt, vt, out, lse, out_lib

    B, S, H, hd = K4_TRAIN
    args = (*(torch.randn((B, S, H, hd), **bf) for _ in range(3)),
            -torch.rand((B, S, H, hd), device=DEVICE),
            torch.randn((H, hd), device=DEVICE))
    _, _, states = K4.wkv6_fill(*args, return_states=True)
    dy = torch.randn((B, S, H, hd), device=DEVICE)
    t4 = _in_turns(lambda: K4.wkv6_backward(*args, dy, states=states))[0]
    K4.wkv6_backward_plain(*args, dy)
    plain4 = cuda_time_ms(lambda: K4.wkv6_backward_plain(*args, dy), 1)
    nc = -(-S // K4.CHUNK)
    ops = k4_bwd_ops_per_chunk(hd) * nc * B * H
    nbytes4 = (3 * 2 + 2 * 4 + 3 * 2 + 4) * B * S * H * hd + 2 * H * hd * 4
    ops_ms, bytes_ms = ops / F32_FLOPS * 1e3, nbytes4 / MEM_BYTES_PER_S * 1e3
    ms4 = statistics.median(t4)
    k4b = {"ms": ms4, "ms_range": [min(t4), max(t4)], "plain_ms": plain4,
           "library_ms": None, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    print(f"     ({smi}) K4 backward alone at {K4_TRAIN}, r/k/v bf16: "
          f"{_spread(t4)}; "
          f"plain (autograd through wkv6_plain) {plain4:.2f} ms; no "
          f"single-call library equivalent; bound {k4b['bound_ms']:.4f} ms "
          f"by {k4b['bound_by']} ({k4_bwd_ops_per_chunk(hd)} f32 operations "
          f"a (chunk, head), counted from csrc/wkv6_bwd.cu, x {nc * B * H} = "
          f"{ops / 1e9:.3f} G at 67 TFLOP/s = {ops_ms:.4f} ms; {nbytes4} B "
          f"of r/k/v/lw/dy/u in, dr/dk/dv/dlw/du out = {bytes_ms:.4f} ms); "
          f"{ops / ms4 / 1e9:.1f} G f32 operations/s", flush=True)
    K3.launches, K3.bwd_launches, K4.launches, K4.bwd_launches = before
    return k3b, k4b


def _train_summary(run, kern):
    """A training phase's numbers for the kernels' JSON line."""
    return {"step_s": run["step_s"], "tokens_per_s": run["tokens_per_s"],
            "device_busy_share": run["profile_busy"],
            "peak_gib": run["peak_bytes"] / 2**30, "losses": run["losses"],
            "kernel_share": run[f"{kern}_share"],
            "fwd_ms": run[f"{kern}_fwd_ms"], "bwd_ms": run[f"{kern}_bwd_ms"]}


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
    # every f32 comparison on the card runs in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    try:
        card = phase_identity()
        phase_build()
        ptxas_bwd = bwd_ptxas()
        rng = np.random.default_rng(SEED)
        max_err = phase_kernel_vs_plain(rng)
        ext_err = phase_ext_vs_plain(rng)
        genome = alphabets.random_dna(rng, 1_000_000)
        launches, blocks = phase_main_path(rng, genome)
        long_blocks = phase_long_reads(rng, genome)
        timing = phase_path_shapes(blocks, long_blocks, card)
        tuned = phase_tune(card)
        xdrop = phase_xdrop(genome)
        k2_err = phase_k2_vs_plain(rng)
        mapper = phase_mapper(card)
        k2_timing = phase_k2_timing(mapper["screen"], card)
        geno = phase_genotyping(card)
        phase_posterior(geno["sites"])
        service = phase_service(geno, mapper)
        del mapper["mapper"], mapper["reads"], geno["sites"]
        k3_err = phase_k3_vs_plain(rng)
        k4_err = phase_k4_vs_plain(rng)
        olmo = phase_olmo()
        rwkv = phase_rwkv()
        phase_card_vs_cpu()
        k3_timing, k4_timing = phase_timing_k3_k4()
        k3b_timing, k4b_timing = timing_backward()
        k3b_err = phase_k3_bwd_vs_plain(rng)
        k4b_err = phase_k4_bwd_vs_plain(rng)
        olmo_train = phase_train_olmo()
        rwkv_train = phase_train_rwkv()
        phase_train_card_vs_cpu()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": "wavefront_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/wavefront/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront/kernel.py:198",
        "launches": launches, "launches_mapper": mapper["k1_launches"],
        "launches_service": service["k1_launches"],
        "launches_tune": tuned["launches"],
        "launches_xdrop_off": {k: v["k1_launches"]
                               for k, v in xdrop.items()},
        "tune": tuned["points"], "lint": tuned["lint"],
        "xdrop_wall_s": {k: v["xdrop_wall_s"] for k, v in xdrop.items()},
        "service": {k: service[k] for k in (
            "requests_per_s", "p50_s", "p99_s", "p50_bucket_s",
            "p99_bucket_s", "k1_share", "cold_first_batch_compile_s",
            "warm_boot_dummy_compile_s", "warm_serve_compile_s",
            "workers_in_turns", "k1_genotyping", "k1_mapping",
            "k1_tiling")},
        "parity": "exact",
        **{k: v for k, v in timing.items() if k != "max_abs_err"},
        "max_abs_err": max(max_err, timing["max_abs_err"],
                           mapper["k1_err"], service["k1_err"]),
        "mapper_extension": mapper["k1_extension"],
        "ext_families_max_rel_err": ext_err,
        "genotyping": {k: geno[k] for k in (
            "launches", "ms", "ms_range", "bound_ms", "bound_by", "plain_ms",
            "max_rel_err", "event_ms", "host_us", "profiler_records")},
        "library_ms": None}, {
        "name": "myers_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/myers/csrc/myers.cu",
        "replaces": "src/repro/kernels/myers/kernel.py:112",
        "launches": mapper["k2_launches"], "parity": "exact",
        "launches_service": service["k2_launches"],
        "launches_mapping_service": service["k2_mapping"],
        "max_abs_err": max(k2_err, mapper["k2_err"], service["k2_err"]),
        **k2_timing, "library_ms": None}, {
        "name": "flash_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:95",
        "launches": olmo["k3_launches"],
        "launches_train": olmo_train["fwd_launches"],
        "parity": K3_PARITY,
        "max_abs_err": max(k3_err, olmo["k3_err"]), **k3_timing}, {
        "name": "wkv6_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:80",
        "launches": rwkv["k4_launches"],
        "launches_train": rwkv_train["fwd_launches"], "parity": "5e-4",
        "max_abs_err": max(k4_err, rwkv["k4_err"]), **k4_timing}, {
        "name": "flash_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu",
        "replaces": "src/repro/models/layers.py:163",
        "launches": olmo_train["bwd_launches"], "parity": K3_BWD_PARITY,
        "max_abs_err": max(k3b_err, olmo_train["k3_err"]),
        "train": _train_summary(olmo_train, "k3"),
        "ptxas": ptxas_bwd["flash_backward"], **k3b_timing}, {
        "name": "wkv6_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/models/mixers.py:411",
        "launches": rwkv_train["bwd_launches"], "parity": K4_BWD_PARITY,
        "max_abs_err": max(k4b_err, rwkv_train["k4_err"]),
        "train": _train_summary(rwkv_train, "k4"),
        "ptxas": ptxas_bwd["wkv6_backward"], **k4b_timing}]
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
