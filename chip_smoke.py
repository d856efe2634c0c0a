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
and the ``banded`` engine; the alignment launcher ``serve_alignments``), LM
serving (``ServeSession``: per-slot prefill on K3 for olmo-1b,
stablelm-12b, qwen3-moe-30b-a3b, llava-next-mistral-7b, recurrentgemma-9b
(K3 at hd 256 beside the RG-LRU) and deepseek-v3-671b (K3 at q/k 192 over
v 128, the absorbed MLA decode), K4 for rwkv6-3b, batched greedy decode;
prefill and decode of phi3-medium-14b, command-r-plus-104b, llava's
patch-prefixed prompt and whisper-medium's encoder-decoder) and LM
training (``launch.train.train_loop``: AdamW steps of olmo-1b,
stablelm-12b, whisper-medium, llava-next-mistral-7b, qwen3-moe-30b-a3b,
recurrentgemma-9b and deepseek-v3-671b (with its MTP head) on K3 and
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
     registers and spills of every entry of K3's forward and the two
     backward sources (also in the kernels line);
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
  3c. K1 on PEs no hand-written functor instantiates, each functor
     generated from the spec's torch PE (``kernels/wavefront/synth.py``):
     the quickstart's ti/tv kernel, a PE that reads (i, j), an f32
     max-plus PE over a user table, #2, #15 and the pair-HMM forward at
     logsumexp with their family set to None, and three specs whose
     combination no hand-written functor instantiates (#1 at min-plus,
     the pair-HMM forward over the whole matrix, #16 edit distance with
     no PE family); one nvcc per functor, all
     at once (the ti/tv kernel's inside its plan's first dispatch); each
     against the plain version at phase 3's buckets and each twin against
     its hand-written functor on the same inputs (integers bit-equal);
     ``run_pairs`` of 2048 ti/tv pairs on the ``wavefront`` engine (K1
     launched, equal to the card's reference engine and to the CPU path,
     cold and warm compile_s, a second parameter set building nothing);
     #2's two functors in turns and the ti/tv kernel timed at batch 1024,
     256x256; the hand-written instantiations' ptxas equal to
     K1_HAND_PTXAS, entry by entry;
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
     R401 reading the built libraries' ptxas reports, has no error; its
     R3xx counts are printed, and every linted point's plan runs once on
     the card under ``hlo_cost.HostReads`` (K1 and K2 launched) and reads
     the device on the host at exactly the sites R303 found on the CPU;
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
     first 2048 requests warm-started with 1, 2, 2 and 1 workers in turns,
     each == the clean run; the whole stream under FaultPlan(seed=0, kill
     w0 at dispatch 1, launch failures p 0.1): bit-identical, no double
     completion, submitted == resolved + dead_lettered; the first 2048
     requests with degrade="myers" past a watermark: each degraded
     edit_distance == plain K2's.  Then 256 of phase G's sites through
     ``GenotypingService`` (each call == phase G's), 4096 of phase 8's reads
     through ``ReadMappingService`` (SAM lines == map_reads), ``tiled_align``
     of a 5 kb #2 pair (tile 256, overlap 64) on K1 == on the reference
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
     bit-equal to the unbroken run's;
 21. K3's forward and backward at head width 160 (stablelm-12b) vs their
     plain versions: causal, window 64, non-causal, non-causal with k_len
     S/2 + 1 x G 1, 4 x K3_SWEEP_S; forward f32 and bf16 on exact and
     normal scores (K3_PARITY), backward and lse f32 and bf16
     (K3_BWD_PARITY, 0xFF blocks, a second call bit-equal);
 22. K3 at Sq != Sk, forward and backward vs plain: whisper-medium's
     cross-attention (448 queries over 1500 keys, 16 heads of 64,
     non-causal) and a causal suffix (200 over 1000, q_start 800, hd 128),
     f32 and bf16; v of width 16 beside q and k of 32, a pair K3 is not
     built for, raises on the card and launches nothing;
 23. K3 timed in turns with SDPA: forward at (1, 1536, 32 / 8 heads, 160)
     causal, backward alone at (4, 2048, 32 / 8, 160) causal, both at the
     cross-attention shape; plain versions, bounds, the card's power limit;
 24. stablelm-12b at full width (40 layers, hd 160, 12.1 B parameters,
     bf16, random from seed 0) serves phase 12's traffic: K3 launched
     16 x 40 times, K4 never, K3 held on layer 0 of the longest prompt, the
     prefill and first decode logits held to ``forward`` on as many layers
     as an f32 copy fits with FIT_SPARE to spare (printed);
 25. phi3-medium-14b at full width and depth (48 / 16 padded heads of 128),
     and command-r-plus-104b at full width and the depth whose bf16 weights
     and f32 copy fit with FIT_SPARE to spare (printed): one prefill and
     decode of the longest prompt each, K3 once a layer, K3 held on layer
     0, the logits held to ``forward`` (phi3's f32 check on a depth cut);
 26. stablelm-12b at full width and STABLELM_TRAIN_LAYERS of 40 layers
     trains as phase 18 does, each step two microbatches of 2 x 2048 (its
     accum_steps; 2 x 2 x 4 K3 forwards and 2 x 4 backwards a step, hd
     160), the first step's recorded layer-0 backward held against
     ``flash_backward_plain``; step time, tokens/s, peak memory;
 27. ``serve_alignments`` at the JAX launcher's defaults on the card (32
     pairs of 128, #2): results == the CPU's reference engine, K1 launched;
     ``python3 -m repro_torch.launch.serve --mode align`` exits 0;
 28. qwen3-moe-30b-a3b at full width (48 layers, 128 experts top-8, 30.5 B
     parameters, bf16, random from seed 0) serves phase 12's traffic: K3
     launched 16 x 48 times, K4 never, K3 held on layer 0; the choices
     capacity 1.25 drops in one prefill, per layer; the f32 logits check on
     the layers an f32 copy fits, the prefill held to ``forward`` over the
     prompt alone and each of the two positions to ``forward`` over prompt
     + 1 where every token up to it was routed alike (the others counted
     as skipped: a later token can take an earlier one's slot), and both
     held at a capacity where nothing drops, a spoiled cache failing;
 29. whisper-medium at full width (24 + 24 layers): 8 windows of 1500
     frames, prompts of 4-32 tokens, each prefilled alone (K3 72 times:
     encoder, causal self-attention, cross-attention at Sq != Sk) into one
     cache of 448 decoder slots, 64 batched greedy decode steps; K3 held on
     layer 0's encoder and cross inputs; the prefill and first decode
     logits held to ``forward`` in f32, a spoiled cache failing;
 30. llava-next-mistral-7b at full width serves phase 12's traffic as
     phase 24 does, then one prefill of 2880 patch embeddings + 512 tokens
     and 32 decode steps after ``grow_cache`` (K3 once a layer, held on
     layer 0), every logit of them held to ``forward`` in f32;
 31. whisper-medium at full depth, llava at 4 of 32 layers and qwen3-moe at
     2 of 48 train through ``train_loop`` as phase 18 does (frames and
     patches as its frontend prefix makes them; qwen3-moe's moe_aux logged
     and finite), each run's last recorded K3 backward held to plain; the
     three reduced configs on the card against the CPU as phase 20 does;
 32. K3's forward and backward at hd 256 and at q/k 192 with v 128 vs
     their plain versions (K3_WIDTH_CASES: G 1 and 8 at 256, G 1 at
     192/128; causal / window 64 / non-causal / k_len S/2 + 1 x
     K3_WIDTH_SWEEP_S; forward f32 and bf16 exact and normal, backward f32 and
     bf16 on 0xFF blocks, a second call bit-equal), the backward on rows
     with one live key (S 1, k_len 1, hd 256, K3_ONE_KEY_DRAWS draws of
     each type), pairs not built raising; then the bf16 kernels timed alone in turns with SDPA
     (PyTorch's default dispatch, named by the backend it picks, else the
     first fused backend that takes the shape, or "none" with their
     refusals) at recurrentgemma-9b's local attention (1, 4096, 16 / 1,
     256, window 2048) and training shape (4, 2048), and at MLA's (1,
     1536, 128, 192 / 128) and training shape (1, 2048), beside their
     plain versions and bounds (2 (hd + hd_v) FLOP a live pair forward,
     6 hd + 4 hd_v backward, at 989 TFLOP/s);
 33. recurrentgemma-9b at full width and depth (38 layers, 9.63 B
     parameters) serves RG_REQUESTS prompts of 2048-3072 tokens (every
     window ring full) on 8 slots of 4096: K3 launched 12 times a prefill,
     K4 never; K3 held on the first attention sublayer; prefill seconds,
     ms a decode step, peak memory; the logits held to ``forward``;
 34. deepseek-v3-671b at full width, its 3 first_dense layers and the
     MoE layers that fit (printed), serves phase 12's traffic: K3 at
     (192, 128) once a layer a prefill, the absorbed MLA decode, the
     sigmoid router and shared expert; capacity drops; the logits held to
     ``forward`` on the dense layers;
 35. recurrentgemma-9b (1 period: RG-LRU, RG-LRU, local attention) and
     deepseek-v3-671b (MLA layers with a dense FFN and the MTP head, no MoE
     layer) train through ``train_loop`` as phase 18 does, K3's backward at
     the new widths counted a step and its last recorded call held to
     plain; the two reduced configs on the card against the CPU as phase
     20 does;
  M. the placement path (ROADMAP item 14) on a process group of one rank
     over NCCL and ``make_host_mesh()``'s (1, 1) data x model mesh: (a)
     ``make_sharded_aligner`` on phase 4's 8192 windows in their padded
     blocks, bit-equal to ``align_batch`` (score, end cell, moves) with
     K1 launched once a block; (b) ``AlignmentService(mesh=)`` drains
     phase S's first 2048 requests, results equal to the unsharded
     service's, placement ``data@data=1xmodel=1``; (c) olmo-1b at full
     width through ``train_loop(mesh=)`` under TRAIN_RULES, 3 steps,
     losses within 2e-6 relative of phase 18's first three, K3 launched a
     step as in phase 18, step time and peak memory beside phase 18's;
     (d) its parameters saved from the mesh and restored with no mesh,
     bit-equal.  Every phase's seconds are printed as it ends.
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
# shared with the autotuner, and each kernel's work formula (K2's operations
# a word-column, K3's live pairs, K4's operations a step and a chunk) in its
# kernel module, one copy shared with launch/hlo_cost.py; the phases import
# them once the checkout's src is on the path.
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
# phase 3c: K1 generated from a spec's torch PE (kernels/wavefront/synth.py):
# its own generator, the ti/tv kernel's run_pairs (pairs, block), and the
# phase's time budget in seconds
GEN_SEED, GEN_PAIRS, GEN_BLOCK, GEN_PHASE_S = 17, 2048, 1024, 90
# registers and spill bytes of K1's hand-written instantiations as nvcc
# built them before the template took generated functors (kSlots, kIJ):
# wavefront.cu's (instantiations, fewest and most registers, spill bytes)
# and each of wavefront_ext.cu's (registers, spill bytes); phase 3c holds
# the build to them
K1_HAND_PTXAS = {
    "K1": (80, 64, 80, 48),
    "K1 ext": {
        f"void <unnamed>::wavefront_kernel<<unnamed>::{pe}, {r}, {b}>"
        f"(<unnamed>::KArgs)": v for pe, r, b, v in (
            ("PairHmmBackwardPE<2>", 2, "false", (64, 0)),
            ("PairHmmBackwardPE<2>", 2, "true", (78, 0)),
            ("PairHmmBackwardPE<0>", 2, "false", (64, 0)),
            ("PairHmmBackwardPE<0>", 2, "true", (64, 0)),
            ("PairHmmForwardPE<2>", 2, "false", (78, 0)),
            ("PairHmmForwardPE<2>", 2, "true", (78, 0)),
            ("PairHmmForwardPE<0>", 2, "false", (64, 0)),
            ("PairHmmForwardPE<0>", 2, "true", (64, 0)),
            ("ViterbiPE", 0, "false", (64, 0)),
            ("ProfilePE", 0, "false", (76, 0)),
            ("DtwPE<<unnamed>::AbsCost>", 2, "false", (64, 0)),
            ("DtwPE<<unnamed>::ComplexCost>", 0, "false", (64, 8)))}}
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
# slice 11: K3 at stablelm-12b's head width, 32 query and 8 key/value heads
# of 160, at the serving path's longest prompts and at the training shape
# (B, S, H, Kh, hd); at whisper-medium's cross-attention, 448 decoder
# positions over 1500 encoder frames, 16 heads of 64 (B, Sq, Sk, H, hd);
# and a causal suffix of the keys, q_start = Sk - Sq (B, Sq, Sk, H, hd)
K3_HD160_TIMED = (1, 1536, 32, 8, 160)
K3_HD160_TRAIN = (4, 2048, 32, 8, 160)
K3_CROSS = (1, 448, 1500, 16, 64)
K3_CROSS_ROUNDS = (3 * ROUNDS, 5 * ROUND_LAUNCHES)   # its timing's rounds
K3_SUFFIX = (1, 200, 1000, 8, 128)
# slice 13: K3 at recurrentgemma-9b's local attention (16 query heads of 256
# over one key/value head, window 2048) and at DeepSeek-V3's MLA (128 heads,
# q/k of 128 + 64 rotary columns, v of 128), at the serving path's longest
# prompts and at training shapes (B, S, H, Kh, hd, hd_v, window; MLA's is
# deepseek's microbatch in phase 35); and the correctness sweep's pairs
# (hd, hd_v, G) at H 8 and its lengths
K3_RG_TIMED = (1, 4096, 16, 1, 256, 256, 2048)
K3_RG_TRAIN = (4, 2048, 16, 1, 256, 256, 2048)
K3_MLA_TIMED = (1, 1536, 128, 128, 192, 128, None)
K3_MLA_TRAIN = (1, 2048, 128, 128, 192, 128, None)
K3_WIDTH_CASES = ((256, 256, 1), (256, 256, 8), (192, 128, 1))
K3_WIDTH_SWEEP_S = (77, 1000)
# phase 32's rows with one live key (S 1, k_len 1, hd 256): the draws of
# tests/test_torch_flash.py::test_cuda_backward_one_live_key_hd256
K3_ONE_KEY_DRAWS, K3_ONE_KEY_SEED = 256, 11
# phase 33: recurrentgemma-9b's traffic, prompts past its window of 2048 so
# that every ring is full when decode starts (a ring grown past a shorter
# prompt counts its empty slots as keys: ROADMAP queue 3), on SERVE_SLOTS
# slots.  Phase 35's training depths: at about 17 bytes a parameter of
# training state, recurrentgemma's embedding and head alone (2.1 B
# parameters over a vocabulary of 256,000) take 36 GB, and its f32 logits
# 4.2 GB a copy a microbatch; at 2 periods (3.28 B) its peak was 66.66 GiB
# of the H100's 79.18 and it ran out of memory in one of three runs, so 1
# period; deepseek at 2 MLA layers with a dense FFN and the MTP head (3.71
# B) peaked at 63.06 GiB, and at 1 layer its loss did not fall in 8 steps
# in one run, so 2
RG_REQUESTS, RG_PROMPT_LENS, RG_MAX_LEN = 8, (2048, 3072), 4096
RG_TRAIN_PERIODS, DEEPSEEK_TRAIN_LAYERS = 1, 2
# deepseek-v3's reduced config has q/k of 16 + 8 over v of 16, a pair K3's
# CUDA kernels are not built for; phase 35 trains it on the card and the
# CPU at the full config's head widths (q/k 128 + 64 over v 128), every
# other field reduced
DEEPSEEK_CARD_WIDTHS = {"head_dim": 128, "rope_dim": 64}
# bytes left free beside a depth-cut copy (the f32 checks of phases 24-25,
# command-r-plus-104b's depth), and stablelm-12b's training depth: at about
# 17 bytes a parameter (olmo-1b's training peak: 19.93 GiB for 1.18 B) all 40
# layers need about 200 GB, 4 (2.14 B parameters) fit one card
FIT_SPARE = 10e9
STABLELM_TRAIN_LAYERS = 4
# slice 12: whisper-medium's traffic (phase 29): windows of 30 s at 50
# frames a second, decoder prompts, decode steps, and the self cache at
# whisper's published decoder context of 448 tokens; llava's patch-prefixed
# prompt (phase 30); the training depths of phase 31 (at about 17 bytes a
# parameter all 32 of llava's layers need about 120 GB and all 48 of
# qwen3-moe's about 520 GB; 4 and 2 layers fit beside their embeddings)
WHISPER_ITEMS, WHISPER_FRAMES, WHISPER_PROMPTS = 8, 1500, (4, 32)
WHISPER_DECODE, WHISPER_CTX = 64, 448
LLAVA_PROMPT, LLAVA_DECODE = 512, 32
LLAVA_TRAIN_LAYERS, QWEN3_TRAIN_LAYERS = 4, 2
# training traffic of phases 18 and 19: 4 sequences of OLMo-1B's published
# context (2048 tokens) a step
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048
# phase 20: steps of the reduced configs on the card and on the CPU, and
# the relative tolerance of their losses and grad norms (f32 with TF32
# off on both; the CPU tests hold the port to JAX at 2e-4 / 1e-3)
TRAIN_CPU_STEPS, TRAIN_CPU_TOL = 3, (1e-4, 1e-3)
# the backward kernels against their plain versions (see _grad_err)
K3_BWD_TOL, K4_BWD_TOL = 1e-4, 1e-3
K3_BWD_PARITY = (f"dq, dk, dv within the larger of {K3_BWD_TOL} of the "
                 "tensor's largest |entry| and the rounding floor of two f32 "
                 "sums (flash_backward_floor), "
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
# the tiled pair: 5 kb since PR 23 (10 kb took 64 s of the script's time
# limit, 40 s of it on the reference engine)
SV_TILE_LEN, SV_TILE, SV_OVERLAP = 5_000, 256, 64
SV_BANDED_PAIRS, SV_BANDED_LENS, SV_XDROP = 256, (200, 400), 10
# phase T: the autotuner's candidates kept by the cost model, timing
# repeats per candidate, and rounds x launches of each K1 time alone
TUNE_TOP_K, TUNE_ITERS, TUNE_ROUNDS, TUNE_LAUNCHES = 4, 20, 3, 10
# phase X: X-drop pairs per kernel, their lengths, block, budgets and strip
XD_PAIRS, XD_LENS, XD_BLOCK, XD_VALUES, XD_STRIP = 256, (200, 400), 256, \
    (4, 40), 8
XD_HELD = 32
# phase M, the placement path on a mesh of one rank: phase 4's windows
# through the sharded aligner, phase S's first requests through the
# sharded service, olmo-1b's first steps of phase 18 through
# train_loop(mesh=), and their relative tolerance against phase 18's
# losses
MESH_REQUESTS, MESH_STEPS, MESH_LOSS_RTOL = 2048, 3, 2e-6


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


@contextlib.contextmanager
def _k3_dirty_outputs():
    """Within the block, K3's wrapper module allocates through a stand-in
    for ``torch`` whose ``empty`` and ``empty_like`` fill every tensor they
    make with 0xFF bytes (its lse; dq, dk, dv, delta), so a kernel must
    write every byte it returns.  Yields the set of their addresses.  (The
    caching allocator does not promise to hand a freed block of the size
    back, which ``_dirty_allocator`` relies on.)"""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    made = set()

    def dirty(fn):
        def make(*args, **kw):
            t = fn(*args, **kw)
            if t.numel():
                t.view(torch.uint8).fill_(0xFF)
            made.add(t.data_ptr())
            return t
        return staticmethod(make)

    class Stand:
        empty = dirty(torch.empty)
        empty_like = dirty(torch.empty_like)

        def __getattr__(self, name):
            return getattr(torch, name)
    K3.torch = Stand()
    try:
        yield made
    finally:
        K3.torch = torch


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


# ---------------------------------------------------------------------------
# phase 3c: K1 on PEs no hand-written functor instantiates
def _titv_sub(params, q, r):
    """Transition (A<->G, C<->T) scores milder than transversion: the
    quickstart's kernel (examples/quickstart.py), written in torch."""
    import torch
    is_transition = (q // 2 == r // 2) & (q != r)
    return torch.where(q == r, params["match"],
                       torch.where(is_transition, params["transition"],
                                   params["transversion"]))


def _best3(m, d, ins):
    import torch
    from repro_torch.core.kernels_zoo import common as C
    best, ptr = m, torch.full(m.shape, C.P_DIAG, dtype=torch.int32,
                              device=m.device)
    ptr = torch.where(d > best, C.P_UP, ptr)
    best = torch.maximum(best, d)
    ptr = torch.where(ins > best, C.P_LEFT, ptr)
    return torch.maximum(best, ins), ptr


def _ij_pe(params, q, r, diag, up, left, i, j):
    """Linear gaps one dearer on every third row and in odd blocks of 16
    columns: a PE that reads the cell's (i, j)."""
    import torch
    sub = torch.where(q == r, params["match"], params["mismatch"])
    d = up[:, 0] + params["gap"] - (i % 3 == 0).to(torch.int32)
    ins = left[:, 0] + params["gap"] - (j // 16) % 2
    best, ptr = _best3(diag[:, 0] + sub, d, ins)
    return best[:, None], ptr


def _ftab_pe(params, q, r, diag, up, left, i, j):
    """f32 max-plus over a user 4 x 4 substitution table."""
    s = params["S"][q.long().clamp(0, 3), r.long().clamp(0, 3)]
    best, ptr = _best3(diag[:, 0] + s, up[:, 0] + params["gap"],
                       left[:, 0] + params["gap"])
    return best[:, None], ptr


def _ftab_init(params, k):
    import torch
    return (params["gap"] * k.to(torch.float32))[..., None]


def _gen_cases():
    """(label, spec, params, hand-written twin or None) of phase 3c: the
    ti/tv kernel, the (i, j) PE, the float-table PE, #2, #15 and the
    pair-HMM forward at logsumexp with their family set to None, and #1 at
    min-plus, the pair-HMM forward over the whole matrix and #16, which no
    hand-written functor instantiates (K1's min-plus and whole-matrix
    logsumexp paths and a PE with no family)."""
    import dataclasses
    import torch
    from repro_torch import prob
    from repro_torch.core import (DPKernelSpec, REGION_ALL, REGION_CORNER,
                                  STOP_ORIGIN)
    from repro_torch.core import kernels_zoo
    from repro_torch.core.kernels_zoo import common as C
    lin = dict(n_layers=1, init_row=C.linear_gap_init,
               init_col=C.linear_gap_init, region=REGION_CORNER,
               traceback=C.linear_tb(STOP_ORIGIN))
    table = torch.tensor([[2.0, -1.5, -0.5, -1.5], [-1.5, 2.0, -1.5, -0.5],
                          [-0.5, -1.5, 2.0, -1.5], [-1.5, -0.5, -1.5, 2.0]])
    cases = [
        ("ti/tv", DPKernelSpec(name="titv_global", pe=C.linear_pe(_titv_sub),
                               **lin),
         {"match": 2, "transition": -1, "transversion": -4, "gap": -2}, None),
        ("(i, j) PE", DPKernelSpec(name="ij_linear", pe=_ij_pe, **lin),
         {"match": 2, "mismatch": -3, "gap": -2}, None),
        ("float table", DPKernelSpec(
            name="ftab_linear", pe=_ftab_pe, n_layers=1,
            init_row=_ftab_init, init_col=_ftab_init, region=REGION_CORNER,
            score_dtype=torch.float32, traceback=C.linear_tb(STOP_ORIGIN)),
         {"S": table, "gap": -1.25}, None)]
    for kid in (2, 15):
        hand, params = kernels_zoo.make(kid)
        cases.append((f"#{kid} twin", dataclasses.replace(hand, family=None),
                      params, hand))
    hand = prob.cached_pairhmm("logsumexp")
    cases.append(("pair-HMM forward logsumexp twin",
                  dataclasses.replace(hand, family=None),
                  prob.default_params(), hand))
    cases.append(("#1 at min", *kernels_zoo.make(1, objective="min"), None))
    cases.append(("pair-HMM forward over the whole matrix",
                  dataclasses.replace(hand, region=REGION_ALL),
                  prob.default_params(), None))
    cases.append(("#16", *kernels_zoo.make(16), None))
    return cases


def _gen_codes(rng, spec, label, shape):
    import numpy as np
    hi = 20 if label.startswith("#15") else 5 if "pair-HMM" in label else 4
    return rng.integers(0, hi, shape).astype(np.uint8)


def _gen_hold(spec, got, want, what):
    """Integer outputs bit-equal; float best within rtol 1e-5 (max) or 2e-5
    (logsumexp), best_j and pointers exact where best is bit-equal
    (``_hold_ext``).  Returns (largest relative error, pairs whose best is
    bit-equal, pairs)."""
    _, rerr, same, b = _hold_ext(spec, got, want, what)
    return rerr, same, b


def _gen_parity(rng, cases):
    """Each generated functor against the plain version at phase 3's
    buckets, and each twin against its hand-written functor on the same
    inputs, every output on 0xFF blocks."""
    import numpy as np
    import torch
    from repro_torch.kernels.wavefront import kernel as K
    rel, n, equal, total, twins, twin_cases = 0.0, 0, 0, 0, 0, 0
    for label, spec, params, hand in cases:
        for bucket, batch in ((64, 16), (256, 64), (1024, 4)):
            qs = _gen_codes(rng, spec, label, (batch, bucket))
            rs = _gen_codes(rng, spec, label, (batch, bucket))
            ql = rng.integers(bucket // 2, bucket + 1, batch).astype(np.int32)
            rl = rng.integers(bucket // 2, bucket + 1, batch).astype(np.int32)
            ql[0] = bucket
            args = _fill_args(spec, params, qs, rs, ql, rl, DEVICE)
            what = f"{label}, bucket {bucket}, batch {batch}"
            kw = {"tb_pack": 1, "with_tb": spec.traceback is not None}
            want = K.wavefront_fill_plain(spec, params, *args, **kw)
            dirty = _dirty_allocator(*(w for w in want if w is not None))
            got = K.wavefront_fill(spec, params, *args, **kw)
            torch.cuda.synchronize()
            check(got[1].data_ptr() in dirty, "K1's outputs did not land on "
                  "the 0xFF blocks")
            r, s, b = _gen_hold(spec, got, want, what)
            rel, equal, total, n = max(rel, r), equal + s, total + b, n + 1
            if hand is None:
                continue
            ref = K.wavefront_fill(hand, params, *args, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(g, h) for g, h in zip(got, ref)
                       if g is not None)
            if spec.is_sum:
                r, _, _ = _gen_hold(spec, got, ref, f"{what} vs hand-written")
                rel = max(rel, r)
            else:
                check(same, f"K1 generated != hand-written: {what}")
            twins, twin_cases = twins + int(same), twin_cases + 1
    return {"cases": n, "max_rel_err": rel, "best_bit_equal": equal,
            "pairs": total, "twins_bit_equal": twins,
            "twin_cases": twin_cases}


def _gen_engine(rng, spec, params):
    """The ti/tv kernel through ``run_pairs`` on the ``wavefront`` engine:
    2048 windows of 200-256 bases of a random reference, 8 % mutated,
    block 1024; the plan's first dispatch builds its functor (cold
    compile_s), a cleared plan cache reloads it (warm), a second parameter
    set reuses it; results equal the card's reference engine on every pair
    and the CPU path on the first 64."""
    import torch
    from repro_torch.core import alphabets
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.runtime import dispatch
    from repro_torch.runtime import plan as plan_mod
    genome = alphabets.random_dna(rng, 200_000)
    pairs = _read_pairs(rng, genome, GEN_PAIRS, 200, 256, 0.08, 256)

    def compile_s():
        return [p["compile_s"] for p in plan_mod.plan_cache_info()["plans"]
                if p["key"].kernel == spec.name and p["key"].engine ==
                "wavefront"]
    before = K.launches
    t0 = time.perf_counter()
    got = dispatch.run_pairs(spec, params, pairs, block=GEN_BLOCK)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    launches = K.launches - before
    cold = compile_s()
    check(launches == -(-GEN_PAIRS // GEN_BLOCK) and cold,
          f"run_pairs on the ti/tv kernel launched K1 {launches} times")
    plan_mod.clear_plan_cache(keep_stats=True)
    t0 = time.perf_counter()
    again = dispatch.run_pairs(spec, params, pairs, block=GEN_BLOCK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    warm = compile_s()
    _compare_results(again, got, "ti/tv run_pairs, warm")
    want = dispatch.run_pairs(spec, params, pairs[:64], block=64,
                              device="cpu")
    _compare_results(got[:64], want, "ti/tv run_pairs")
    t0 = time.perf_counter()
    ref = dispatch.run_pairs(spec, params, pairs, block=GEN_BLOCK,
                             engine_name="reference")
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    _compare_results(got, ref, "ti/tv run_pairs on the reference engine")
    libs = set(K._GEN_LIBS)
    other = dict(params, transversion=-5, gap=-3)
    got2 = dispatch.run_pairs(spec, other, pairs[:GEN_BLOCK],
                              block=GEN_BLOCK)
    check(set(K._GEN_LIBS) == libs, "a second parameter set of the ti/tv "
          "kernel built another functor")
    want2 = dispatch.run_pairs(spec, other, pairs[:16], block=16,
                               device="cpu")
    _compare_results(got2[:16], want2, "ti/tv run_pairs, second parameters")
    check(any(int(a.score) != int(b.score) for a, b in zip(got2, got)),
          "the second parameter set scored as the first")
    return {"pairs": GEN_PAIRS, "launches": launches,
            "cold_wall_s": cold_wall, "wall_s": wall,
            "pairs_per_s": GEN_PAIRS / wall, "reference_wall_s": ref_wall,
            "cold_compile_s": cold[0], "warm_compile_s": warm[0]}


def _gen_timing(rng, cases, card):
    """#2's hand-written and generated functors in turns (hand, generated,
    generated, hand) and the ti/tv kernel at batch 1024, 256x256, tb_pack 2,
    on windows of 240-256 bases (the shape of phase 6's timed block), by
    kernel_device_ms, beside the plain version and the bound."""
    import torch
    from repro_torch.core import alphabets
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.tune.cost import MEM_BYTES_PER_S, k1_bytes, pe_ops
    by = {label: (spec, params, hand) for label, spec, params, hand in cases}
    genome = alphabets.random_dna(rng, 200_000)
    pairs = _read_pairs(rng, genome, 1024, 240, 256, 0.08, 256)
    block = _blocks(pairs, 1024)[0]
    (bq, br), qs, rs, ql, rl = block
    cells = _live_in_band(ql, rl, None)
    runs = {"#2 hand-written": (by["#2 twin"][2], by["#2 twin"][1]),
            "#2 generated": by["#2 twin"][:2],
            "ti/tv generated": by["ti/tv"][:2]}
    args = {k: _fill_args(s, p, qs, rs, ql, rl, DEVICE)
            for k, (s, p) in runs.items()}
    before = K.launches
    times = {k: [] for k in runs}
    for k in ("#2 hand-written", "#2 generated", "#2 generated",
              "#2 hand-written", "ti/tv generated"):
        s, p = runs[k]
        dev, _, _, _ = kernel_device_ms(
            lambda: K.wavefront_fill(s, p, *args[k], tb_pack=2), "wavefront")
        times[k] += dev
    K.launches = before
    s, p = runs["ti/tv generated"]
    plain = []
    plain_ms = cuda_time_ms(lambda: plain.append(K.wavefront_fill_plain(
        s, p, *args["ti/tv generated"], tb_pack=2)), 1)
    out = {}
    for k, ts in times.items():
        s, p = runs[k]
        ops_ms = pe_ops(s, p) * cells / card["int32_ops_per_s"] * 1e3
        bytes_ms = k1_bytes(s, 1024, bq, br, 2) / MEM_BYTES_PER_S * 1e3
        ms = statistics.median(ts)
        out[k] = {"ms": ms, "ms_range": [min(ts), max(ts)],
                  "bound_ms": max(ops_ms, bytes_ms),
                  "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                  "pe_ops": pe_ops(s, p)}
        print(f"    K1 {k} at batch 1024, {bq}x{br}, tb_pack 2: device "
              f"{_spread(ts)}; bound {out[k]['bound_ms']:.4f} ms by "
              f"{out[k]['bound_by']} ({out[k]['pe_ops']} operations a cell, "
              f"{cells} live cells); {100 * out[k]['bound_ms'] / ms:.1f} % "
              f"of the bound", flush=True)
    out["ti/tv generated"]["plain_ms"] = plain_ms
    out["generated_over_hand"] = (out["#2 generated"]["ms"]
                                  / out["#2 hand-written"]["ms"])
    print(f"    #2 generated / hand-written: {out['generated_over_hand']:.4f};"
          f" ti/tv plain version {plain_ms:.1f} ms", flush=True)
    return out


def _k1_hand_ptxas():
    """Registers and spill bytes of the hand-written instantiations from the
    kept ptxas reports, against K1_HAND_PTXAS."""
    from repro_torch.kernels import build
    from repro_torch.kernels.wavefront import kernel as K
    out = {}
    for name, src in (("K1", K.SOURCE), ("K1 ext", K.SOURCE_EXT)):
        log = build.kept_report(src)
        check(log is not None, f"no ptxas report kept for {src.name}")
        rows = ptxas_table(log)
        out[name] = {"instantiations": len(rows),
                     "registers": [min(r[1] for r in rows),
                                   max(r[1] for r in rows)],
                     "spill_bytes": sum(r[2] for r in rows)}
        if name == "K1 ext":
            out[name]["entries"] = {r[0]: [r[1], r[2]] for r in rows}
    want, got = K1_HAND_PTXAS, out["K1 ext"]["entries"]
    diff = [f"K1 {what} {have} where {exp} was expected"
            for what, have, exp in (
                ("instantiations", out["K1"]["instantiations"], want["K1"][0]),
                ("registers", out["K1"]["registers"], list(want["K1"][1:3])),
                ("spill bytes", out["K1"]["spill_bytes"], want["K1"][3]))
            if have != exp]
    diff += [f"{e}: {got.get(e)} where {list(v)} was expected"
             for e, v in want["K1 ext"].items() if got.get(e) != list(v)]
    diff += [f"{e}: not expected" for e in got if e not in want["K1 ext"]]
    check(not diff, "the hand-written K1 instantiations' ptxas lines "
          "changed: " + "; ".join(diff))
    out["unchanged"] = True
    return out


def phase_generated(card):
    """3c: K1 on PEs no hand-written functor instantiates (see
    ``_gen_cases``), each functor generated from the spec's torch PE by
    ``kernels/wavefront/synth.py``: one nvcc per functor, all at once (the
    ti/tv kernel's inside its plan's first dispatch, as a user meets it);
    each against the plain version and each twin against its hand-written
    functor; the ti/tv kernel through ``run_pairs``; #2's two functors and
    the ti/tv kernel timed.  Its own generator, so the phases after it see
    the data they always saw."""
    import numpy as np
    from repro_torch.kernels.wavefront import kernel as K
    from repro_torch.kernels.wavefront import synth
    t0 = time.perf_counter()
    rng = np.random.default_rng(GEN_SEED)
    cases = _gen_cases()
    syns = {label: synth.lower(spec, params)
            for label, spec, params, _ in cases}
    titv = cases[0]
    with ThreadPoolExecutor(len(cases) - 1) as pool:
        futs = {label: pool.submit(K.generated_lib, syn)
                for label, syn in syns.items() if label != "ti/tv"}
        engine = _gen_engine(rng, titv[1], titv[2])
        built = {label: f.result()[1] for label, f in futs.items()}
    built["ti/tv"] = K.generated_lib(syns["ti/tv"])[1]
    build_wall = time.perf_counter() - t0
    for label, b in built.items():
        rows, syn = ptxas_table(b.ptxas_log), syns[label]
        check(len(rows) == 1, f"{label}: {len(rows)} kernels in its unit")
        ij = ", reads (i, j)" if syn.uses_ij else ""
        print(f"    generated {label} ({syn.ops} operations a cell, UP "
              f"0x{syn.up_mask:x}, DIAG 0x{syn.diag_mask:x}{ij}): built "
              f"{b.path.name} in {b.seconds:.1f} s, {rows[0][1]} registers, "
              f"{rows[0][2]} spill bytes", flush=True)
    parity = _gen_parity(rng, cases)
    timing = _gen_timing(rng, cases, card)
    hand = _k1_hand_ptxas()
    total = time.perf_counter() - t0
    over = "" if total < GEN_PHASE_S else " (over its budget)"
    print(f"[3c] K1 generated from {len(cases)} PEs: builds "
          f"{max(b.seconds for b in built.values()):.1f} s the longest, "
          f"{build_wall:.1f} s wall with the ti/tv run_pairs beside them; "
          f"{parity['cases']} (PE, bucket) cases == plain (integers "
          f"bit-equal, float best within rtol 1e-5 / 2e-5, largest "
          f"relative error {parity['max_rel_err']:.3g}, best bit-equal on "
          f"{parity['best_bit_equal']} of {parity['pairs']} pairs), the "
          f"twins == their hand-written functors on "
          f"{parity['twins_bit_equal']} of {parity['twin_cases']} cases "
          f"bit for bit; ti/tv "
          f"run_pairs: {engine['launches']} K1 launches, "
          f"{engine['pairs_per_s']:.0f} pairs/s warm ({engine['wall_s']:.3f}"
          f" s) against {engine['reference_wall_s']:.3f} s on the reference "
          f"engine, compile_s cold {engine['cold_compile_s']:.2f} s, warm "
          f"{engine['warm_compile_s']:.4f} s, a second parameter set built "
          f"nothing; hand-written ptxas unchanged "
          f"({hand['K1']['instantiations']} + "
          f"{hand['K1 ext']['instantiations']} instantiations); phase "
          f"{total:.1f} s{over}",
          flush=True)
    return {"functors": {label: {
        "ops": syns[label].ops, "registers":
            ptxas_table(b.ptxas_log)[0][1],
        "spill_bytes": ptxas_table(b.ptxas_log)[0][2],
        "build_s": b.seconds} for label, b in built.items()},
        "build_wall_s": build_wall, "parity": parity, "engine": engine,
        "timing": timing, "hand_ptxas": hand, "phase_s": total}


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
    lint_points, _ = analyze.enumerate_points()
    report = analyze.lint_all(points=lint_points)
    ptxas = sorted({f.message for f in report.findings
                    if f.rule == "R401" and "registers" in f.message})
    r3 = {r: sum(f.rule == r for f in report.findings)
          for r in ("R301", "R302", "R303")}
    print(f"    lint_all on the card: {report.points} plan points, "
          f"{len(report.errors)} errors, "
          f"{len(report.by_severity(analyze.WARNING))} warnings; R3xx "
          f"findings {r3}; {'; '.join(ptxas)}", flush=True)
    check(report.ok, "phase T: lint_all found errors:\n"
          + report.format_text())
    sites = _host_read_sites(lint_points, report)
    print(f"    phase T: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"points": out, "launches": launches,
            "lint": {"points": report.points,
                     "warnings": len(report.by_severity(analyze.WARNING)),
                     "r3": r3, "host_read_sites": sites}}


def _host_read_sites(points, report):
    """R303's host reads on the card: each linted point's plan run once
    on the card under ``hlo_cost.HostReads`` (K1 and K2 launched), its
    sites against the ones R303 found on the CPU (``report``).  A site
    seen on one side only fails the phase; returns the sites."""
    from repro_torch.analyze import PointContext
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.launch import hlo_cost
    from repro_torch.runtime import registry
    t0 = time.perf_counter()
    cpu = {}
    for f in report.findings:
        if f.rule == "R303" and "host read at " in f.message:
            site = f.message.split("host read at ", 1)[1].split(": ", 1)[0]
            cpu.setdefault(f.where, set()).add(site)
    before = (K1.launches, K2.launches)
    K1.launches = K2.launches = 0
    card, reads = {}, 0
    for p in points:
        ctx = PointContext(p, DEVICE)
        declared = registry.engine_options(p.engine)
        opts = {k: v for k, v in ctx.options.items()
                if k in declared and declared[k] != "dynamic"}
        got = hlo_cost.host_reads(p.spec, p.params, p.engine, p.q_shape,
                                  p.r_shape, batch_size=p.batch_size,
                                  with_traceback=p.with_traceback,
                                  device=DEVICE, **opts)
        reads += len(got)
        if got:
            card[p.label] = {r.site for r in got}
    launched = (K1.launches, K2.launches)
    K1.launches, K2.launches = before
    differ = {label: (sorted(cpu.get(label, ())), sorted(card.get(label, ())))
              for label in set(cpu) | set(card)
              if cpu.get(label) != card.get(label)}
    every = sorted(set().union(*card.values())) if card else []
    print(f"    host reads on the card: {len(points)} plans run under "
          f"HostReads ({launched[0]} K1 and {launched[1]} K2 launches), "
          f"{reads} reads at {len(every)} sites {every}; on "
          f"{len(card)} points, each point's sites "
          f"{'equal to' if not differ else 'NOT equal to'} R303's on the "
          f"CPU; {time.perf_counter() - t0:.1f} s", flush=True)
    for label, (c, g) in sorted(differ.items()):
        print(f"    sites differ at {label}: CPU {c}, card {g}", flush=True)
    check(not differ, f"phase T: host-read sites on the card differ from "
          f"R303's on the CPU at {len(differ)} points")
    check(launched[0] > 0 and launched[1] > 0,
          "phase T: the card's host-read run launched no K1 or no K2")
    return every


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
    ops = (K2.OPS_PER_WORD_COLUMN * word_cols
           + K2.OPS_PER_HANDOFF * (word_cols - n_cols)
           + K2.OPS_PER_COLUMN * n_cols)
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

    # E: one worker against two on the warm run's first SV_WARM requests
    # (the whole stream until PR 23: 96 s of the script's time limit),
    # warm-started over the same grid, in turns (1, 2, 2, 1) in one process
    # state
    turns = {1: [], 2: []}
    for w in (1, 2, 2, 1):
        res, asvc, astats, _, alat = _sv_run(stream[:SV_WARM], n_workers=w,
                                             warm_start=grid)
        check(res == clean[:SV_WARM], f"service with {w} workers: results "
              f"differ from the clean run")
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
    print(f"    workers, warm-started, the first {SV_WARM} requests, in "
          f"turns 1, 2, 2, 1: "
          + "; ".join(
              f"{w} worker{'s' * (w > 1)} "
              + ", ".join(f"{t['wall_s']:.3f} s ({SV_WARM / t['wall_s']:.0f} "
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
                str(w): [SV_WARM / t["wall_s"] for t in turns[w]]
                for w in (1, 2)},
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


def _serve_requests(cfg, n=SERVE_REQUESTS, lens=PROMPT_LENS):
    """``n`` random prompts, lengths uniform in ``lens``, from numpy seed
    SEED."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lens[0], lens[1] + 1, n)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(lens)]


def _serve(cfg, params, reqs=None, max_len=SERVE_MAX_LEN):
    """Warm up, then serve the phase's traffic (``reqs``, by default
    ``_serve_requests(cfg)``, on SERVE_SLOTS slots of ``max_len``) with every
    launch count at 0; returns the finished requests, the session, its wall
    time, the peak device memory and the launch counts of K1-K4 over the
    run."""
    import torch
    from repro_torch.serve import Request, ServeSession
    warm = ServeSession(cfg, params, batch_slots=1, max_len=64,
                        device=DEVICE)
    warm.run([Request(rid=-1, prompt=_serve_requests(cfg)[0].prompt[:32],
                      max_new=2)])
    del warm
    sess = ServeSession(cfg, params, batch_slots=SERVE_SLOTS,
                        max_len=max_len, device=DEVICE)
    reqs = reqs or _serve_requests(cfg)
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
          f"on {SERVE_SLOTS} slots x {max_len}: {wall:.3f} s wall; "
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
    zeroes every leaf of layer 0's mixer cache (the attention keys and
    values, the WKV state and shift, MLA's latent, the RG-LRU's state and
    conv history) before the decode step."""
    import torch
    from repro_torch.models import lm
    Lp = toks.shape[1]
    logits_p, cache, k_len = lm.prefill(cfg, params, {"tokens": toks})
    if nxt is None:
        nxt = torch.argmax(logits_p, -1)
    cache = lm.grow_cache(cfg, cache, 1, Lp + 1)
    if spoil:
        for leaf in cache[0]["sub0"]["mixer"].values():
            leaf[0].zero_()
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
    return _serve_k3("olmo-1b", 12)


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


def _in_turns(a, b=None, rounds=ROUNDS, launches=ROUND_LAUNCHES):
    """Per-launch ms of ``a`` and ``b`` over ``rounds`` rounds of
    ``launches`` launches each (CUDA events), in turns a, b, b, a, after
    a warm-up; two samples of each per round."""
    ta, tb = [], []
    for fn in (a, b):
        for _ in range(3 if fn else 0):
            fn()
    for _ in range(rounds):
        ta.append(cuda_time_ms(a, launches))
        if b:
            tb += [cuda_time_ms(b, launches) for _ in range(2)]
        ta.append(cuda_time_ms(a, launches))
    return ta, tb


def _spread(ts, launches=ROUND_LAUNCHES):
    return f"median {statistics.median(ts):.4f} ms ({min(ts):.4f}-" \
           f"{max(ts):.4f} over {len(ts)} rounds of {launches})"


def phase_timing_k3_k4():
    """K3 and K4 alone at the serving path's largest shapes, CUDA events
    over rounds of launches (K3 in turns with
    scaled_dot_product_attention, a yardstick the port never calls),
    beside the plain versions and the bounds on this card."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.wkv6 import kernel as K4
    from repro_torch.tune.cost import MEM_BYTES_PER_S
    before = (K3.launches, K4.launches)
    print(f"[15] K3 and K4 timed alone ({nvidia_smi('name,power.limit')})",
          flush=True)
    B, S, H, hd = K3_TIMED
    k3 = _k3_fwd_timing(B, S, S, H, H, hd, True, "olmo-1b serving")

    B, S, H, hd = K4_TIMED
    args = (*(torch.randn((B, S, H, hd), device=DEVICE, dtype=torch.bfloat16)
              for _ in range(3)),
            -torch.rand((B, S, H, hd), device=DEVICE),
            torch.randn((H, hd), device=DEVICE))
    t4 = _in_turns(lambda: K4.wkv6_fill(*args))[0]
    ms4 = statistics.median(t4)
    K4.wkv6_plain(*args)
    plain4 = cuda_time_ms(lambda: K4.wkv6_plain(*args), 3)
    ops = K4.k4_ops_per_step(hd) * S * B * H
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
          f"{K4.k4_ops_per_step(hd)} f32 operations = "
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
def _grad_err(got, want, tol, floor=None):
    """(max |got - want|, whether every entry lies within the larger of
    ``tol`` of the tensor's largest |entry| and ``floor`` at that entry
    (``K3.flash_backward_floor``: the rounding noise two f32
    implementations of K3's backward may differ by, all that a gradient
    which cancels to 0 holds, as dq and dk of a row with a single live key
    do), plus ``tol`` relative, and in bf16 plus one bf16 ulp of the
    output)."""
    import torch
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not diff.numel():
        return 0.0, True
    bound = tol * float(want.abs().max()) + tol * want.abs()
    if floor is not None:
        bound = torch.maximum(bound, floor + tol * want.abs())
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
    floors = K3.flash_backward_floor(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w, f in zip(("dq", "dk", "dv"), got, want, floors):
        e, ok = _grad_err(g, w, K3_BWD_TOL, f)
        check(ok, f"K3 backward != plain: {name}, {what} (max |diff| {e})")
        err = max(err, e)
    return err


def _k3_bwd_case(rng, q, k, v, mask, what):
    """K3's forward lse and backward kernel against the plain versions on
    one input, lse, dq, dk and dv allocated on blocks left filled with 0xFF,
    a second backward call bit-equal; returns the largest |difference| of
    the gradients and of lse."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    dtype = q.dtype
    with _k3_dirty_outputs() as dirty:
        out, lse = K3.flash_fill(q, k, v, p_dtype=dtype, return_lse=True,
                                 **mask)
    torch.cuda.synchronize()
    check(lse.data_ptr() in dirty, "K3's lse was not made on a 0xFF block")
    _, want_lse = K3.flash_attention_plain(q, k, v, return_lse=True, **mask)
    lse_err = float((lse - want_lse).abs().max())
    check(torch.allclose(lse, want_lse, rtol=2e-5, atol=2e-5),
          f"K3 lse != plain: {what} (max |diff| {lse_err})")
    do = torch.as_tensor(rng.normal(size=out.shape), dtype=dtype,
                         device=DEVICE)
    with _k3_dirty_outputs() as dirty:
        got = K3.flash_backward(q, k, v, out, lse, do, **mask)
    torch.cuda.synchronize()
    check(all(g.data_ptr() in dirty for g in got),
          "K3's dq, dk, dv were not made on 0xFF blocks")
    again = K3.flash_backward(q, k, v, out, lse, do, **mask)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"K3 backward: a second call differs, {what}")
    del got, again
    return _hold_k3_bwd((q, k, v, out, lse, do), mask, what), lse_err


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
            err, lse_err = _k3_bwd_case(
                rng, q, k, v, mask, f"causal {causal}, window {window}, G "
                f"{G}, S {S}, {dtype}, hd {hd}")
            max_err = max(max_err, err)
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
    """Host seconds of one batch of the training traffic (train_loop's
    stream, frontend prefix included)."""
    from repro_torch.launch.train import batches
    it = batches(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED)
    t0 = time.perf_counter()
    next(it)
    return time.perf_counter() - t0


def _train_full(arch, mod, bwd_name, n_fwd, n_bwd, phase, cfg=None,
                keep_first=False, count=False):
    """``train_loop(device="cuda")`` on ``arch`` at full width (``cfg``: a
    depth cut of it): TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens
    from LMBatcher(seed=SEED), AdamWConfig(weight_decay=0.01) under
    cosine_with_warmup(3e-4, 5, TRAIN_STEPS) (train_loop's own choices),
    every launch count at 0 just before.  Checks finite losses and grad
    norms, a falling loss and the launches of ``mod`` per step; returns the
    run's numbers and the last backward call's arguments (layer 0 of the
    last step), and with ``keep_first`` the first step's (layer 0); with
    ``count`` also hlo_cost's count of one more step (phase D), taken
    after the timed steps and the profile."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train_loop
    from repro_torch.models.params import count_params
    full = configs.get(arch)
    cfg = cfg or full
    n = count_params(cfg)
    cut = "" if cfg.n_layers == full.n_layers else \
        f"; depth cut to {cfg.n_layers} of {full.n_layers} layers"
    what = {"vlm": " positions (patches, then tokens)",
            "audio": " tokens beside as many frames"}.get(cfg.frontend,
                                                         " tokens")
    print(f"[{phase}] {arch} trains at full width ({n:,} parameters, "
          f"{cfg.param_dtype}, remat {cfg.remat}{cut}): {TRAIN_STEPS} AdamW "
          f"steps of {TRAIN_BATCH} x {TRAIN_SEQ}{what} through train_loop",
          flush=True)
    batch_s = _lm_batch_s(cfg)
    mods = _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, counts, losses, gns = [time.perf_counter()], [], [], []
    auxs = []

    slot, first = {}, {}

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        gns.append(float(metrics["grad_norm"]))
        if "moe_aux" in metrics:
            auxs.append(float(metrics["moe_aux"]))
        stamps.append(time.perf_counter())
        counts.append((mod.launches, mod.bwd_launches))
        if keep_first and not first:
            first.update(slot)

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
    check(len(auxs) == (TRAIN_STEPS if cfg.n_experts else 0)
          and all(np.isfinite(auxs)), f"{arch}: moe_aux logged {auxs}")
    per_step = [(b[0] - a[0], b[1] - a[1])
                for a, b in zip([(0, 0)] + counts, counts)]
    check(all(c == (n_fwd, n_bwd) for c in per_step),
          f"{arch}: launches per step {per_step}, want ({n_fwd}, {n_bwd})")
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = statistics.median(steps[1:])
    prof = _profile_train_step(cfg, state)
    cost = _count_train_step(cfg, state) if count else None
    del state
    torch.cuda.empty_cache()
    print(f"    losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{', '.join(f'{x:.3f}' for x in gns)}"
          + (f"; moe_aux {', '.join(f'{x:.4f}' for x in auxs)}" if auxs
             else ""), flush=True)
    print(f"    step time median {step_s:.3f} s over steps 2-{TRAIN_STEPS} "
          f"({min(steps[1:]):.3f}-{max(steps[1:]):.3f}; step 1 "
          f"{steps[0]:.3f} s with the state's set-up), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s, including one "
          f"LMBatcher batch on the host ({batch_s:.3f} s alone); peak "
          f"device memory {peak / 2**30:.2f} GiB; launches per step "
          f"{per_step[0]} (forward under remat, backward)", flush=True)
    run = {"losses": losses, "grad_norms": gns, "step_s": step_s,
           "profile_busy": prof and prof["device_ms"] / prof["wall_ms"],
           "steps_s": steps, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
           / step_s, "peak_bytes": peak, "batch_s": batch_s,
           "fwd_launches": counts[-1][0], "bwd_launches": counts[-1][1],
           "moe_aux": auxs, "last": slot, "cost": cost}
    return dict(run, first=first) if keep_first else run


def _extra_step(cfg):
    """A train step of train_loop's AdamW and one batch of its traffic,
    for steps taken after a run's timed ones."""
    import torch
    from repro_torch.launch.train import batches
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, AdamWConfig(weight_decay=0.01),
                           constant(1e-4))
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             next(batches(cfg, TRAIN_BATCH, TRAIN_SEQ, SEED)).items()}
    return step, batch


def _profile_train_step(cfg, state):
    """torch.profiler over one more step of the trained state (after the
    run's counts are read): device busy share and the top kernels."""
    step, batch = _extra_step(cfg)
    return _device_profile(lambda: step(state, batch),
                           f"one {cfg.name} training step")


def _count_train_step(cfg, state):
    """launch/hlo_cost.py's count of one more step of the trained state,
    on the card (after the run's timed steps and its profile)."""
    from repro_torch.launch import hlo_cost
    step, batch = _extra_step(cfg)
    return hlo_cost.count(step, state, batch)


def phase_train_olmo():
    """olmo-1b at full width trains through train_loop on K3; layer 0's
    recorded backward is held against flash_backward_plain; K3's forward
    and backward share of a step."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    run = _train_full("olmo-1b", K3, "flash_backward", 2 * 16, 16, 18,
                      count=True)
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
    run = _train_full("rwkv6-3b", K4, "wkv6_backward", 2 * 32, 32, 19,
                      count=True)
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


def phase_train_card_vs_cpu(archs=("olmo-1b", "rwkv6-3b"), phase=20):
    """The reduced configs in f32 (TF32 off) train on the card and on the
    CPU from one numpy-made state: TRAIN_CPU_STEPS steps of make_train_step
    on the same batches of train_loop's stream (frontend prefix included),
    every loss and grad norm within TRAIN_CPU_TOL; then a checkpoint saved
    on the card after step 2 and restored by restore_latest gives a step-3
    loss bit-equal to the unbroken run's.  An entry of ``archs`` may be
    (name, changes): the reduced config with those fields replaced."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import checkpoint, configs
    from repro_torch import train as train_mod
    from repro_torch.launch.train import batches as stream
    from repro_torch.optim import AdamWConfig, constant
    t0 = time.perf_counter()
    ckdir = ROOT / "build" / "smoke_ckpt"
    out = []
    for arch in archs:
        arch, changes = (arch, {}) if isinstance(arch, str) else arch
        cfg = dataclasses.replace(configs.get(arch, reduced=True), **changes)
        opt = AdamWConfig(weight_decay=0.01)
        tree = _numpy_state(cfg, SEED)
        it = stream(cfg, 4, 64, SEED)
        batches = [next(it) for _ in range(TRAIN_CPU_STEPS)]
        step = train_mod.make_train_step(cfg, opt, constant(1e-3))
        runs = {}
        shutil.rmtree(ckdir, ignore_errors=True)
        for dev in (DEVICE, "cpu"):
            state = train_mod.state_from_jax(cfg, opt, tree, dev)
            rec = []
            for i, b in enumerate(batches):
                state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                        for k, v in b.items()})
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
        restored, m = step(restored, {k: torch.as_tensor(v, device=DEVICE)
                                      for k, v in batches[2].items()})
        resumed = (float(m["loss"]), float(m["grad_norm"]))
        check(resumed[0] == card[2][0], f"{arch}: the step-3 loss after "
              f"restore_latest is {resumed[0]!r}, the unbroken run's "
              f"{card[2][0]!r}")
        shutil.rmtree(ckdir, ignore_errors=True)
        rel = max(abs(c[0] - p[0]) / abs(p[0]) for c, p in zip(card, cpu))
        relg = max(abs(c[1] - p[1]) / abs(p[1]) for c, p in zip(card, cpu))
        at = f" (at {changes})" if changes else ""
        out.append(f"{arch}{at}: losses "
                   f"{', '.join(f'{c[0]:.6f}' for c in card)}"
                   f" (largest relative difference from the CPU {rel:.2g}, "
                   f"grad norms {relg:.2g}); resumed step 3 loss bit-equal "
                   f"{resumed[0]!r}, grad norm "
                   f"{'bit-equal' if resumed[1] == card[2][1] else 'differs'}"
                   f" ({resumed[1]!r} / {card[2][1]!r})")
    print(f"[{phase}] card == CPU training on the reduced configs in f32 "
          f"({TRAIN_CPU_STEPS} steps of 4 x 64 positions from one numpy-made "
          f"state; loss within {TRAIN_CPU_TOL[0]}, grad norm within "
          f"{TRAIN_CPU_TOL[1]} relative): " + "; ".join(out)
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)


def entry_ptxas():
    """{kernel line name: [{entry, registers, spill_bytes, stack_bytes}]}
    for every entry function of K3's forward and of the two backward
    sources, from the ``-Xptxas -v`` reports their builds kept; printed."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.kernels.wkv6 import kernel as K4
    out = {}
    for key, src in (("flash_fill", K3.SOURCE),
                     ("flash_backward", K3.SOURCE_BWD),
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


def _k3_bwd_bound(B, Sq, Sk, H, Kh, hd, causal, card_flops, hd_v=None,
                  window=None):
    """Least time of K3's backward, q (B, Sq, H, hd) over k (B, Sk, Kh, hd)
    and v (B, Sk, Kh, hd_v, by default hd), bf16 inputs, causal with
    q_start = Sk - Sq, under ``window``: 6 hd + 4 hd_v FLOP per live
    (query, key) pair (s, dk, dq over hd; dp, dv over hd_v; 10 hd at equal
    widths) at ``card_flops``, or q, k, v, O, dO and lse read once and dq,
    dk, dv written once at the card's memory rate."""
    from repro_torch.kernels.flash_attn.kernel import k3_pairs
    from repro_torch.tune.cost import MEM_BYTES_PER_S
    hd_v = hd_v or hd
    pairs = k3_pairs(Sq, causal, window, None, Sk, Sk - Sq if causal else 0)
    flops = pairs * (6 * hd + 4 * hd_v) * B * H
    nbytes = 2 * (2 * B * Sq * H * (hd + hd_v) +
                  2 * B * Sk * Kh * (hd + hd_v)) + 4 * B * Sq * H
    ops_ms, bytes_ms = flops / card_flops * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes)


def timing_backward():
    """Phase 15's training timings: K3 forward + backward at K3_TRAIN bf16
    causal through autograd, in turns with scaled_dot_product_attention's
    forward + backward (a yardstick the port never calls); K3's backward
    alone (``_k3_bwd_timing``); K4's backward at K4_TRAIN alone; each
    beside its plain version and its bound on this card."""
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
    smi = nvidia_smi("name,power.limit")
    print(f"     ({smi}) K3 forward + backward through autograd at "
          f"{K3_TRAIN}, bf16, "
          f"causal, in turns with scaled_dot_product_attention's: K3 "
          f"{_spread(tfb)}; SDPA {_spread(tlib)}; K3 / SDPA "
          f"{statistics.median(tfb) / statistics.median(tlib):.2f}x "
          f"(medians)", flush=True)
    del ql, kl, vl, qt, kt, vt
    k3b = dict(_k3_bwd_timing(B, S, S, H, H, hd, True, "olmo-1b training"),
               fwd_bwd_ms=statistics.median(tfb),
               fwd_bwd_ms_range=[min(tfb), max(tfb)],
               library_fwd_bwd_ms=statistics.median(tlib),
               library_fwd_bwd_ms_range=[min(tlib), max(tlib)])

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
    ops = K4.k4_bwd_ops_per_chunk(hd) * nc * B * H
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
          f"by {k4b['bound_by']} ({K4.k4_bwd_ops_per_chunk(hd)} f32 "
          f"operations "
          f"a (chunk, head), counted from csrc/wkv6_bwd.cu, x {nc * B * H} = "
          f"{ops / 1e9:.3f} G at 67 TFLOP/s = {ops_ms:.4f} ms; {nbytes4} B "
          f"of r/k/v/lw/dy/u in, dr/dk/dv/dlw/du out = {bytes_ms:.4f} ms); "
          f"{ops / ms4 / 1e9:.1f} G f32 operations/s", flush=True)
    K3.launches, K3.bwd_launches, K4.launches, K4.bwd_launches = before
    return k3b, k4b


# ---------------------------------------------------------------------------
# Slice 11: K3 at hd 160 and at cross lengths; stablelm-12b, phi3-medium-14b
# and command-r-plus-104b at full width; the alignment launcher
# ---------------------------------------------------------------------------
def _k3_inputs(rng, B, Sq, Sk, H, Kh, hd, dtype, exact=False, hd_v=None):
    """q (B, Sq, H, hd), k (B, Sk, Kh, hd) and v (B, Sk, Kh, hd_v, by
    default hd) from ``rng`` on the card; ``exact``: integer q and k (exact
    scores)."""
    import numpy as np
    import torch
    q = rng.normal(size=(B, Sq, H, hd))
    k = rng.normal(size=(B, Sk, Kh, hd))
    v = rng.normal(size=(B, Sk, Kh, hd_v or hd))
    if exact:
        q, k = (np.round(t * 1.5).clip(-3, 3) for t in (q, k))
    return tuple(torch.as_tensor(t, dtype=dtype, device=DEVICE)
                 for t in (q, k, v))


def phase_k3_hd160(rng):
    """K3's forward and backward against their plain versions at head width
    160 (stablelm-12b): causal, causal with window 64, non-causal, and
    non-causal with a k_len mask; G 1 and 4; S in K3_SWEEP_S; forward f32,
    bf16 on exact and on normal scores (K3_PARITY), backward f32 and bf16
    (K3_BWD_PARITY, lse within 2e-5, 0xFF blocks, a second call
    bit-equal)."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    t0 = time.perf_counter()
    before = (K3.launches, K3.bwd_launches)
    fwd_err, share, bwd_err, lse_err, nf, nb = 0.0, 0.0, 0.0, 0.0, 0, 0
    kinds = ((torch.float32, False), (torch.bfloat16, True),
             (torch.bfloat16, False))
    for (causal, window, kl), G, S in itertools.product(
            ((True, None, None), (True, 64, None), (False, None, None),
             (False, None, "half")), (1, 4), K3_SWEEP_S):
        mask = dict(causal=causal, window=window,
                    k_len=None if kl is None else S // 2 + 1)
        for dtype, exact in kinds:
            q, k, v = _k3_inputs(rng, 2, S, S, 8, 8 // G, 160, dtype, exact)
            what = (f"hd 160, {mask}, G {G}, S {S}, {dtype}, "
                    f"{'exact' if exact else 'normal'} scores")
            err, sh, _ = _k3_hold(q, k, v, what, exact, **mask)
            fwd_err, share, nf = max(fwd_err, err), max(share, sh), nf + 1
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _k3_inputs(rng, 2, S, S, 8, 8 // G, 160, dtype)
            err, le = _k3_bwd_case(rng, q, k, v, mask, f"hd 160, {mask}, G "
                                   f"{G}, S {S}, {dtype}")
            bwd_err, lse_err, nb = max(bwd_err, err), max(lse_err, le), nb + 1
    K3.launches, K3.bwd_launches = before
    print(f"[21] K3 at hd 160 == plain: forward on {nf} cases ({K3_PARITY}; "
          f"max |diff| {fwd_err:.3g}, largest share beyond 2e-5 plus one ulp "
          f"{share:.3g}), backward and lse on {nb} cases ({K3_BWD_PARITY}; "
          f"0xFF blocks, a second call bit-equal; max |diff| {bwd_err:.3g}, "
          f"lse {lse_err:.3g}); causal / window 64 / non-causal / k_len "
          f"S/2 + 1 x G 1, 4 x S {K3_SWEEP_S}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return fwd_err, bwd_err


def phase_k3_cross(rng):
    """K3's forward and backward at Sq != Sk against their plain versions:
    whisper-medium's cross-attention (K3_CROSS, non-causal) and a causal
    suffix of the keys (K3_SUFFIX, q_start = Sk - Sq), f32 and bf16
    (bf16 forward on exact and on normal scores); then v of width 16 beside
    q and k of 32, a pair K3 is not built for, raises on the card, naming
    the pairs it is built for, and launches nothing."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    t0 = time.perf_counter()
    before = (K3.launches, K3.bwd_launches)
    fwd_err, bwd_err, n = 0.0, 0.0, 0
    for (B, Sq, Sk, H, hd), causal in ((K3_CROSS, False),
                                       (K3_SUFFIX, True)):
        mask = dict(causal=causal, q_start=Sk - Sq if causal else 0)
        for dtype, exact in ((torch.float32, False), (torch.bfloat16, True),
                             (torch.bfloat16, False)):
            q, k, v = _k3_inputs(rng, B, Sq, Sk, H, H, hd, dtype, exact)
            what = f"q {tuple(q.shape)} over k/v {tuple(k.shape)}, {mask}"
            got = K3.flash_fill(q, k, v, p_dtype=dtype, **mask)
            check(tuple(got.shape) == (B, Sq, H, hd), f"K3 output "
                  f"{tuple(got.shape)}: {what}")
            err, _, _ = _k3_hold(q, k, v, f"{what}, {dtype}", exact, **mask)
            fwd_err = max(fwd_err, err)
            if not exact:
                err, _ = _k3_bwd_case(rng, q, k, v, mask, f"{what}, {dtype}")
                bwd_err = max(bwd_err, err)
            n += 1
    q = torch.zeros((1, 64, 2, 32), device=DEVICE)
    v = torch.zeros((1, 64, 2, 16), device=DEVICE)
    lse = torch.zeros((1, 64, 2), device=DEVICE)
    counts = (K3.launches, K3.bwd_launches)
    for call in (lambda: K3.flash_fill(q, q, v, causal=True),
                 lambda: K3.flash_backward(q, q, v, v, lse, v, causal=True)):
        try:
            call()
        except ValueError as e:
            check(str(K3.WIDTH_PAIRS) in str(e), f"(32, 16) raised without "
                  f"naming the width pairs K3 is built for: {e}")
        else:
            check(False, "K3 took v of width 16 beside q/k of 32 on the card")
    check((K3.launches, K3.bwd_launches) == counts,
          "a refused (32, 16) call launched K3")
    K3.launches, K3.bwd_launches = before
    print(f"[22] K3 at Sq != Sk == plain on {n} cases (q {K3_CROSS[1]} over "
          f"k/v {K3_CROSS[2]}, {K3_CROSS[3]} heads of {K3_CROSS[4]}, "
          f"non-causal; q {K3_SUFFIX[1]} over {K3_SUFFIX[2]}, "
          f"{K3_SUFFIX[3]} heads of {K3_SUFFIX[4]}, causal, q_start "
          f"{K3_SUFFIX[2] - K3_SUFFIX[1]}; f32, bf16 exact and normal): "
          f"forward max |diff| {fwd_err:.3g}, backward {bwd_err:.3g} "
          f"({K3_BWD_PARITY}); v of width 16 beside q/k of 32 raises "
          f"naming the pairs K3 is built for, nothing launched; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return fwd_err, bwd_err


def _sdpa_yardstick(q, k, v, causal, window, q_start, grad=False):
    """``scaled_dot_product_attention`` over K3's function on q (B, Sq, H,
    hd), k, v in the model's layout (a yardstick the port never calls):
    the causal mask of a suffix (q_start = Sk - Sq) and a window that cuts
    keys are an explicit boolean mask, else ``is_causal``; grouped heads by
    ``enable_gqa``.  First PyTorch's own dispatch, named by the backend it
    picks (``torch._fused_sdp_choice``), unless that is the unfused math
    path; then each fused backend alone (cuDNN, flash, memory-efficient),
    grouped heads by ``enable_gqa`` and then with k/v repeated to H heads.
    With ``grad`` a candidate must also run the backward.  Returns (fn,
    backend, (qt, kt, vt) in SDPA's layout, the refusals before it) where
    fn() is the call, or (None, "none", ..., refusals) when no fused
    backend takes the shape."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Sq, Sk, H, Kh = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    cut = window is not None and q_start + Sq - 1 >= window
    mask = None
    if cut or (causal and (Sq != Sk or q_start)):
        qpos = torch.arange(Sq, device=DEVICE)[:, None] + q_start
        kpos = torch.arange(Sk, device=DEVICE)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=DEVICE)
        if causal:
            mask &= kpos <= qpos
        if cut:
            mask &= kpos > qpos - window
    is_causal = causal and mask is None
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(grad)
                  for t in (q, k, v))
    try:
        choice = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, attn_mask=mask, is_causal=is_causal,
            enable_gqa=H != Kh)).name
    except (AttributeError, RuntimeError, TypeError, ValueError):
        choice = "not reported"
    attempts = [] if choice == "MATH" else [
        (f"default dispatch, {choice.lower()}", None, False)]
    for name, backend in (("cuDNN", SDPBackend.CUDNN_ATTENTION),
                          ("flash", SDPBackend.FLASH_ATTENTION),
                          ("memory-efficient",
                           SDPBackend.EFFICIENT_ATTENTION)):
        attempts += [(name, backend, repeat)
                     for repeat in ((False, True) if H != Kh else (False,))]
    refusals = []
    for name, backend, repeat in attempts:
        if repeat:
            kk, vv = (t.detach().repeat_interleave(H // Kh, 1)
                      .requires_grad_(grad) for t in (kt, vt))
        else:
            kk, vv = kt, vt
        kw = dict(enable_gqa=True) if H != Kh and not repeat else {}

        def fn(kk=kk, vv=vv, kw=kw, backend=backend):
            with (sdpa_kernel(backend) if backend is not None
                  else contextlib.nullcontext()):
                return F.scaled_dot_product_attention(
                    qt, kk, vv, attn_mask=mask, is_causal=is_causal, **kw)
        label = name + (f" (k/v repeated to {H} heads)" if repeat else "")
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            try:
                out = fn()
                if grad:
                    torch.autograd.grad(out, (qt, kk, vv),
                                        torch.ones_like(out))
                torch.cuda.synchronize()
            except RuntimeError as e:
                why = "; ".join(str(w.message).splitlines()[0]
                                for w in said) or str(e).splitlines()[0]
                refusals.append(f"{label}: {why}")
                continue
        return fn, label, (qt, kk, vv), refusals
    return None, "none", (qt, kt, vt), refusals


def _sdpa_text(backend, refusals, times, launches):
    if backend == "none":
        return f"SDPA: none of its fused backends takes it ({'; '.join(refusals)})"
    return f"SDPA ({backend}) {_spread(times, launches)}"


def _k3_fwd_timing(B, Sq, Sk, H, Kh, hd, causal, label, rounds=ROUNDS,
                   launches=ROUND_LAUNCHES, hd_v=None, window=None):
    """K3's forward in turns with scaled_dot_product_attention
    (``_sdpa_yardstick``) at one shape, bf16, v of width ``hd_v`` (default
    hd), under ``window``, beside its plain version and its bound:
    2 (hd + hd_v) FLOP a live pair at 989 TFLOP/s, or q, k, v read once and
    o written once; ``rounds`` of ``launches`` each."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.tune.cost import MEM_BYTES_PER_S
    hd_v = hd_v or hd
    bf = dict(device=DEVICE, dtype=torch.bfloat16)
    q = torch.randn((B, Sq, H, hd), **bf)
    k = torch.randn((B, Sk, Kh, hd), **bf)
    v = torch.randn((B, Sk, Kh, hd_v), **bf)
    qs = Sk - Sq if causal else 0
    kw = dict(causal=causal, window=window, q_start=qs)
    sdpa, backend, _, refusals = _sdpa_yardstick(q, k, v, causal, window, qs)
    t3, tlib = _in_turns(
        lambda: K3.flash_fill(q, k, v, p_dtype=torch.bfloat16, **kw), sdpa,
        rounds, launches)
    K3.flash_attention_plain(q, k, v, p_dtype=torch.bfloat16, **kw)
    plain_ms = cuda_time_ms(lambda: K3.flash_attention_plain(
        q, k, v, p_dtype=torch.bfloat16, **kw), 2)
    pairs = K3.k3_pairs(Sq, causal, window, None, Sk, qs)
    flops = pairs * 2 * (hd + hd_v) * B * H
    nbytes = 2 * (B * Sq * H * (hd + hd_v) + B * Sk * Kh * (hd + hd_v))
    ops_ms, bytes_ms = flops / BF16_FLOPS * 1e3, nbytes / MEM_BYTES_PER_S * 1e3
    ms = statistics.median(t3)
    lib_ms = statistics.median(tlib) if tlib else None
    out = {"shape": [B, Sq, Sk, H, Kh, hd, hd_v], "causal": causal,
           "window": window, "ms": ms, "ms_range": [min(t3), max(t3)],
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_ms_range": [min(tlib), max(tlib)] if tlib else None,
           "library_backend": backend,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    if backend == "none":
        out["library_refusals"] = refusals
    ratio = f"; K3 / SDPA {ms / lib_ms:.2f}x" if lib_ms else ""
    print(f"     K3 forward, {label}, q {(B, Sq, H, hd)} over k "
          f"{(B, Sk, Kh, hd)}, v of {hd_v}, bf16, causal {causal}, window "
          f"{window}: K3 {_spread(t3, launches)}; "
          f"{_sdpa_text(backend, refusals, tlib, launches)}{ratio}; plain "
          f"{plain_ms:.2f} ms; bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']} ({flops / 1e9:.3f} GFLOP, 2 x ({hd} + {hd_v}) "
          f"a live pair over {pairs} live pairs a head; {nbytes} B); "
          f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return out


def _k3_bwd_timing(B, Sq, Sk, H, Kh, hd, causal, label, rounds=ROUNDS,
                   launches=ROUND_LAUNCHES, hd_v=None, window=None):
    """K3's backward alone in turns with SDPA's backward alone
    (``torch.autograd.grad`` on a retained graph of ``_sdpa_yardstick``'s
    call, the same function: q, k, v, O, lse and dO in, dq, dk, dv out) at
    one shape, bf16, v of width ``hd_v`` (default hd), under ``window``,
    beside its plain version and ``_k3_bwd_bound`` at bf16's and f32's
    peak; ``rounds`` of ``launches`` each."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    hd_v = hd_v or hd
    bf = dict(device=DEVICE, dtype=torch.bfloat16)
    q = torch.randn((B, Sq, H, hd), **bf)
    do = torch.randn((B, Sq, H, hd_v), **bf)
    k = torch.randn((B, Sk, Kh, hd), **bf)
    v = torch.randn((B, Sk, Kh, hd_v), **bf)
    qs = Sk - Sq if causal else 0
    kw = dict(causal=causal, window=window, q_start=qs)
    sdpa, backend, ins, refusals = _sdpa_yardstick(q, k, v, causal, window,
                                                   qs, grad=True)
    lib = None
    if sdpa:
        out_lib, dot = sdpa(), do.transpose(1, 2).contiguous()

        def lib():
            return torch.autograd.grad(out_lib, ins, dot, retain_graph=True)
    out, lse = K3.flash_fill(q, k, v, p_dtype=torch.bfloat16,
                             return_lse=True, **kw)
    tb, tlib = _in_turns(
        lambda: K3.flash_backward(q, k, v, out, lse, do, **kw), lib, rounds,
        launches)
    K3.flash_backward_plain(q, k, v, out, lse, do, **kw)
    plain_ms = cuda_time_ms(lambda: K3.flash_backward_plain(
        q, k, v, out, lse, do, **kw), 1)
    bound, by, flops, nbytes = _k3_bwd_bound(B, Sq, Sk, H, Kh, hd, causal,
                                             BF16_FLOPS, hd_v, window)
    bound32 = _k3_bwd_bound(B, Sq, Sk, H, Kh, hd, causal, F32_FLOPS, hd_v,
                            window)[0]
    ms = statistics.median(tb)
    lib_ms = statistics.median(tlib) if tlib else None
    res = {"shape": [B, Sq, Sk, H, Kh, hd, hd_v], "causal": causal,
           "window": window, "ms": ms, "ms_range": [min(tb), max(tb)],
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_ms_range": [min(tlib), max(tlib)] if tlib else None,
           "library_backend": backend, "bound_ms": bound, "bound_by": by,
           "bound_f32_ms": bound32}
    if backend == "none":
        res["library_refusals"] = refusals
    ratio = f"; K3 / SDPA {ms / lib_ms:.2f}x (medians)" if lib_ms else ""
    work = f"6 x {hd} + 4 x {hd_v}"
    print(f"     K3 backward alone, {label}, q {(B, Sq, H, hd)} over k "
          f"{(B, Sk, Kh, hd)}, v of {hd_v}, bf16, causal {causal}, window "
          f"{window}: K3 {_spread(tb, launches)}; "
          f"{_sdpa_text(backend, refusals, tlib, launches)}'s backward alone"
          f"{ratio}; plain {plain_ms:.2f} ms; bound {bound:.4f} ms by {by} "
          f"({flops / 1e9:.3f} GFLOP, {work} a live pair, at 989 TFLOP/s "
          f"bf16; {bound32:.4f} ms at 67 TFLOP/s f32; {nbytes} B); "
          f"{flops / ms / 1e9:.1f} TFLOP/s of the {work} needed, "
          f"{2 * flops / ms / 1e9:.1f} of about twice that the tensor-core "
          f"kernels issue", flush=True)
    return res


def phase_timing_k3_slice11():
    """K3's forward and backward timed at stablelm-12b's serving and
    training shapes (hd 160) and at whisper-medium's cross-attention, each
    in turns with SDPA, beside the card's name and power limit."""
    from repro_torch.kernels.flash_attn import kernel as K3
    before = (K3.launches, K3.bwd_launches)
    t0 = time.perf_counter()
    print(f"[23] K3 timed, in turns with scaled_dot_product_attention "
          f"({nvidia_smi('name,power.limit')})", flush=True)
    B, S, H, Kh, hd = K3_HD160_TIMED
    fwd160 = _k3_fwd_timing(B, S, S, H, Kh, hd, True, "stablelm-12b serving")
    B, S, H, Kh, hd = K3_HD160_TRAIN
    bwd160 = _k3_bwd_timing(B, S, S, H, Kh, hd, True,
                            "stablelm-12b training")
    # the cross shape's launches are short and their times spread: more
    # and longer rounds there
    B, Sq, Sk, H, hd = K3_CROSS
    fwd_x = _k3_fwd_timing(B, Sq, Sk, H, H, hd, False, "cross-attention",
                           *K3_CROSS_ROUNDS)
    bwd_x = _k3_bwd_timing(B, Sq, Sk, H, H, hd, False, "cross-attention",
                           *K3_CROSS_ROUNDS)
    K3.launches, K3.bwd_launches = before
    print(f"     {time.perf_counter() - t0:.1f} s", flush=True)
    return {"fwd": {"hd160": fwd160, "cross": fwd_x},
            "bwd": {"hd160": bwd160, "cross": bwd_x}}


def _cut(cfg, params, n):
    """``cfg`` and ``params`` cut to their first ``n`` layers (views of the
    first layer-stacked group, no copy); ``n`` whole periods of it."""
    import dataclasses
    from repro_torch.models.params import tree_map
    mixers_t, _, repeat = cfg.layer_plan()[0]
    p = len(mixers_t)
    check(n % p == 0 and 0 < n // p <= repeat, f"{cfg.name}: {n} layers are "
          f"not whole periods of its first group ({repeat} of {p})")
    return (dataclasses.replace(cfg, n_layers=n),
            dict(params, groups=[tree_map(lambda t: t[:n // p],
                                          params["groups"][0])]))


def _layers_that_fit(cfg, bytes_per_param, free):
    """The most layers of ``cfg`` (at least 1, at most all) whose
    parameters at ``bytes_per_param`` fit in ``free`` bytes with FIT_SPARE
    left over; the embedding and head count once."""
    import dataclasses
    from repro_torch.models.params import count_params
    one = count_params(dataclasses.replace(cfg, n_layers=1))
    per = count_params(dataclasses.replace(cfg, n_layers=2)) - one
    fixed = one - per
    fit = int((free - FIT_SPARE - fixed * bytes_per_param)
              // (per * bytes_per_param))
    return max(1, min(cfg.n_layers, fit))


def _decode_vs_forward_cut(cfg, params, prompt):
    """``_decode_vs_forward`` on as many of the model's layers (whole
    periods of its first group, or all of them) as an f32 copy of them fits
    beside the card's resident state with FIT_SPARE to spare; prints the
    cut."""
    import torch
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    n = _layers_that_fit(cfg, 4, free)
    if n < cfg.n_layers:
        p = len(cfg.layer_plan()[0][0])
        n = max(p, n - n % p)
    print(f"    the f32 check runs on {n} of {cfg.n_layers} layers (its f32 "
          f"copy beside {torch.cuda.memory_allocated() / 1e9:.1f} GB "
          f"resident, {free / 1e9:.1f} GB free, {FIT_SPARE / 1e9:.0f} GB to "
          f"spare)", flush=True)
    _decode_vs_forward(*(_cut(cfg, params, n) if n < cfg.n_layers
                         else (cfg, params)), prompt)


def _first_attention(cfg, params, prompt):
    """The first attention sublayer of ``cfg`` (GQA, sliding-window or
    MLA) applied to ``prompt``'s normed embeddings: its q, k, v as K3
    receives them and K3's mask and scale arguments."""
    import math
    import torch
    from repro_torch.models import layers, lm, mixers
    from repro_torch.models.params import tree_map
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
    x = lm._embed(cfg, params, toks)
    mixers_t = cfg.layer_plan()[0][0]
    t = next(i for i, k in enumerate(mixers_t)
             if k in ("attn", "attn_local", "mla"))
    p = tree_map(lambda a: a[0], params["groups"][0])[f"sub{t}"]
    h = layers.norm_apply(cfg, p["norm1"], x)
    pos = torch.arange(len(prompt), dtype=torch.int32, device=DEVICE)[None]
    if mixers_t[t] == "mla":
        q, k, v = mixers.mla_qkv(cfg, p["mixer"], h, pos)[:3]
        mask = dict(causal=True, scale=1.0 / math.sqrt(cfg.head_dim
                                                       + cfg.rope_dim))
    else:
        q, k, v = mixers.attn_qkv(cfg, p["mixer"], h, pos)
        mask = dict(causal=True, window=cfg.window
                    if mixers_t[t] == "attn_local" else None)
    return q, k, v, mask, t


def _hold_layer0(cfg, params, prompt, what):
    """K3 against its plain version on the q/k/v that the first attention
    sublayer of the first period makes of ``prompt`` (layer 0's, and for a
    model led by recurrent layers that sublayer applied to the normed
    embeddings)."""
    from repro_torch.kernels.flash_attn import kernel as K3
    before = K3.launches
    q, k, v, mask, t = _first_attention(cfg, params, prompt)
    err, share, err32 = _k3_hold(q, k, v, what, **mask)
    K3.launches = before
    where = "layer 0's" if t == 0 else f"sublayer {t}'s (on the embeddings)"
    print(f"    K3 == plain ({K3_PARITY}) on {where} q/k/v of the longest "
          f"prompt, q {tuple(q.shape)} k {tuple(k.shape)} v "
          f"{tuple(v.shape)}, {q.dtype}, window {mask.get('window')}: max "
          f"|diff| {err:.3g}; {share:.3g} of outputs beyond 2e-5 plus one "
          f"ulp; against plain with p kept in f32: max |diff| {err32:.3g}",
          flush=True)
    return err


def phase_stablelm():
    return _serve_k3("stablelm-12b", 24)


def _attention_layers(cfg):
    """The layers of ``cfg`` that run K3 (GQA, sliding-window, MLA)."""
    return sum(repeat * sum(k in ("attn", "attn_local", "mla")
                            for k in mixers_t)
               for mixers_t, _, repeat in cfg.layer_plan())


def _k3_shape(cfg):
    """(H, Kh, hd, hd_v, window, scale) of the K3 calls ``cfg`` makes."""
    import math
    kinds = cfg.layer_plan()[0][0]
    if "mla" in kinds:
        hd = cfg.head_dim + cfg.rope_dim
        return (cfg.n_heads_eff, cfg.n_heads_eff, hd, cfg.head_dim, None,
                1.0 / math.sqrt(hd))
    return (cfg.n_heads_eff, cfg.n_kv_eff, cfg.head_dim, cfg.head_dim,
            cfg.window if "attn_local" in kinds else None, None)


def _serve_k3(arch, phase, logits_check=None, after=None, cfg=None,
              reqs=None, max_len=SERVE_MAX_LEN):
    """``arch`` at full width (random from seed SEED; ``cfg``: a depth cut
    of it) serves the phase's traffic (``reqs`` on SERVE_SLOTS slots of
    ``max_len``; by default phase 12's) on K3: K3 launched once an
    attention layer a request, K4 never; K3 held to its plain version on
    the first attention layer's q/k/v of the longest prompt; K3's share of
    the prefill and a profile of one prefill and three decode steps; the
    prefill and first decode logits held to ``forward`` on as many layers
    as an f32 copy fits with FIT_SPARE to spare (all of olmo-1b's), by
    ``logits_check(cfg, params, longest)`` where given; then
    ``after(cfg, params, longest)``, whose dict joins the result."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as K3
    t0 = time.perf_counter()
    full = configs.get(arch)
    cfg = cfg or full
    cut = "" if cfg.n_layers == full.n_layers else \
        f", depth cut to {cfg.n_layers} of {full.n_layers}"
    print(f"[{phase}] {arch} at full width ({cfg.n_layers} layers{cut}, d "
          f"{cfg.d_model}, {cfg.n_heads_eff} / {cfg.n_kv_eff} heads of "
          f"{cfg.head_dim})", flush=True)
    params = _full_params(cfg)
    run = _serve(cfg, params, reqs, max_len)
    n_attn = _attention_layers(cfg)
    want = len(run["done"]) * n_attn
    check(run["counts"][2] == want, f"{arch} serving launched K3 "
          f"{run['counts'][2]} times, not {want}")
    check(run["counts"][3] == 0, f"{arch} serving launched K4")
    longest = max(run["done"], key=lambda r: len(r.prompt)).prompt
    err = _hold_layer0(cfg, params, longest, f"{arch} first attention")
    before = K3.launches
    H, Kh, hd, hd_v, window, scale = _k3_shape(cfg)

    def k3_at(n):
        bf = dict(device=DEVICE, dtype=torch.bfloat16)
        q = torch.randn((1, n, H, hd), **bf)
        k = torch.randn((1, n, Kh, hd), **bf)
        v = torch.randn((1, n, Kh, hd_v), **bf)
        return lambda: K3.flash_fill(q, k, v, causal=True, window=window,
                                     scale=scale, p_dtype=torch.bfloat16)
    k3_s = _kernel_share(k3_at, [len(r.prompt) for r in run["done"]],
                         n_attn)
    _profile_serving(cfg, params, run["session"], longest)
    K3.launches = before
    st = run["stats"]
    print(f"    where the time goes: prefill {st['prefill_s']:.3f} s "
          f"({100 * st['prefill_s'] / run['wall']:.1f} % of wall; K3 "
          f"{k3_s:.3f} s of it, {100 * k3_s / st['prefill_s']:.1f} %, from "
          f"each prompt's K3 timed alone x {n_attn} attention layers), "
          f"decode {st['decode_s']:.3f} s "
          f"({100 * st['decode_s'] / run['wall']:.1f} %; "
          f"{1e3 * st['decode_s'] / st['steps']:.2f} ms a step)", flush=True)
    launches = run["counts"][2]
    summary = {"wall_s": run["wall"], "peak_gib": run["peak"] / 2**30,
               "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
               "decode_steps": st["steps"],
               "decode_step_ms": 1e3 * st["decode_s"] / st["steps"],
               "k3_prefill_s": k3_s}
    del run
    extra = (logits_check or _decode_vs_forward_cut)(cfg, params,
                                                     longest) or {}
    extra.update(after(cfg, params, longest) if after else {})
    del params
    torch.cuda.empty_cache()
    print(f"    phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"k3_launches": launches, "k3_err": err, "serve": summary,
            "layers": cfg.n_layers, **extra}


def _prefill_decode_run(cfg, params, prompt, what):
    """One prefill of ``prompt`` and one decode step with every launch
    count at 0: K3 launched once a layer, K4 never; wall time."""
    import torch
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
    torch.cuda.synchronize()
    mods = _reset_counts()
    t0 = time.perf_counter()
    _prefill_decode(cfg, params, toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [m.launches for m in mods]
    check(counts[2] == cfg.n_layers and counts[3] == 0,
          f"{what}: prefill and decode launched K1-K4 {counts}, want K3 "
          f"{cfg.n_layers} times")
    print(f"    {what}: prefill of {len(prompt)} tokens and one decode "
          f"step in {wall:.3f} s; launches K1-K4 {counts}", flush=True)
    return counts[2]


def phase_phi3_command_r():
    """phi3-medium-14b (full depth, 48 / 16 padded heads of 128) and
    command-r-plus-104b (full width at the depth whose bf16 weights and
    their f32 copy fit one card with FIT_SPARE to spare: parallel block,
    q/k norm, LayerNorm) at full width: one prefill and decode of phase
    12's longest prompt each on K3, K3 held on layer 0, the logits held to
    ``forward`` (on a depth cut for phi3)."""
    import dataclasses
    import torch
    from repro_torch import configs
    t0 = time.perf_counter()
    out = {}
    cfg = configs.get("phi3-medium-14b")
    print(f"[25] phi3-medium-14b at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads padded to "
          f"{cfg.n_heads_eff} / {cfg.n_kv_eff}, hd {cfg.head_dim})",
          flush=True)
    params = _full_params(cfg)
    longest = max(_serve_requests(cfg), key=lambda r: len(r.prompt)).prompt
    launches = _prefill_decode_run(cfg, params, longest, "phi3-medium-14b")
    err = _hold_layer0(cfg, params, longest, "phi3-medium-14b layer 0")
    _decode_vs_forward_cut(cfg, params, longest)
    out["phi3"] = {"k3_launches": launches, "k3_err": err,
                   "layers": cfg.n_layers}
    del params
    torch.cuda.empty_cache()

    full = configs.get("command-r-plus-104b")
    n = _layers_that_fit(full, 2 + 4, torch.cuda.mem_get_info()[0])
    cfg = dataclasses.replace(full, n_layers=n)
    print(f"     command-r-plus-104b at full width (d {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"parallel block, q/k norm, LayerNorm), depth cut to {n} of "
          f"{full.n_layers} layers: its bf16 weights and their f32 copy "
          f"fit with {FIT_SPARE / 1e9:.0f} GB to spare", flush=True)
    params = _full_params(cfg)
    longest = max(_serve_requests(cfg), key=lambda r: len(r.prompt)).prompt
    launches = _prefill_decode_run(cfg, params, longest,
                                   "command-r-plus-104b")
    err = _hold_layer0(cfg, params, longest, "command-r-plus-104b layer 0")
    _decode_vs_forward(cfg, params, longest)
    out["command_r"] = {"k3_launches": launches, "k3_err": err, "layers": n}
    del params
    torch.cuda.empty_cache()
    print(f"    phase 25: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_train_stablelm():
    """stablelm-12b at full width and STABLELM_TRAIN_LAYERS of its 40
    layers trains through train_loop on K3 at hd 160, each step two
    microbatches of half the batch (the config's ``accum_steps``, as in
    JAX); the first step's recorded backward (layer 0) is held against
    flash_backward_plain; K3's share of a step."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as K3
    L = STABLELM_TRAIN_LAYERS
    cfg = dataclasses.replace(configs.get("stablelm-12b"), n_layers=L)
    n = L * cfg.accum_steps            # layer passes a step
    run = _train_full("stablelm-12b", K3, "flash_backward", 2 * n, n, 26,
                      cfg=cfg, keep_first=True)
    run.pop("last")
    args, kw = _detached(run.pop("first"))
    before = (K3.launches, K3.bwd_launches)
    err = _hold_k3_bwd(args, kw, "stablelm-12b layer 0, first step")
    q, k, v = args[:3]
    fwd_ms = cuda_time_ms(lambda: K3.flash_fill(
        q, k, v, causal=True, p_dtype=q.dtype, return_lse=True), 5)
    bwd_ms = cuda_time_ms(lambda: K3.flash_backward(*args, **kw), 3)
    K3.launches, K3.bwd_launches = before
    share = (2 * n * fwd_ms + n * bwd_ms) / 1e3 / run["step_s"]
    print(f"    K3 backward == plain ({K3_BWD_PARITY}) on layer 0's recorded "
          f"q/k/v/o/lse/dO of the first step, q {tuple(q.shape)} k/v "
          f"{tuple(k.shape)}, {q.dtype}: max |diff| {err:.3g}; K3 forward "
          f"(with lse) {fwd_ms:.3f} ms x {2 * n} and backward {bwd_ms:.3f} "
          f"ms x {n} a step ({cfg.accum_steps} microbatches): "
          f"{100 * share:.1f} % of the step", flush=True)
    del args, kw
    torch.cuda.empty_cache()
    return dict(run, k3_err=err, k3_fwd_ms=fwd_ms, k3_bwd_ms=bwd_ms,
                k3_share=share, layers=L)


def phase_align_launcher():
    """``launch.serve.serve_alignments`` on the card at the JAX launcher's
    defaults (32 pairs of 128 from ``genomics_pairs``, #2, an
    ``AlignmentService(max_len=128, block=8)``): every drained result
    (score, end cell, CIGAR) equal to the port's ``reference`` engine on
    the CPU over the same pairs, K1 launched; then ``python3 -m
    repro_torch.launch.serve --mode align`` as a subprocess exits 0 and
    prints "alignment service drained OK"."""
    import os
    import torch
    from repro_torch.data import genomics_pairs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import AlignmentService, AlignRequest
    t0 = time.perf_counter()
    seen = []
    submit = AlignmentService.submit

    def record(self, req):
        seen.append(req)
        return submit(self, req)
    mods = _reset_counts()
    AlignmentService.submit = record
    try:
        launch_serve.serve_alignments()
    finally:
        AlignmentService.submit = submit
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = mods[0].launches
    check(k1 > 0, "serve_alignments did not launch K1")
    check(sum(m.launches for m in mods[1:]) == 0,
          "serve_alignments launched a kernel other than K1")
    got = [r.result for r in seen]
    qs, rs, ql, rl = genomics_pairs(32, 128, seed=0)
    ref = AlignmentService(max_len=128, block=8, engine_name="reference",
                           device="cpu")
    reqs = [AlignRequest(rid=i, kernel="global_affine", query=qs[i, :ql[i]],
                         ref=rs[i, :rl[i]]) for i in range(32)]
    for r in reqs:
        ref.submit(r)
    ref.drain()
    check(len(got) == 32, f"serve_alignments drained {len(got)} of 32")
    for i, (g, w) in enumerate(zip(got, (r.result for r in reqs))):
        check(g == w and "cigar" in g, f"serve_alignments request {i}: card "
              f"{g} != the CPU's reference engine {w}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--mode", "align"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines[-1:] ==
          ["alignment service drained OK"], f"--mode align exited "
          f"{proc.returncode}: {proc.stdout[-500:]} {proc.stderr[-2000:]}")
    print(f"[27] serve_alignments on the card: 32 pairs of 128 (#2) drained "
          f"in {wall:.3f} s on {k1} K1 launches, every score, end cell and "
          f"CIGAR == the CPU's reference engine; python3 -m "
          f"repro_torch.launch.serve --mode align exited 0 in "
          f"{time.perf_counter() - t1:.1f} s: {lines[-1]}", flush=True)
    return {"k1_launches": k1, "wall_s": wall}


# ---------------------------------------------------------------------------
# Slice 12 (phases 28-31): MoE, the encoder-decoder, the multimodal prefix
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _recording_routes():
    """Within the block, every call of ``moe.route`` keeps its experts and
    keep mask, token-major ((groups x group) rows of top_k), in order."""
    from repro_torch.models import moe
    calls, orig = [], moe.route

    def record(cfg, router, xt, C):
        out = orig(cfg, router, xt, C)
        calls.append((out[2].reshape(-1, cfg.top_k),
                      out[4].reshape(-1, cfg.top_k)))
        return out
    moe.route = record
    try:
        yield calls
    finally:
        moe.route = orig


def _moe_drops(cfg, params, prompt):
    """One bf16 prefill of ``prompt`` at full depth: per layer, the prompt's
    tokens that lose at least one of their top_k choices to the capacity,
    and the choices lost (pad rows of the ragged last group left out)."""
    import torch
    from repro_torch.models import lm
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
    Lp = toks.shape[1]
    with _recording_routes() as calls:
        lm.prefill(cfg, params, {"tokens": toks})
    tokens = [int((~keep[:Lp]).any(-1).sum()) for _, keep in calls]
    choices = [int((~keep[:Lp]).sum()) for _, keep in calls]
    n_moe = sum(r for _, f, r in cfg.layer_plan() if f == "moe")
    check(len(calls) == n_moe, f"{cfg.name}: {len(calls)} routes in one "
          f"prefill, not {n_moe}")
    print(f"    capacity {cfg.capacity_factor} drops during one prefill of "
          f"{Lp} tokens (groups of {cfg.moe_group}): per MoE layer, tokens "
          f"with a dropped choice {tokens} ({sum(tokens)} of {Lp * n_moe} "
          f"token-layers), choices dropped {sum(choices)} of "
          f"{Lp * cfg.top_k * n_moe} "
          f"({100 * sum(choices) / (Lp * cfg.top_k * n_moe):.2f} %)",
          flush=True)
    return {"drop_tokens_per_layer": tokens, "drop_choices": sum(choices),
            "choices": Lp * cfg.top_k * n_moe}


def _moe_logits_check(cfg, params, prompt):
    """The f32 logits check of an MoE model, on as many layers as an f32
    copy fits with FIT_SPARE to spare.  The router groups tokens, so a
    token's expert choices can depend on the tokens after it (a later
    token's first choice outranks an earlier token's second for a slot),
    in JAX as here: ``forward`` over prompt + 1 routes its last group
    otherwise than prefill + decode do.  So the prefill logits are held to
    ``forward`` over the prompt alone (the same groups: always compared),
    and the prefill and decode logits to ``forward`` over prompt + 1 at
    positions Lp - 1 and Lp only where every token up to that position got
    the same experts and keep mask in every layer (each route recorded);
    the other positions are counted as skipped.  Then, at a capacity where
    nothing can drop (``capacity_factor = n_experts / top_k``: an expert
    takes a whole group), routing is token by token and both positions are
    held to ``forward`` over prompt + 1; a decode from a cache with layer
    0's keys zeroed must miss that check."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    from repro_torch.models.params import tree_map
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    n = _layers_that_fit(cfg, 4, free)
    cut, cut_params = _cut(cfg, params, n)
    cfg32 = dataclasses.replace(cut, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), cut_params)
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=DEVICE)[None]
    Lp = toks.shape[1]
    with _recording_routes() as served:
        logits_p, logits_d, nxt = _prefill_decode(cfg32, params32, toks)
    batch = {"tokens": torch.cat([toks, nxt[:, None]], 1)}
    with _recording_routes() as fwd:
        ref = lm.forward(cfg32, params32, batch)["logits"][0, Lp - 1:]
    alone = lm.forward(cfg32, params32, {"tokens": toks})["logits"][0, -1]
    same = torch.ones(Lp + 1, dtype=torch.bool, device=DEVICE)
    for layer in range(n):
        (ip, kp), (idd, kd), (jf, kf) = served[layer], served[n + layer], \
            fwd[layer]
        idx = torch.cat([ip[:Lp], idd[:1]])
        keep = torch.cat([kp[:Lp], kd[:1]])
        same &= (idx == jf[:Lp + 1]).all(-1) & (keep == kf[:Lp + 1]).all(-1)
    comparable = [bool(same[:Lp].all()), bool(same.all())]
    diff = float((logits_p - alone).abs().max())
    check(torch.allclose(logits_p, alone, atol=2e-3, rtol=1e-3),
          f"{cfg.name}: f32 prefill logits differ from forward over the "
          f"prompt by up to {diff:.3g}")
    errs = []
    for i, (got, ok) in enumerate(zip((logits_p, logits_d), comparable)):
        if ok:
            e = float((got - ref[i]).abs().max())
            check(torch.allclose(got, ref[i], atol=2e-3, rtol=1e-3),
                  f"{cfg.name}: f32 logits at position {Lp - 1 + i} differ "
                  f"from forward over prompt + 1 by up to {e:.3g}")
            errs.append(f"position {Lp - 1 + i} {e:.3g}")
    skipped = comparable.count(False)
    differ = int((~same).sum())
    del ref, alone

    nodrop = dataclasses.replace(cfg32, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    ref = lm.forward(nodrop, params32, batch)["logits"][0, Lp - 1:]
    full = []
    for i, got in enumerate(_prefill_decode(nodrop, params32, toks,
                                            nxt)[:2]):
        e = float((got - ref[i]).abs().max())
        check(torch.allclose(got, ref[i], atol=2e-3, rtol=1e-3),
              f"{cfg.name}: at no-drop capacity the f32 logits at position "
              f"{Lp - 1 + i} differ from forward by up to {e:.3g}")
        full.append(e)
    spoiled = _prefill_decode(nodrop, params32, toks, nxt, spoil=True)[1]
    miss = float((spoiled - ref[1]).abs().max())
    check(not torch.allclose(spoiled, ref[1], atol=2e-3, rtol=1e-3),
          f"{cfg.name}: a decode from a spoiled cache passes the f32 check")
    del params32, ref
    torch.cuda.empty_cache()
    print(f"    f32 logits on {n} of {cfg.n_layers} layers (an f32 copy "
          f"beside {free / 1e9:.1f} GB free, {FIT_SPARE / 1e9:.0f} GB to "
          f"spare; TF32 off; within 2e-3 / 1e-3): prefill vs forward over "
          f"the prompt alone max |diff| {diff:.3g}; vs forward over prompt "
          f"+ 1: {', '.join(errs) or 'none compared'}; {skipped} of 2 "
          f"positions skipped ({differ} of {Lp + 1} tokens routed otherwise "
          f"in some layer); at capacity factor {nodrop.capacity_factor:g} "
          f"(no drop possible) the prefill and decode logits vs forward "
          f"over prompt + 1: max |diff| {full[0]:.3g} and {full[1]:.3g}, "
          f"and a decode with layer 0's keys zeroed misses by {miss:.3g} "
          f"and fails the check", flush=True)
    return {"f32_layers": n, "skipped_positions": skipped,
            "nodrop_f32_err": max(full)}


def phase_qwen3_moe():
    """qwen3-moe-30b-a3b at full width serves phase 12's traffic on K3;
    the capacity's drops during one prefill; the MoE f32 logits check."""
    return _serve_k3("qwen3-moe-30b-a3b", 28, logits_check=_moe_logits_check,
                     after=lambda cfg, params, longest: _moe_drops(
                         cfg, params, longest))


def _whisper_inputs(cfg):
    """WHISPER_ITEMS windows of WHISPER_FRAMES frame embeddings (f32,
    N(0, 0.02^2) as LMBatcher's frames, from a generator seeded SEED on
    the card) and decoder prompts of WHISPER_PROMPTS tokens (numpy seed
    SEED)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    lens = rng.integers(WHISPER_PROMPTS[0], WHISPER_PROMPTS[1] + 1,
                        WHISPER_ITEMS)
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab_size, int(n)),
                               dtype=torch.int64, device=DEVICE)[None]
               for n in lens]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    frames = torch.randn((WHISPER_ITEMS, WHISPER_FRAMES, cfg.d_model),
                         generator=gen, device=DEVICE) * 0.02
    return frames, prompts


def _whisper_prefill_decode(cfg, params, frames, toks, nxt=None,
                            spoil=False):
    """Prefill one item, splice its cache into a zero cache of Lp + 1
    decoder slots, decode ``nxt`` (default the greedy token); ``spoil``
    zeroes layer 0's self keys first.  -> (prefill logits, decode logits,
    nxt)."""
    import torch
    from repro_torch.models import whisper
    from repro_torch.models.params import tree_map
    from repro_torch.serve.engine import _splice
    Lp = toks.shape[1]
    logits_p, built, k_len = whisper.prefill(cfg, params, {
        "frames": frames, "tokens": toks})
    if nxt is None:
        nxt = torch.argmax(logits_p, -1)
    cache = whisper.init_cache(cfg, 1, Lp + 1, frames.shape[1], DEVICE)
    tree_map(lambda big, one: _splice(big, one, 0), cache, built)
    if spoil:
        cache["self"]["k"][0].zero_()
    logits_d, _ = whisper.decode_step(cfg, params, cache, nxt, k_len)
    return logits_p[0], logits_d[0], nxt


def phase_whisper():
    """whisper-medium at full width: WHISPER_ITEMS windows of 30 s (1500
    frames) each prefilled alone through ``whisper.prefill`` (K3 a layer
    for the encoder's self-attention, the decoder's causal self-attention
    and its cross-attention at Sq != Sk) and spliced into one
    ``init_cache`` of WHISPER_CTX decoder slots, then WHISPER_DECODE
    batched greedy ``decode_step``s (decode attention in plain torch);
    K3 held on layer 0's encoder and cross-attention inputs; the prefill
    and first decode logits held to ``forward`` in f32 (the whole f32 copy
    fits), and a decode with layer 0's self keys zeroed must miss."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.models import layers, mixers, whisper
    from repro_torch.models.params import tree_map
    from repro_torch.serve.engine import _splice
    t0 = time.perf_counter()
    cfg = configs.get("whisper-medium")
    L, Le, H, hd = cfg.n_layers, cfg.n_enc_layers, cfg.n_heads, cfg.head_dim
    print(f"[29] whisper-medium at full width ({Le} + {L} layers, d "
          f"{cfg.d_model}, {H} heads of {hd}): {WHISPER_ITEMS} windows of "
          f"{WHISPER_FRAMES} frames, prompts of {WHISPER_PROMPTS[0]}-"
          f"{WHISPER_PROMPTS[1]} tokens, {WHISPER_DECODE} decode steps on "
          f"a {WHISPER_CTX}-token self cache", flush=True)
    params = _full_params(cfg)
    frames, prompts = _whisper_inputs(cfg)
    _whisper_prefill_decode(cfg, params, frames[:1], prompts[0])   # warm
    cache = whisper.init_cache(cfg, WHISPER_ITEMS, WHISPER_CTX,
                               WHISPER_FRAMES, DEVICE)
    k_len = torch.zeros(WHISPER_ITEMS, dtype=torch.int32, device=DEVICE)
    last = torch.zeros(WHISPER_ITEMS, dtype=torch.int64, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mods = _reset_counts()
    t1 = time.perf_counter()
    for i, toks in enumerate(prompts):
        logits, built, _ = whisper.prefill(cfg, params, {
            "frames": frames[i:i + 1], "tokens": toks})
        tree_map(lambda big, one: _splice(big, one, i), cache, built)
        last[i] = torch.argmax(logits[0])
        k_len[i] = toks.shape[1]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    counts = [m.launches for m in mods]
    per = Le + 2 * L
    check(counts == [0, 0, WHISPER_ITEMS * per, 0],
          f"whisper prefills launched K1-K4 {counts}, want K3 "
          f"{WHISPER_ITEMS} x {per}")
    mods = _reset_counts()
    t2 = time.perf_counter()
    out = []
    for _ in range(WHISPER_DECODE):
        logits, cache = whisper.decode_step(cfg, params, cache, last, k_len)
        last = torch.argmax(logits, -1)
        k_len = k_len + 1
        out.append(last)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t2
    peak = torch.cuda.max_memory_allocated()
    check(all(m.launches == 0 for m in mods), "whisper decode launched a "
          "kernel of K1-K4 (its attention is plain torch)")
    toks_out = torch.stack(out, 1)
    check(bool(((toks_out >= 0) & (toks_out < cfg.vocab_eff)).all()),
          "whisper decoded a token outside the vocabulary")
    del cache

    # K3 against plain on layer 0's encoder and cross-attention inputs
    before = K3.launches
    enc0 = tree_map(lambda t: t[0], params["enc"]["stack"])
    dt = torch.bfloat16
    x = frames[:1].to(dt) + params["enc"]["pos"][:WHISPER_FRAMES].to(dt)[None]
    h = layers.norm_apply(cfg, enc0["norm1"], x)
    qe = mixers._proj(h, enc0["attn"]["wq"])
    ke, ve = (mixers._proj(h, enc0["attn"][w]) for w in ("wk", "wv"))
    err_e = _k3_hold(qe, ke, ve, "whisper encoder layer 0", causal=False)[0]
    enc_out = whisper.encode(cfg, params, frames[:1])
    dec0 = tree_map(lambda t: t[0], params["dec"]["stack"])
    hx = layers.norm_apply(cfg, dec0["norm_x"], whisper._dec_embed(
        cfg, params, prompts[0]))
    qx = mixers._proj(hx, dec0["cross"]["wq"])
    kx, vx = (mixers._proj(enc_out, dec0["cross"][w]) for w in ("wk", "wv"))
    err_x = _k3_hold(qx, kx, vx, "whisper cross layer 0 (the embedded "
                     "prompt as its input)", causal=False)[0]
    K3.launches = before

    # K3's share of the prefills: each launch shape timed alone
    def timed(Sq, Sk, causal):
        q = torch.randn((1, Sq, H, hd), device=DEVICE, dtype=dt)
        kv = [torch.randn((1, Sk, H, hd), device=DEVICE, dtype=dt)
              for _ in range(2)]
        fn = lambda: K3.flash_fill(q, *kv, causal=causal, p_dtype=dt)
        fn()
        return cuda_time_ms(fn, 3)
    enc_ms = timed(WHISPER_FRAMES, WHISPER_FRAMES, False)
    k3_s = 0.0
    for toks in prompts:
        n = toks.shape[1]
        k3_s += Le * enc_ms + L * (timed(n, n, True)
                                   + timed(n, WHISPER_FRAMES, False))
    k3_s /= 1e3
    K3.launches = before

    # f32: prefill and first decode against forward
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), params)
    toks = prompts[0]
    Lp = toks.shape[1]
    lp, ld, nxt = _whisper_prefill_decode(cfg32, params32, frames[:1], toks)
    ref = whisper.forward(cfg32, params32, {
        "frames": frames[:1], "tokens": torch.cat([toks, nxt[:, None]], 1)
    })["logits"][0, Lp - 1:]
    errs = []
    for i, got in enumerate((lp, ld)):
        e = float((got - ref[i]).abs().max())
        check(torch.allclose(got, ref[i], atol=2e-3, rtol=1e-3),
              f"whisper-medium: f32 logits at position {Lp - 1 + i} differ "
              f"from the f32 forward by up to {e:.3g}")
        errs.append(e)
    spoiled = _whisper_prefill_decode(cfg32, params32, frames[:1], toks, nxt,
                                      spoil=True)[1]
    miss = float((spoiled - ref[1]).abs().max())
    check(not torch.allclose(spoiled, ref[1], atol=2e-3, rtol=1e-3),
          "whisper-medium: a decode from a spoiled cache passes the f32 check")
    K3.launches = before
    del params, params32, ref, enc_out
    torch.cuda.empty_cache()
    step_ms = 1e3 * decode_s / WHISPER_DECODE
    lens = sorted(p.shape[1] for p in prompts)
    print(f"    {WHISPER_ITEMS} prefills ({Le} encoder layers over "
          f"{WHISPER_FRAMES} frames, prompts {lens}): "
          f"{prefill_s:.3f} s ({1e3 * prefill_s / WHISPER_ITEMS:.1f} ms an "
          f"item), K3 {counts[2]} launches ({per} a prefill), K3 "
          f"{k3_s:.3f} s of it ({100 * k3_s / prefill_s:.1f} %, each "
          f"launch shape timed alone); {WHISPER_DECODE} decode steps on "
          f"{WHISPER_ITEMS} slots: {decode_s:.3f} s ({step_ms:.2f} ms a "
          f"step, {WHISPER_ITEMS * WHISPER_DECODE / decode_s:.0f} tokens/s); "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"    K3 == plain ({K3_PARITY}) on layer 0's encoder q/k/v "
          f"{tuple(qe.shape)} (max |diff| {err_e:.3g}) and cross q "
          f"{tuple(qx.shape)} over k/v {tuple(kx.shape)} (max |diff| "
          f"{err_x:.3g}); f32 prefill and first decode logits vs the f32 "
          f"forward (within 2e-3 / 1e-3): max |diff| {errs[0]:.3g} and "
          f"{errs[1]:.3g}; a decode with layer 0's self keys zeroed misses by "
          f"{miss:.3g} and fails the check; phase 29: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"k3_launches": counts[2], "k3_per_prefill": per,
            "k3_err": max(err_e, err_x), "prefill_s": prefill_s,
            "decode_step_ms": step_ms, "k3_prefill_s": k3_s,
            "peak_gib": peak / 2**30}


def _llava_prefix(cfg, params, longest):
    """One ``lm.prefill`` of LLAVA_PATCHES patch embeddings ahead of a
    LLAVA_PROMPT-token prompt, ``grow_cache`` and LLAVA_DECODE greedy
    decode steps (timed, K3 once a layer); K3 held on layer 0's q/k/v of
    that prefill; then the same in f32 on as many layers as an f32 copy
    fits with FIT_SPARE to spare, the prefill and every decode step's
    logits held to ``forward`` over the prefix, the prompt and the decoded
    tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.llava_next_mistral_7b import LLAVA_PATCHES
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.models import layers, lm, mixers
    from repro_torch.models.params import tree_map
    rng = np.random.default_rng(SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, LLAVA_PROMPT),
                           dtype=torch.int64, device=DEVICE)[None]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pe = torch.randn((1, LLAVA_PATCHES, cfg.d_model), generator=gen,
                     device=DEVICE) * 0.02
    Lp = LLAVA_PATCHES + LLAVA_PROMPT

    def run(c, p):
        logits, cache, k_len = lm.prefill(c, p, {"prefix_embeds": pe,
                                                 "tokens": toks})
        check(int(k_len[0]) == Lp, f"llava prefill k_len {int(k_len[0])}, "
              f"not {Lp}")
        cache = lm.grow_cache(c, cache, 1, Lp + LLAVA_DECODE)
        out, fed = [logits[0]], []
        for i in range(LLAVA_DECODE):
            nxt = torch.argmax(out[-1])[None]
            fed.append(nxt)
            logits, cache = lm.decode_step(c, p, cache, nxt, k_len + i)
            out.append(logits[0])
        return out, torch.cat(fed)

    run(cfg, params)                                        # warm
    torch.cuda.synchronize()
    mods = _reset_counts()
    t0 = time.perf_counter()
    logits, cache, k_len = lm.prefill(cfg, params, {"prefix_embeds": pe,
                                                    "tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = [m.launches for m in mods]
    check(counts == [0, 0, cfg.n_layers, 0], f"llava prefix prefill "
          f"launched K1-K4 {counts}, want K3 {cfg.n_layers} times")
    cache = lm.grow_cache(cfg, cache, 1, Lp + LLAVA_DECODE)
    nxt = torch.argmax(logits, -1)
    t1 = time.perf_counter()
    for i in range(LLAVA_DECODE):
        logits, cache = lm.decode_step(cfg, params, cache, nxt, k_len + i)
        nxt = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1) / LLAVA_DECODE
    check([m.launches for m in mods] == counts, "llava decode launched a "
          "kernel of K1-K4")
    del cache

    before = K3.launches
    p0 = tree_map(lambda t: t[0], params["groups"][0])["sub0"]
    x, _ = lm._assemble_input(cfg, params, {"prefix_embeds": pe,
                                            "tokens": toks})
    h = layers.norm_apply(cfg, p0["norm1"], x)
    pos = torch.arange(Lp, dtype=torch.int32, device=DEVICE)[None]
    q, k, v = mixers.attn_qkv(cfg, p0["mixer"], h, pos)
    err = _k3_hold(q, k, v, "llava layer 0 with the patch prefix",
                   causal=True)[0]
    K3.launches = before

    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    n = _layers_that_fit(cfg, 4, free)
    cut, cut_params = _cut(cfg, params, n)
    cfg32 = dataclasses.replace(cut, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), cut_params)
    got, fed = run(cfg32, params32)
    ref = lm.forward(cfg32, params32, {
        "prefix_embeds": pe, "tokens": torch.cat([toks[0], fed])[None]
    })["logits"][0, Lp - 1:]
    worst = 0.0
    for i, g in enumerate(got):
        e = float((g - ref[i]).abs().max())
        check(torch.allclose(g, ref[i], atol=2e-3, rtol=1e-3),
              f"llava: f32 logits at position {Lp - 1 + i} (prefix "
              f"{LLAVA_PATCHES}) differ from forward by up to {e:.3g}")
        worst = max(worst, e)
    K3.launches = before
    del params32, ref
    torch.cuda.empty_cache()
    print(f"    patch prefix: one prefill of {LLAVA_PATCHES} patch "
          f"embeddings + {LLAVA_PROMPT} tokens in {prefill_s:.3f} s "
          f"({Lp / prefill_s:.0f} positions/s, K3 {counts[2]} launches), "
          f"{LLAVA_DECODE} decode steps after grow_cache at {step_ms:.2f} ms "
          f"a step; K3 == plain on layer 0's q/k/v {tuple(q.shape)} over "
          f"{tuple(k.shape)} (max |diff| {err:.3g}); f32 on {n} of "
          f"{cfg.n_layers} layers: the prefill and {LLAVA_DECODE} decode "
          f"logits within 2e-3 / 1e-3 of forward over the prefix, the "
          f"prompt and the decoded tokens, max |diff| {worst:.3g}",
          flush=True)
    return {"prefix_prefill_s": prefill_s, "prefix_decode_step_ms": step_ms,
            "prefix_k3_launches": counts[2], "prefix_k3_err": err,
            "prefix_f32_layers": n}


def phase_llava():
    """llava-next-mistral-7b at full width serves phase 12's (token-only)
    traffic on K3, then the patch-prefixed prefill and decode."""
    return _serve_k3("llava-next-mistral-7b", 30, after=_llava_prefix)


def phase_train_slice12():
    """Phase 31: whisper-medium at full depth, llava-next-mistral-7b at
    LLAVA_TRAIN_LAYERS of its layers and qwen3-moe-30b-a3b at
    QWEN3_TRAIN_LAYERS of its layers train through train_loop as phase 18
    does (frames and patches as train_loop's frontend prefix makes them);
    each run's last recorded K3 backward held against
    flash_backward_plain; then the three reduced configs trained on the
    card and on the CPU from one numpy-made state, as phase 20."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as K3
    out = {}
    runs = (("whisper-medium", None),
            ("llava-next-mistral-7b", LLAVA_TRAIN_LAYERS),
            ("qwen3-moe-30b-a3b", QWEN3_TRAIN_LAYERS))
    for arch, layers_ in runs:
        full = configs.get(arch)
        cfg = full if layers_ is None else \
            dataclasses.replace(full, n_layers=layers_)
        attn = cfg.n_enc_layers + 2 * cfg.n_layers if cfg.enc_dec else \
            cfg.n_layers
        n = attn * cfg.accum_steps          # K3 forward passes a step
        run = _train_full(arch, K3, "flash_backward", 2 * n, n, 31, cfg=cfg)
        args, kw = _detached(run.pop("last"))
        before = (K3.launches, K3.bwd_launches)
        err = _hold_k3_bwd(args, kw, f"{arch}, last step's last backward")
        K3.launches, K3.bwd_launches = before
        print(f"    K3 backward == plain ({K3_BWD_PARITY}) on the last "
              f"recorded q/k/v/o/lse/dO {tuple(args[0].shape)} over "
              f"{tuple(args[1].shape)}, {args[0].dtype}: max |diff| "
              f"{err:.3g}", flush=True)
        del args, kw
        torch.cuda.empty_cache()
        out[arch] = dict(run, k3_err=err, layers=cfg.n_layers)
    phase_train_card_vs_cpu(tuple(a for a, _ in runs), 31)
    return out


# ---------------------------------------------------------------------------
# Slice 13: K3 at hd 256 and at q/k 192 with v 128; recurrentgemma-9b
# (RG-LRU) and deepseek-v3-671b (MLA, multi-token prediction)
# ---------------------------------------------------------------------------
def phase_k3_widths(rng):
    """Phase 32, checks: K3's forward and backward against their plain
    versions at hd 256 and at (hd 192, hd_v 128) (K3_WIDTH_CASES: G 1 and
    8, MQA, at 256; G 1 at 192/128, MLA's): causal, causal with window 64,
    non-causal, non-causal with k_len S/2 + 1; S in K3_WIDTH_SWEEP_S;
    forward f32, bf16 on exact and on normal scores (K3_PARITY), backward
    f32 and bf16
    (K3_BWD_PARITY, lse within 2e-5, 0xFF blocks, a second call bit-equal);
    the backward on rows with one live key at hd 256 (_k3_one_live_key);
    then pairs K3 is not built for raise and launch nothing."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    t0 = time.perf_counter()
    before = (K3.launches, K3.bwd_launches)
    errs = {}
    kinds = ((torch.float32, False), (torch.bfloat16, True),
             (torch.bfloat16, False))
    nf = nb = 0
    for (hd, hd_v, G), (causal, window, kl), S in itertools.product(
            K3_WIDTH_CASES, ((True, None, None), (True, 64, None),
                             (False, None, None), (False, None, "half")),
            K3_WIDTH_SWEEP_S):
        mask = dict(causal=causal, window=window,
                    k_len=None if kl is None else S // 2 + 1)
        e = errs.setdefault((hd, hd_v), {"fwd": 0.0, "share": 0.0,
                                         "bwd": 0.0, "lse": 0.0})
        for dtype, exact in kinds:
            q, k, v = _k3_inputs(rng, 2, S, S, 8, 8 // G, hd, dtype, exact,
                                 hd_v)
            what = (f"hd {hd}, hd_v {hd_v}, {mask}, G {G}, S {S}, {dtype}, "
                    f"{'exact' if exact else 'normal'} scores")
            err, sh, _ = _k3_hold(q, k, v, what, exact, **mask)
            e["fwd"], e["share"] = max(e["fwd"], err), max(e["share"], sh)
            nf += 1
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _k3_inputs(rng, 2, S, S, 8, 8 // G, hd, dtype,
                                 hd_v=hd_v)
            err, le = _k3_bwd_case(rng, q, k, v, mask, f"hd {hd}, hd_v "
                                   f"{hd_v}, {mask}, G {G}, S {S}, {dtype}")
            e["bwd"], e["lse"] = max(e["bwd"], err), max(e["lse"], le)
            nb += 1
    one_key = _k3_one_live_key()
    counts = (K3.launches, K3.bwd_launches)
    for hd, hd_v in ((32, 16), (256, 128), (128, 192)):
        q = torch.zeros((1, 64, 2, hd), device=DEVICE)
        v = torch.zeros((1, 64, 2, hd_v), device=DEVICE)
        lse = torch.zeros((1, 64, 2), device=DEVICE)
        for call in (lambda: K3.flash_fill(q, q, v, causal=True),
                     lambda: K3.flash_backward(q, q, v, v, lse, v,
                                               causal=True)):
            try:
                call()
            except ValueError as e:
                check(str(K3.WIDTH_PAIRS) in str(e), f"({hd}, {hd_v}) raised "
                      f"without naming the pairs K3 takes: {e}")
            else:
                check(False, f"K3 took ({hd}, {hd_v}) on the card")
    check((K3.launches, K3.bwd_launches) == counts,
          "a refused width pair launched K3")
    K3.launches, K3.bwd_launches = before
    text = "; ".join(
        f"({hd}, {hd_v}): forward max |diff| {e['fwd']:.3g} (largest share "
        f"beyond 2e-5 plus one ulp {e['share']:.3g}), backward {e['bwd']:.3g}"
        f", lse {e['lse']:.3g}" for (hd, hd_v), e in errs.items())
    print(f"[32] K3 at the new widths == plain: forward on {nf} cases "
          f"({K3_PARITY}), backward and lse on {nb} cases ({K3_BWD_PARITY}; "
          f"0xFF blocks, a second call bit-equal); (hd, hd_v, G) in "
          f"{K3_WIDTH_CASES} x causal / window 64 / non-causal / k_len "
          f"S/2 + 1 x S {K3_WIDTH_SWEEP_S}: {text}; one live key (S 1, "
          f"k_len 1, hd 256, {K3_ONE_KEY_DRAWS} draws a type): backward max "
          f"|diff| f32 {one_key[torch.float32]:.3g}, bf16 "
          f"{one_key[torch.bfloat16]:.3g}; (32, 16), (256, 128) and "
          f"(128, 192) raise naming the pairs K3 is built for, nothing "
          f"launched; {time.perf_counter() - t0:.1f} s", flush=True)
    return errs


def _k3_one_live_key():
    """K3's backward against the plain version on rows with one live key:
    (B 2, S 1, G 1, hd = hd_v = 256), non-causal, k_len 1, over
    K3_ONE_KEY_DRAWS draws of q, k, v and dO a type, the draws of the gpu
    test of that name (p = 1 and O = v, so dq and dk are the rounding noise
    of ds = p (dO v - rowsum(dO O)) scale; K3_BWD_PARITY).  Returns the
    largest |difference| by type."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attn import kernel as K3
    kw = dict(causal=False, window=None, k_len=1)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(K3_ONE_KEY_SEED)
        gen = torch.Generator(device=DEVICE).manual_seed(K3_ONE_KEY_SEED)
        worst[dtype] = 0.0
        for draw in range(K3_ONE_KEY_DRAWS):
            q, k, v = (torch.as_tensor(rng.normal(size=(2, 1, 4, 256))
                                       .astype(np.float32), device=DEVICE)
                       .to(dtype) for _ in range(3))
            out, lse = K3.flash_fill(q, k, v, p_dtype=dtype, return_lse=True,
                                     **kw)
            do = torch.randn(out.shape, generator=gen, device=DEVICE,
                             dtype=dtype)
            err = _hold_k3_bwd((q, k, v, out, lse, do), kw,
                               f"one live key, hd 256, {dtype}, draw {draw}")
            worst[dtype] = max(worst[dtype], err)
    return worst


def phase_timing_k3_slice13():
    """Phase 32, times: K3's bf16 forward and backward alone at
    recurrentgemma-9b's local attention and at DeepSeek-V3's MLA, serving
    and training shapes, each in turns with SDPA where one of its fused
    backends takes the shape (``_sdpa_yardstick``), beside the card's name
    and power limit."""
    from repro_torch.kernels.flash_attn import kernel as K3
    before = (K3.launches, K3.bwd_launches)
    t0 = time.perf_counter()
    print(f"[32] K3 timed at the new widths, in turns with "
          f"scaled_dot_product_attention ({nvidia_smi('name,power.limit')})",
          flush=True)
    out = {"fwd": {}, "bwd": {}}
    for key, shape, what in (
            ("hd256", K3_RG_TIMED, "recurrentgemma-9b serving"),
            ("mla", K3_MLA_TIMED, "deepseek-v3 MLA serving")):
        B, S, H, Kh, hd, hd_v, window = shape
        out["fwd"][key] = _k3_fwd_timing(B, S, S, H, Kh, hd, True, what,
                                         hd_v=hd_v, window=window)
    for key, shape, what in (
            ("hd256", K3_RG_TRAIN, "recurrentgemma-9b training"),
            ("mla", K3_MLA_TRAIN, "deepseek-v3 MLA training")):
        B, S, H, Kh, hd, hd_v, window = shape
        out["bwd"][key] = _k3_bwd_timing(B, S, S, H, Kh, hd, True, what,
                                         hd_v=hd_v, window=window)
    K3.launches, K3.bwd_launches = before
    print(f"     {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_recurrentgemma():
    """Phase 33: recurrentgemma-9b at full width and depth (38 layers: 12
    periods of RG-LRU, RG-LRU, local attention and 2 RG-LRU layers) serves
    RG_REQUESTS prompts of RG_PROMPT_LENS tokens on SERVE_SLOTS slots of
    RG_MAX_LEN through ServeSession: K3 at hd 256, 16 query heads over one
    key/value head, window 2048, once an attention layer (12) a prefill;
    the RG-LRU's doubling scan in prefill and its f32 state and conv
    history in decode; K3 held on the first attention sublayer; the logits
    held to ``forward`` (f32 on as many periods as fit)."""
    from repro_torch import configs
    cfg = configs.get("recurrentgemma-9b")
    return _serve_k3("recurrentgemma-9b", 33,
                     reqs=_serve_requests(cfg, RG_REQUESTS, RG_PROMPT_LENS),
                     max_len=RG_MAX_LEN)


def _deepseek_logits_check(cfg, params, prompt):
    """The logits check of phase 34 on the first_dense layers: an f32 copy
    of a single MoE layer (11.5 B parameters, 46 GB) does not fit beside the
    served bf16 model, so ``_decode_vs_forward`` runs on the dense MLA
    layers alone (their plan has no routing), in bf16 and in f32."""
    import dataclasses
    cut = dataclasses.replace(cfg, n_layers=cfg.first_dense)
    print(f"    the logits check runs on the {cut.n_layers} first_dense "
          f"layers (MLA with a dense FFN) of {cfg.n_layers}", flush=True)
    _decode_vs_forward(cut, dict(params, groups=params["groups"][:1]),
                       prompt)
    return {"logits_check_layers": cut.n_layers}


def phase_deepseek():
    """Phase 34: deepseek-v3-671b at full width: its 3 first_dense layers
    and as many MoE layers as the card holds in bf16 with FIT_SPARE to
    spare (printed) serve phase 12's traffic through ServeSession: K3 at
    q/k 192 over v 128 once a layer a prefill, the absorbed MLA decode over
    the latent cache, the sigmoid router and the shared expert at their
    published widths; K3 held on layer 0; the capacity's drops in one
    prefill; the logits held to ``forward`` on the dense layers."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models.params import count_params
    full = configs.get("deepseek-v3-671b")
    dense = count_params(dataclasses.replace(full, n_layers=full.first_dense))
    per = count_params(dataclasses.replace(
        full, n_layers=full.first_dense + 1)) - dense
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    k = int((free - FIT_SPARE - 2 * dense) // (2 * per))
    k = max(1, min(full.n_layers - full.first_dense, k))
    cfg = dataclasses.replace(full, n_layers=full.first_dense + k)
    print(f"[34] deepseek-v3-671b: {full.first_dense} first_dense layers and "
          f"{k} MoE layers of {full.n_layers - full.first_dense} ({per:,} "
          f"parameters each, {2 * per / 1e9:.1f} GB in bf16) fit "
          f"{free / 1e9:.1f} GB free with {FIT_SPARE / 1e9:.0f} GB to spare",
          flush=True)
    return _serve_k3("deepseek-v3-671b", 34, cfg=cfg,
                     logits_check=_deepseek_logits_check,
                     after=lambda c, p, longest: _moe_drops(c, p, longest))


def phase_train_slice13():
    """Phase 35: recurrentgemma-9b at full width and RG_TRAIN_PERIODS
    periods (RG-LRU, RG-LRU, local attention), and deepseek-v3-671b's
    first DEEPSEEK_TRAIN_LAYERS MLA layers with a dense FFN and its MTP
    head, no MoE layer (one full-width MoE layer's AdamW state, 11.5 B
    parameters at 17 bytes, does not fit one card), train through
    train_loop as phase 18 does (K3 at hd 256 and at q/k 192 over v 128,
    forward and backward, counted a step); each run's last recorded K3
    backward held to flash_backward_plain; then the two reduced configs
    trained on the card and on the CPU from one numpy-made state, as phase
    20 (deepseek's at DEEPSEEK_CARD_WIDTHS)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attn import kernel as K3
    rg, ds = configs.get("recurrentgemma-9b"), configs.get("deepseek-v3-671b")
    periods, dense = RG_TRAIN_PERIODS, DEEPSEEK_TRAIN_LAYERS
    # K3 a microbatch: each attention layer's forward twice under remat
    # (recomputed in the backward) and its backward once; the MTP block
    # runs outside remat, its forward once
    runs = (("recurrentgemma-9b",
             dataclasses.replace(rg, n_layers=3 * periods), 2 * periods,
             periods),
            ("deepseek-v3-671b",
             dataclasses.replace(ds, n_layers=dense, first_dense=dense),
             2 * dense + 1, dense + 1))
    out = {}
    for arch, cfg, n_fwd, n_bwd in runs:
        a = cfg.accum_steps
        run = _train_full(arch, K3, "flash_backward", n_fwd * a, n_bwd * a,
                          35, cfg=cfg)
        args, kw = _detached(run.pop("last"))
        before = (K3.launches, K3.bwd_launches)
        err = _hold_k3_bwd(args, kw, f"{arch}, last step's last backward")
        K3.launches, K3.bwd_launches = before
        print(f"    K3 backward == plain ({K3_BWD_PARITY}) on the last "
              f"recorded q/k/v/o/lse/dO: q {tuple(args[0].shape)}, k "
              f"{tuple(args[1].shape)}, v {tuple(args[2].shape)}, "
              f"{args[0].dtype}, window {kw.get('window')}: max |diff| "
              f"{err:.3g}", flush=True)
        del args, kw
        torch.cuda.empty_cache()
        out[arch] = dict(run, k3_err=err, layers=cfg.n_layers)
    phase_train_card_vs_cpu(("recurrentgemma-9b",
                             ("deepseek-v3-671b", DEEPSEEK_CARD_WIDTHS)), 35)
    return out


def _mesh_aligner(mesh, blocks):
    """Phase M (a): phase 4's padded blocks through make_sharded_aligner
    and through align_batch, K1 counted on the sharded run alone."""
    import torch
    from repro_torch.core import batch as core_batch
    from repro_torch.core import kernels_zoo
    from repro_torch.core.spec_utils import params_on_device
    from repro_torch.kernels.wavefront import kernel as K1
    spec, params = kernels_zoo.make(2)
    params = params_on_device(params, DEVICE)
    aligner = core_batch.make_sharded_aligner(spec, mesh)
    aligner(params, *blocks[0][1:])                       # warm-up
    want = [core_batch.align_batch(spec, params, *b[1:], device=DEVICE)
            for b in blocks]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [aligner(params, *b[1:]) for b in blocks]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K1.launches
    check(launches == len(blocks), f"[M] sharded aligner launched K1 "
          f"{launches} times for {len(blocks)} blocks")
    n = 0
    for g, w in zip(got, want):
        for f in ("score", "end_i", "end_j", "moves", "n_moves"):
            check(torch.equal(getattr(g, f), getattr(w, f)),
                  f"[M] sharded aligner: {f} differs from align_batch")
        n += g.score.shape[0]
    print(f"[M] (a) make_sharded_aligner #2 over the 'data' axis, phase 4's "
          f"{n} windows in {len(blocks)} padded blocks: {wall:.3f} s wall; "
          f"K1 launches {launches}; score, end cell and moves (so the "
          f"CIGAR) bit-equal to align_batch", flush=True)
    return {"k1_launches": launches, "pairs": n, "wall_s": wall}


def _mesh_service(mesh):
    """Phase M (b): phase S's first MESH_REQUESTS requests drained by the
    service with mesh= and without, the same settings."""
    import numpy as np
    from repro_torch.core import alphabets
    from repro_torch.kernels.myers import kernel as K2
    from repro_torch.kernels.wavefront import kernel as K1
    from repro_torch.runtime import plan as plan_mod
    from repro_torch.serve import AlignRequest, AlignmentService
    rng = np.random.default_rng(SEED)
    genome = alphabets.random_dna(rng, 1_000_000)
    stream = _sv_stream(rng, genome)[:MESH_REQUESTS]

    def drain(**kw):
        svc = AlignmentService(max_len=SV_MAX_LEN, block=SV_BLOCK,
                               prefilter=SV_PREFILTER, device=DEVICE, **kw)
        reqs = [AlignRequest(rid=rid, kernel=k, query=q, ref=r)
                for rid, k, q, r, _ in stream]
        for r in reqs:
            svc.submit(r)
        t0 = time.perf_counter()
        svc.drain()
        return [r.result for r in reqs], time.perf_counter() - t0

    plain, plain_s = drain()
    plan_mod.clear_plan_cache(keep_stats=True)
    _reset_counts()
    sharded, wall = drain(mesh=mesh)
    k1, k2 = K1.launches, K2.launches
    placements = sorted({k.placement for k in
                         plan_mod.plan_cache_info()["keys"]} - {None})
    check(k1 > 0, "[M] the sharded service did not launch K1")
    check(sharded == plain, "[M] the sharded service's results differ from "
          "the unsharded service's")
    check(placements == ["data@data=1xmodel=1"],
          f"[M] sharded service placements {placements}")
    print(f"[M] (b) AlignmentService(mesh=) drained phase S's first "
          f"{len(stream)} requests in {wall:.3f} s (unsharded "
          f"{plain_s:.3f} s): results equal, placement {placements[0]}, "
          f"K1 launches {k1}, K2 (prefilter) {k2}", flush=True)
    return {"k1_launches": k1, "k2_launches": k2, "wall_s": wall,
            "plain_s": plain_s, "placements": placements}


def _mesh_train(mesh, olmo_train):
    """Phase M (c) and (d): olmo-1b at full width through
    train_loop(mesh=) under TRAIN_RULES, phase 18's first MESH_STEPS steps
    (the same seed, schedule and batches: the warm-up's learning rate does
    not depend on the step count), K3 counted a step; then its parameters
    and step saved from the mesh and restored with no mesh."""
    import statistics as st
    import tempfile
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import checkpoint, configs
    from repro_torch.kernels.flash_attn import kernel as K3
    from repro_torch.launch.train import train_loop
    from repro_torch.models.params import leaves
    cfg = configs.get("olmo-1b")
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, counts, losses = [time.perf_counter()], [], []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        stamps.append(time.perf_counter())
        counts.append((K3.launches, K3.bwd_launches))

    state, _ = train_loop(cfg, steps=MESH_STEPS, batch=TRAIN_BATCH,
                          seq=TRAIN_SEQ, log_every=1, device=DEVICE,
                          mesh=mesh, on_metrics=on_metrics)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    want = olmo_train["losses"][:MESH_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    check(len(losses) == MESH_STEPS and rel <= MESH_LOSS_RTOL,
          f"[M] sharded losses {losses} vs phase 18's {want}: rel {rel:.3g}")
    per_step = [(b[0] - a[0], b[1] - a[1])
                for a, b in zip([(0, 0)] + counts, counts)]
    check(all(c == (2 * 16, 16) for c in per_step),
          f"[M] K3 launches per sharded step {per_step}, phase 18 (32, 16)")
    flat = leaves(state)
    check(all(isinstance(t, DTensor) for t in flat),
          "[M] a state leaf is not a DTensor")
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = st.median(steps[1:])
    print(f"[M] (c) olmo-1b at full width through train_loop(mesh=) under "
          f"TRAIN_RULES: losses {', '.join(f'{x:.6f}' for x in losses)} "
          f"(phase 18: {', '.join(f'{x:.6f}' for x in want)}; max rel "
          f"{rel:.3g}); K3 launches a step {per_step[0]} as phase 18's; "
          f"step time median {step_s:.3f} s over steps 2-{MESH_STEPS} "
          f"(phase 18: {olmo_train['step_s']:.3f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB (phase 18: "
          f"{olmo_train['peak_bytes'] / 2**30:.2f} GiB)", flush=True)

    tmp = tempfile.mkdtemp(prefix="mesh_ckpt_")
    try:
        part = {"params": state["params"], "step": state["step"]}
        t0 = time.perf_counter()
        checkpoint.save(tmp, MESH_STEPS, part)
        back, at = checkpoint.restore_latest(tmp, part)
        ck_s = time.perf_counter() - t0
        same = at == MESH_STEPS and all(
            not isinstance(b, DTensor) and torch.equal(b, a.to_local())
            for a, b in zip(leaves(part), leaves(back)))
        nbytes = sum(b.numel() * b.element_size() for b in leaves(back))
        check(same, "[M] the checkpoint restored with no mesh differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state, back, part
    torch.cuda.empty_cache()
    print(f"[M] (d) parameters and step ({nbytes / 2**30:.2f} GiB) saved "
          f"from the mesh and restored with mesh=None: bit-equal "
          f"({ck_s:.1f} s)", flush=True)
    return {"losses": losses, "loss_rel": rel, "step_s": step_s,
            "steps_s": steps, "peak_bytes": peak,
            "fwd_launches": counts[-1][0], "bwd_launches": counts[-1][1],
            "ckpt_s": ck_s, "ckpt_bytes": nbytes,
            "phase18_step_s": olmo_train["step_s"],
            "phase18_peak_bytes": olmo_train["peak_bytes"]}


def phase_mesh(blocks, olmo_train):
    """Phase M: the placement path (ROADMAP item 14) on the card, a
    process group of one rank over NCCL and make_host_mesh()'s (1, 1)
    data x model mesh: (a) the sharded aligner, (b) the sharded service,
    (c) sharded training and (d) a checkpoint from the mesh restored with
    no mesh; the group is destroyed at the end."""
    import datetime
    import os
    import tempfile
    import torch.distributed as dist
    import logging
    from repro_torch.launch.mesh import make_host_mesh
    # DTensor warns of two all-reduces for (Partial, Partial) on every
    # step; on one rank they are no-ops
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="mesh_store_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh()
        check(tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names
              == ("data", "model"), f"[M] host mesh {mesh}")
        print(f"[M] the placement path: {dist.get_backend()}, one rank, "
              f"make_host_mesh() "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}",
              flush=True)
        out = {"aligner": _mesh_aligner(mesh, blocks),
               "service": _mesh_service(mesh),
               "train": _mesh_train(mesh, olmo_train)}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[M] phase M took {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase D: the dry run and the roofline (ROADMAP item 15g)
# ---------------------------------------------------------------------------
# the one-rank dry run of a training cell of phases 18-19, printed as JSON
DRY_ONE_RANK = r"""
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.optim import AdamWConfig
arch, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dryrun.init_fake_group(1)
shape = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=seq,
                            global_batch=batch)
rec = dryrun.run_cell(arch, "train_4k", False, mesh=dryrun.small_mesh(1),
                      shape=shape, opt_cfg=AdamWConfig(weight_decay=0.01),
                      verbose=False)
print(json.dumps(rec))
"""
# production cells phase D runs through the dry run's command line
DRY_CELLS = (("olmo-1b", "train_4k"), ("deepseek-v3-671b", "decode_32k"))
DRY_PEAK_TOL = 0.10
DRY_TIMEOUT = 420


def _dry_processes():
    """Start every dry run of phase D at once, each a process of its own
    (a fake process group is global to its process): the one-rank cells
    of phases 18 and 19 and the production cells of DRY_CELLS (records
    under build/dryrun/).  Returns {key: (Popen, output path or None)}."""
    import os
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for arch in ("olmo-1b", "rwkv6-3b"):
        procs[arch] = (subprocess.Popen(
            [sys.executable, "-c", DRY_ONE_RANK, arch, str(TRAIN_BATCH),
             str(TRAIN_SEQ)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), None)
    for arch, shape in DRY_CELLS:
        path = out_dir / f"dryrun_{_slug(arch)}_{shape}.jsonl"
        path.unlink(missing_ok=True)
        procs[(arch, shape)] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(path)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), path)
    return procs


def _dry_wait(procs, t_end):
    """Each process's (returncode, last stdout line, stderr tail, record
    of its output file); a process past ``t_end`` is killed."""
    import json
    import subprocess
    got = {}
    for key, (proc, path) in procs.items():
        try:
            out, err = proc.communicate(
                timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        rec = None
        if path is not None and path.exists() and path.read_text().strip():
            rec = json.loads(path.read_text().splitlines()[-1])
        elif proc.returncode == 0 and out.strip():
            rec = json.loads(out.strip().splitlines()[-1])
        got[key] = (proc.returncode, rec, err[-1500:])
    return got


def _card_vs_dry(arch, run, dry, kernel, calls, card):
    """Phase D (a)/(b): the card's count of one more step of phase 18/19
    against the one-rank dry run of the same cell; the roofline of that
    count (a prediction) beside the run's measured step time and peak."""
    from repro_torch import configs
    from repro_torch.launch import roofline
    cost = run["cost"]
    tag = "a" if kernel == "flash" else "b"
    rc, rec, err = dry
    check(rc == 0 and rec is not None and rec["status"] == "ok",
          f"[D{tag}] the dry run of {arch} failed (rc {rc}): "
          f"{(rec or {}).get('error')} {err}")
    hc = rec["hlo_cost"]
    card_fl = {k: float(v) for k, v in cost.flops_by_dtype.items()}
    names = (f"{kernel}_fill", f"{kernel}_backward")
    card_calls = tuple(cost.kernel_calls(n) for n in names)
    dry_calls = tuple(hc["kernels"].get(n, {}).get("calls", 0)
                      for n in names)
    check(card_fl == {k: float(v) for k, v in hc["flops_by_dtype"].items()},
          f"[D{tag}] {arch}: FLOPs by dtype on the card {card_fl}, in the "
          f"dry run {hc['flops_by_dtype']}")
    check(card_calls == dry_calls == calls,
          f"[D{tag}] {arch}: kernel calls on the card {card_calls}, in the "
          f"dry run {dry_calls}, phase {18 if tag == 'a' else 19} {calls}")
    cfg = configs.get(arch)
    shape = configs.ShapeSpec("train_2k", TRAIN_SEQ, TRAIN_BATCH, "train")
    rl = roofline.from_record({"mesh": "1x1", "n_devices": 1,
                               "hlo_cost": cost.as_dict()}, cfg, shape)
    useful = rl.model_flops
    step_s, measured = run["step_s"], run["peak_bytes"]
    predicted = rec["memory"]["peak_per_device"]
    off = predicted / measured - 1
    print(f"[D{tag}] {arch}, phase {18 if tag == 'a' else 19}'s training "
          f"cell ({TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat) counted by "
          f"launch/hlo_cost.py on the card (one more step after the timed "
          f"ones) and by the one-rank dry run (fake tensors, trace "
          f"{rec['trace_s']} s): FLOPs by dtype "
          + ", ".join(f"{k} {v:.4e}" for k, v in sorted(card_fl.items()))
          + f" (equal); elementwise {cost.ewise_flops:.4e}; bytes "
          f"{cost.bytes:.4e} (dry run {hc['bytes_per_device']:.4e}); "
          f"collectives {len(cost.collectives)}; {names[0]} / {names[1]} "
          f"calls {card_calls} (equal, phase "
          f"{18 if tag == 'a' else 19}: {calls})", flush=True)
    print(f"    model_flops + attn_flops {useful:.4e}; roofline terms "
          f"(predictions from counts and H100 SXM data-sheet peaks): "
          f"compute {rl.compute_s:.4f} s, memory {rl.memory_s:.4f} s, "
          f"collective {rl.collective_s:.4f} s; bound {rl.bound_s:.4f} s "
          f"by {rl.dominant}; measured step {step_s:.4f} s: roofline share "
          f"(bound / step) {rl.bound_s / step_s:.3f}, MFU "
          f"((model_flops + attn_flops) / (step x 989e12)) "
          f"{useful / (step_s * roofline.PEAK_BF16):.4f}", flush=True)
    print(f"    peak: predicted by the dry run {predicted / 2**30:.2f} GiB, "
          f"measured (max_memory_allocated, phase "
          f"{18 if tag == 'a' else 19}) {measured / 2**30:.2f} GiB: "
          f"{100 * off:+.1f} % ({card['smi']})", flush=True)
    check(abs(off) <= DRY_PEAK_TOL,
          f"[D{tag}] {arch}: the dry run's peak {predicted} is "
          f"{100 * off:+.1f} % off the measured {measured}")
    return {"flops_by_dtype": card_fl, "bytes": cost.bytes,
            "calls": list(card_calls), "model_flops": useful,
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "bound_s": rl.bound_s,
            "dominant": rl.dominant, "step_s": step_s,
            "roofline_share": rl.bound_s / step_s,
            "mfu": useful / (step_s * roofline.PEAK_BF16),
            "peak_predicted": predicted, "peak_measured": measured}


def phase_dryrun(procs, t_start, olmo_train, rwkv_train, card):
    """Phase D: the dry run and the roofline.  (a) olmo-1b's and (b)
    rwkv6-3b's training cells of phases 18-19: the card's count of one
    more step equals the one-rank dry run's in FLOPs by dtype and kernel
    calls, and the dry run's peak is within DRY_PEAK_TOL of the measured
    one; the roofline's terms, the step's roofline share and its MFU.
    (c) DRY_CELLS on the production mesh (256 fake ranks) through
    ``python -m repro_torch.launch.dryrun``.  Every dry run is a process of
    its own (``procs``, from ``_dry_processes``), all started together at
    ``t_start``, before phase M, which they need nothing of."""
    t0 = time.perf_counter()
    got = _dry_wait(procs, t_start + DRY_TIMEOUT)
    out = {"olmo": _card_vs_dry("olmo-1b", olmo_train, got["olmo-1b"],
                                "flash", (2 * 16, 16), card),
           "rwkv": _card_vs_dry("rwkv6-3b", rwkv_train, got["rwkv6-3b"],
                                "wkv6", (2 * 32, 32), card),
           "cells": {}}
    for arch, shape in DRY_CELLS:
        rc, rec, err = got[(arch, shape)]
        check(rc == 0 and rec is not None and rec["status"] == "ok",
              f"[Dc] the dry run of {arch} {shape} failed (rc {rc}): "
              f"{(rec or {}).get('error')} {err}")
        rl = rec["roofline"]
        print(f"[Dc] dry run {arch} {shape} on {rec['mesh']} "
              f"({rec['n_devices']} fake ranks): {rec['status']}, trace "
              f"{rec['trace_s']} s; peak per card "
              f"{rec['memory']['peak_per_device'] / 2**30:.2f} GiB, fits "
              f"{rec['fits']}; FLOPs per card "
              f"{rec['hlo_cost']['flops_per_device']:.4e}; dominant term "
              f"{rl['dominant']} (compute {rl['compute_s']:.4g} s, memory "
              f"{rl['memory_s']:.4g} s, collective {rl['collective_s']:.4g}"
              f" s; predictions)", flush=True)
        out["cells"][f"{arch}:{shape}"] = {
            "peak_per_device": rec["memory"]["peak_per_device"],
            "fits": rec["fits"], "dominant": rl["dominant"],
            "bound_s": rl["bound_s"], "trace_s": rec["trace_s"]}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[D] phase D took {out['phase_s']:.1f} s after phase M (its dry "
          f"runs {time.perf_counter() - t_start:.1f} s from their start)",
          flush=True)
    return out


def _slug(arch):
    return arch.split("-")[0]


def _train_summary(run, kern):
    """A training phase's numbers for the kernels' JSON line (the kernel's
    own times where the phase took them)."""
    return {"step_s": run["step_s"], "tokens_per_s": run["tokens_per_s"],
            "device_busy_share": run["profile_busy"],
            "peak_gib": run["peak_bytes"] / 2**30, "losses": run["losses"],
            "kernel_share": run.get(f"{kern}_share"),
            "fwd_ms": run.get(f"{kern}_fwd_ms"),
            "bwd_ms": run.get(f"{kern}_bwd_ms")}


def _timed(phase, *args):
    """``phase(*args)``, its seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


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
    from repro_torch.kernels.flash_attn.kernel import HEAD_DIMS as K3_HEAD_DIMS
    from repro_torch.kernels.flash_attn.kernel import \
        VALUE_WIDTHS as K3_VALUE_WIDTHS
    # every f32 comparison on the card runs in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    dry_procs = {}
    try:
        card = _timed(phase_identity)
        _timed(phase_build)
        ptxas = _timed(entry_ptxas)
        rng = np.random.default_rng(SEED)
        max_err = _timed(phase_kernel_vs_plain, rng)
        ext_err = _timed(phase_ext_vs_plain, rng)
        gen = _timed(phase_generated, card)
        genome = alphabets.random_dna(rng, 1_000_000)
        launches, blocks = _timed(phase_main_path, rng, genome)
        long_blocks = _timed(phase_long_reads, rng, genome)
        timing = _timed(phase_path_shapes, blocks, long_blocks, card)
        tuned = _timed(phase_tune, card)
        xdrop = _timed(phase_xdrop, genome)
        k2_err = _timed(phase_k2_vs_plain, rng)
        mapper = _timed(phase_mapper, card)
        k2_timing = _timed(phase_k2_timing, mapper["screen"], card)
        geno = _timed(phase_genotyping, card)
        _timed(phase_posterior, geno["sites"])
        service = _timed(phase_service, geno, mapper)
        del mapper["mapper"], mapper["reads"], geno["sites"]
        k3_err = _timed(phase_k3_vs_plain, rng)
        k4_err = _timed(phase_k4_vs_plain, rng)
        olmo = _timed(phase_olmo)
        rwkv = _timed(phase_rwkv)
        _timed(phase_card_vs_cpu)
        k3_timing, k4_timing = _timed(phase_timing_k3_k4)
        k3b_timing, k4b_timing = _timed(timing_backward)
        k3b_err = _timed(phase_k3_bwd_vs_plain, rng)
        k4b_err = _timed(phase_k4_bwd_vs_plain, rng)
        olmo_train = _timed(phase_train_olmo)
        rwkv_train = _timed(phase_train_rwkv)
        _timed(phase_train_card_vs_cpu)
        k3_160_err, k3b_160_err = _timed(phase_k3_hd160, rng)
        k3_x_err, k3b_x_err = _timed(phase_k3_cross, rng)
        k3_new = _timed(phase_timing_k3_slice11)
        stablelm = _timed(phase_stablelm)
        dense = _timed(phase_phi3_command_r)
        stablelm_train = _timed(phase_train_stablelm)
        align = _timed(phase_align_launcher)
        qwen3 = _timed(phase_qwen3_moe)
        whisper = _timed(phase_whisper)
        llava = _timed(phase_llava)
        train12 = _timed(phase_train_slice12)
        k3w_err = _timed(phase_k3_widths, rng)
        k3_13 = _timed(phase_timing_k3_slice13)
        rgemma = _timed(phase_recurrentgemma)
        deepseek = _timed(phase_deepseek)
        train13 = _timed(phase_train_slice13)
        dry_procs, dry_start = _dry_processes(), time.perf_counter()
        mesh = _timed(phase_mesh, blocks, olmo_train)
        dry = _timed(phase_dryrun, dry_procs, dry_start, olmo_train,
                     rwkv_train, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:                 # no dry run outlives the script
        for proc, _ in dry_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    kernels = [{
        "name": "wavefront_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/wavefront/csrc/wavefront.cu",
        "replaces": "src/repro/kernels/wavefront/kernel.py:198",
        "launches": launches, "launches_mapper": mapper["k1_launches"],
        "launches_service": service["k1_launches"],
        "launches_tune": tuned["launches"],
        "launches_serve_alignments": align["k1_launches"],
        "launches_sharded_aligner": mesh["aligner"]["k1_launches"],
        "launches_sharded_service": mesh["service"]["k1_launches"],
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
        "generated": {
            "source": "src/repro_torch/kernels/wavefront/synth.py",
            "parity": "integers bit-equal to the plain version and to the "
                      "hand-written twins; float best within rtol 1e-5 "
                      "(max) / 2e-5 (logsumexp)", **gen},
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
        "launches_sharded_service": mesh["service"]["k2_launches"],
        "max_abs_err": max(k2_err, mapper["k2_err"], service["k2_err"]),
        **k2_timing, "library_ms": None}, {
        "name": "flash_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:95",
        "launches": olmo["k3_launches"],
        "launches_train": olmo_train["fwd_launches"],
        "calls_counted_phase_d": dry["olmo"]["calls"][0],
        "launches_train_sharded": mesh["train"]["fwd_launches"],
        "launches_stablelm": stablelm["k3_launches"],
        "launches_phi3": dense["phi3"]["k3_launches"],
        "launches_command_r": dense["command_r"]["k3_launches"],
        "command_r_layers": dense["command_r"]["layers"],
        "launches_train_stablelm": stablelm_train["fwd_launches"],
        "launches_qwen3_moe": qwen3["k3_launches"],
        "launches_whisper_prefills": whisper["k3_launches"],
        "launches_whisper_per_prefill": whisper["k3_per_prefill"],
        "launches_llava": llava["k3_launches"],
        "launches_llava_prefix_prefill": llava["prefix_k3_launches"],
        **{f"launches_train_{_slug(a)}": r["fwd_launches"]
           for a, r in train12.items()},
        "launches_recurrentgemma": rgemma["k3_launches"],
        "launches_deepseek": deepseek["k3_launches"],
        "deepseek_layers": deepseek["layers"],
        **{f"launches_train_{_slug(a)}": r["fwd_launches"]
           for a, r in train13.items()},
        "head_dims": list(K3_HEAD_DIMS),
        "value_widths": [list(p) for p in K3_VALUE_WIDTHS],
        "parity": K3_PARITY,
        "max_abs_err": max(k3_err, olmo["k3_err"], stablelm["k3_err"],
                           dense["phi3"]["k3_err"],
                           dense["command_r"]["k3_err"], qwen3["k3_err"],
                           whisper["k3_err"], llava["k3_err"],
                           llava["prefix_k3_err"], rgemma["k3_err"],
                           deepseek["k3_err"],
                           *(e["fwd"] for e in k3w_err.values())),
        "max_abs_err_hd160": k3_160_err, "max_abs_err_cross": k3_x_err,
        "max_abs_err_hd256": max(k3w_err[(256, 256)]["fwd"],
                                 rgemma["k3_err"]),
        "max_abs_err_qk192_v128": max(k3w_err[(192, 128)]["fwd"],
                                      deepseek["k3_err"]),
        "recurrentgemma_serve": rgemma["serve"],
        "deepseek_serve": dict(deepseek["serve"], layers=deepseek["layers"],
                               **{k: deepseek[k] for k in (
                                   "drop_choices", "choices",
                                   "logits_check_layers")}),
        "slice13": k3_13["fwd"],
        "stablelm_serve": stablelm["serve"], "ptxas": ptxas["flash_fill"],
        "qwen3_moe_serve": dict(qwen3["serve"], **{k: qwen3[k] for k in (
            "drop_tokens_per_layer", "drop_choices", "choices",
            "f32_layers", "skipped_positions", "nodrop_f32_err")}),
        "whisper": {k: whisper[k] for k in (
            "prefill_s", "decode_step_ms", "k3_prefill_s", "peak_gib")},
        "llava_serve": dict(llava["serve"], **{k: llava[k] for k in (
            "prefix_prefill_s", "prefix_decode_step_ms",
            "prefix_f32_layers")}),
        **k3_new["fwd"],
        **k3_timing}, {
        "name": "wkv6_fill", "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:80",
        "launches": rwkv["k4_launches"],
        "launches_train": rwkv_train["fwd_launches"], "parity": "5e-4",
        "calls_counted_phase_d": dry["rwkv"]["calls"][0],
        "max_abs_err": max(k4_err, rwkv["k4_err"]), **k4_timing}, {
        "name": "flash_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu",
        "replaces": "src/repro/models/layers.py:163",
        "launches": olmo_train["bwd_launches"], "parity": K3_BWD_PARITY,
        "calls_counted_phase_d": dry["olmo"]["calls"][1],
        "dry_run": {k: v for k, v in dry["olmo"].items() if k != "calls"},
        "launches_train_sharded": mesh["train"]["bwd_launches"],
        "train_sharded": {k: mesh["train"][k] for k in (
            "losses", "loss_rel", "step_s", "peak_bytes", "phase18_step_s",
            "phase18_peak_bytes", "ckpt_s")},
        "launches_train_stablelm": stablelm_train["bwd_launches"],
        **{f"launches_train_{_slug(a)}": r["bwd_launches"]
           for a, r in train12.items()},
        **{f"launches_train_{_slug(a)}": r["bwd_launches"]
           for a, r in train13.items()},
        "head_dims": list(K3_HEAD_DIMS),
        "value_widths": [list(p) for p in K3_VALUE_WIDTHS],
        "max_abs_err": max(k3b_err, olmo_train["k3_err"],
                           stablelm_train["k3_err"],
                           *(r["k3_err"] for r in train12.values()),
                           *(r["k3_err"] for r in train13.values()),
                           *(e["bwd"] for e in k3w_err.values())),
        "max_abs_err_hd160": k3b_160_err, "max_abs_err_cross": k3b_x_err,
        "max_abs_err_hd256": max(k3w_err[(256, 256)]["bwd"],
                                 train13["recurrentgemma-9b"]["k3_err"]),
        "max_abs_err_qk192_v128": max(k3w_err[(192, 128)]["bwd"],
                                      train13["deepseek-v3-671b"]["k3_err"]),
        "slice13": k3_13["bwd"],
        "train": _train_summary(olmo_train, "k3"),
        "train_stablelm": dict(_train_summary(stablelm_train, "k3"),
                               layers=stablelm_train["layers"]),
        **{f"train_{_slug(a)}": dict(_train_summary(r, "k3"),
                                     layers=r["layers"], moe_aux=r["moe_aux"])
           for a, r in (*train12.items(), *train13.items())},
        **k3_new["bwd"],
        "ptxas": ptxas["flash_backward"], **k3b_timing}, {
        "name": "wkv6_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/models/mixers.py:411",
        "launches": rwkv_train["bwd_launches"], "parity": K4_BWD_PARITY,
        "calls_counted_phase_d": dry["rwkv"]["calls"][1],
        "dry_run": {k: v for k, v in dry["rwkv"].items() if k != "calls"},
        "dry_run_cells": dry["cells"],
        "max_abs_err": max(k4b_err, rwkv_train["k4_err"]),
        "train": _train_summary(rwkv_train, "k4"),
        "ptxas": ptxas["wkv6_backward"], **k4b_timing}]
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
